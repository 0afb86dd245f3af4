"""The numbers that decide ``correct``, and the judgement against their
limits.

Training (``train_numbers``): the largest relative gap of a step's loss;
and, by the worst leaf, the gap between the program's and the reference's
norm of the first step's gradient and of the parameters' change over the
checked steps, over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both (a gradient that is
nought to rounding moves under Adam by round-off alone).

Serving (``serve_numbers``): the served ids that break a guarantee (out of
range, repeated in a row, or an item the user is excluded from) are
counted; of the rest, the widest gap by which a served item's reference
score lies below the reference's k-th best, over the spread (standard
deviation) of that user's reference scores.
"""

from __future__ import annotations

import math
import statistics

import torch

LEAF_RULE = 1e-3


def _norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in
            leaves.items()}


def leaf_gap(prog: dict, ref: dict, counted) -> float:
    """max over ``counted`` leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, the
    median leaf's ‖ref‖)."""
    pn, rn = _norms({n: prog[n] for n in counted}), _norms(
        {n: ref[n] for n in counted})
    med = statistics.median(rn.values())
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in counted)


def counted_leaves(ref_grad1: dict) -> list:
    norms = _norms(ref_grad1)
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= LEAF_RULE * med]


def train_numbers(prog_losses, prog_grad1: dict, prog_change: dict,
                  ref) -> dict:
    """``ref`` is a ``gcn.Steps``; the program's side is given leaf by
    leaf."""
    counted = counted_leaves(ref.grad1)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog_losses, ref.losses))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog_grad1, ref.grad1, counted),
            "change_gap": leaf_gap(prog_change, ref.change, counted)}


@torch.no_grad()
def serve_numbers(users_rep, items_rep, excluded_of, requests,
                  k: int, block: int = 2048) -> dict:
    """``requests``: (user ids (n,), served ids (n, k)) int64 pairs;
    ``excluded_of(user_ids) -> (n, n_items) bool`` on the reps' device."""
    n_items = items_rep.shape[0]
    dev = users_rep.device
    bad, gap = 0, 0.0
    for users, served in requests:
        for lo in range(0, len(users), block):
            u = torch.as_tensor(users[lo:lo + block]).to(dev)
            ids = torch.as_tensor(served[lo:lo + block]).to(dev)
            s = users_rep[u] @ items_rep.T
            spread = s.std(dim=1)
            excl = excluded_of(u)
            kth = torch.topk(s.masked_fill(excl, float("-inf")), k,
                             dim=1).values[:, -1]
            in_range = (ids >= 0) & (ids < n_items)
            safe = ids.clamp(0, n_items - 1)
            srt = torch.sort(safe, dim=1).values
            repeated = torch.zeros_like(in_range)
            repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
            ok = in_range & ~excl.gather(1, safe)
            bad += int((~ok).sum()) + int(repeated.sum())
            served_s = s.gather(1, safe).masked_fill(~ok, float("inf"))
            g = (kth - served_s.min(dim=1).values) / spread
            gap = max(gap, float(g.max()))
    return {"bad_ids": float(bad), "score_gap": gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit and finite, and a number for every limit (one the run could not
    read is reported as null); a number missing from ``limits`` is
    refused."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r}")
        checks[name] = {"value": value, "limit": limits[name]}
        if not (math.isfinite(value) and value <= limits[name]):
            ok = False
    for name in limits.keys() - numbers.keys():
        checks[name] = {"value": None, "limit": limits[name]}
        ok = False
    return ok, checks
