"""Masked top-k requests offered at a fixed rate (an open loop), on the
INMO life-cycle.

Set-up draws the catalog from the seed, builds IGCN through the port's
entry points on ``dropui(full, ratio)`` (the first ``ratio`` of users and
items) with the benchmark's template weights, wraps it in a
``Recommender`` and refreshes it onto the full catalog: users and items it
never saw are served by the inductive templates, with no training. The
templates carry the catalog's own latent clusters and tastes
(``template_weights``), as trained ones would, so users of different
clusters get different top-k lists. Every seed offers the same ``slots``
request sizes (log-uniform between ``min_users`` and ``max_users``, at the
quantiles' midpoints), in a balanced order drawn from the seed (every run
of sqrt(slots) requests takes one from each sqrt(slots)-quantile, so no
seed piles its largest requests together), one every 1 / ``rate_rps``
seconds, with user ids drawn from the seed (uniform, with repeats); set-up
sends each size once.

The window issues requests at their due times from one thread, cycling
through the slots, until the window's end; a request due while an earlier
one runs waits for it, so above the rate the system sustains the backlog
grows all through the window. A request's latency runs from
its due time until its ids are on the host, so a stall counts against
every request it delays; how late the sender ran is logged. A reservoir
of ``checked_requests`` answers, drawn from the seed, is compared with the
reference after the window; a run that answered fewer is not correct.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from benchmark.catalog import generate
from benchmark.harness import (Outcome, activities, dataset_of, free,
                               peak_memory, ranged, sync, unrange)
from benchmark.reference import gcn
from benchmark.reference.compare import serve_numbers
from benchmark.trace import WINDOW, summarize
from benchmark.window import percentile, rate

RANGES = ("recommend",)
SPIN_S = 2e-4  # the last stretch before a due time is waited by spinning


def request_sizes(lo: int, hi: int, slots: int) -> list:
    """``slots`` sizes log-uniform in [lo, hi], at the midpoints of equal
    quantiles."""
    return [int(round(lo * (hi / lo) ** ((j + 0.5) / slots)))
            for j in range(slots)]


def balanced_order(rng, slots: int) -> list:
    """A permutation of ``slots`` ascending values in blocks of m =
    sqrt(slots): block b holds the b-th draw of each run of m consecutive
    values, in an order drawn from ``rng``."""
    m = math.isqrt(slots)
    if m * m != slots:
        raise ValueError(f"{slots} slots is not a square")
    picks = [rng.permutation(m) for _ in range(m)]
    return [int(g * m + picks[g][b]) for b in range(m)
            for g in rng.permutation(m)]


def schedule(traffic: dict, n_users: int, seed: int) -> list:
    """The slots' requests (user id arrays), in a balanced order of their
    sizes drawn from the seed."""
    rng = np.random.default_rng(seed)
    slots = traffic["slots"]
    sizes = request_sizes(traffic["min_users"], traffic["max_users"], slots)
    return [rng.integers(0, n_users, size=sizes[j], dtype=np.int64)
            for j in balanced_order(rng, slots)]


def template_weights(cat, seed: int, n_core_users: int, n_core_items: int,
                     d: int, device, std: float = 0.1) -> torch.Tensor:
    """The template table ((n_core_users + n_core_items + 2, d) f32: template
    users, template items, the user and item tokens), drawn on ``device``
    from ``seed`` in a few calls: each template is its node's cluster
    centre (unit normal), plus its taste factors as the generator drew them
    mapped into d (each of the d parts has the factors' own variance), plus
    unit normal noise, over sqrt(3) and times ``std``; the tokens are noise
    times ``std``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) + 2)
    f32 = dict(dtype=torch.float32, device=dev)
    n_clusters = int(max(cat.user_cluster.max(), cat.item_cluster.max())) + 1
    centres = torch.randn((n_clusters, d), generator=g, **f32)
    taste = cat.user_taste.shape[1]
    to_d = torch.randn((taste, d), generator=g, **f32) / math.sqrt(taste)
    rows = n_core_users + n_core_items + 2
    noise = torch.randn((rows, d), generator=g, **f32)
    cluster = torch.cat([torch.as_tensor(cat.user_cluster[:n_core_users]),
                         torch.as_tensor(cat.item_cluster[:n_core_items])])
    tastes = torch.cat([torch.as_tensor(cat.user_taste[:n_core_users]),
                        torch.as_tensor(cat.item_taste[:n_core_items])])
    signal = centres[cluster.to(dev)] + tastes.to(dev) @ to_d
    noise[: len(signal)] += signal
    noise[: len(signal)] /= math.sqrt(3.0)
    return std * noise


def excluded_lookup(cat, device):
    """``f(user ids) -> (n, n_items) bool``: every item the user has in any
    split, the 'all' exclusion the cell serves under."""
    order = np.lexsort((cat.items, cat.users))
    indptr = np.zeros(cat.n_users + 1, np.int64)
    np.cumsum(np.bincount(cat.users, minlength=cat.n_users), out=indptr[1:])
    indptr = torch.as_tensor(indptr).to(device)
    indices = torch.as_tensor(cat.items[order]).to(device)

    def excluded(u):
        start, count = indptr[u], indptr[u + 1] - indptr[u]
        rows = torch.repeat_interleave(
            torch.arange(len(u), device=device), count)
        first = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
        offs = torch.arange(int(count.sum()), device=device) - first
        cols = indices[torch.repeat_interleave(start, count) + offs]
        m = torch.zeros((len(u), cat.n_items), dtype=torch.bool, device=device)
        m[rows, cols] = True
        return m

    return excluded


def wait_until(due: float) -> None:
    while True:
        left = due - time.perf_counter()
        if left <= 0:
            return
        if left > SPIN_S:
            time.sleep(left - SPIN_S)


def run(ctx) -> Outcome:
    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.serve import Recommender

    cfg, tr = ctx.config, ctx.traffic
    k, ratio = tr["k"], tr["dropui_ratio"]
    with ctx.phase("catalog"):
        cat = generate(seed=ctx.seed, device=ctx.device, **cfg["catalog"])
    with ctx.phase("dataset"):
        full = dataset_of(cat, cfg["name"])
        old = dropui(full, ratio)
    with ctx.phase("prepare"):
        model = get_model(dict(cfg["model"], prop_cache=False), old,
                          ctx.device)
        d = cfg["model"]["embedding_size"]
        n_core_u, n_core_i = old.n_users, old.n_items
        emb = template_weights(cat, ctx.seed, n_core_u, n_core_i, d,
                               ctx.device)
        if emb.shape[0] != model.n_templates:
            raise ValueError(f"{model.n_templates} templates, not "
                             f"{emb.shape[0]}")
        params = {"embedding": emb.clone(),
                  "w": torch.ones(d, device=ctx.device)}
        rec = Recommender(model, params, model.init_buffers(),
                          exclude=tr["exclude"])
    with ctx.phase("refresh"):
        refresh_s = rec.refresh(full)
    reqs = schedule(tr, cat.n_users, ctx.seed)
    gap = 1.0 / tr["rate_rps"]
    with ctx.phase("warm_up"):
        for users in reqs:
            rec.recommend(users, k=k)

    keep = tr["checked_requests"]
    pick = random.Random(ctx.seed)
    kept: list = []
    lat, late = [], []
    served = 0

    def window(t0: float, until: float) -> float:
        """Send the requests due before ``until`` until then; the last
        one's end."""
        nonlocal served
        due, i = t0, 0
        while due < until and time.perf_counter() < until:
            users = reqs[i % len(reqs)]
            wait_until(due)
            late.append(time.perf_counter() - due)
            ids = rec.recommend(users, k=k)
            lat.append(time.perf_counter() - due)
            served += len(users)
            # reservoir sample of the answers, drawn from the seed
            if len(kept) < keep:
                kept.append((users, ids))
            else:
                j = pick.randrange(len(lat))
                if j < keep:
                    kept[j] = (users, ids)
            due += gap
            i += 1
        return time.perf_counter()

    e2e, trace, work = {}, None, {"n_items": cat.n_items, "d": d, "k": k}
    t0 = ctx.start_window()
    if not ctx.trace:
        end = window(t0, t0 + ctx.seconds)
        n = len(lat)
        e2e["request_users_per_s"] = rate(served, end - t0)
        if n:
            fifths = [round(1e3 * percentile(
                lat[j * n // 5:(j + 1) * n // 5] or lat, 95), 4)
                for j in range(5)]
            ctx.log(f"{n} requests, {served} users in {end - t0:.4f} s at "
                    f"{tr['rate_rps']} requests/s offered; p50 "
                    f"{1e3 * percentile(lat, 50):.4f} ms, p95 "
                    f"{1e3 * percentile(lat, 95):.4f}, p99 "
                    f"{1e3 * percentile(lat, 99):.4f}, max "
                    f"{1e3 * max(lat):.4f}; p95 by fifth of the window "
                    f"{fifths}; sender late by {1e3 * sum(late) / n:.4f} ms "
                    f"on average, {1e3 * max(late):.4f} at most, "
                    f"{1e3 * late[-1]:.4f} last")
    else:
        ranged(rec, "recommend", "recommend")
        from torch.profiler import profile, record_function

        with profile(activities=activities(ctx.device)) as prof:
            with record_function(WINDOW):
                t1 = time.perf_counter()  # the profiler's start is not timed
                window(t1, t1 + tr["trace_seconds"])
                sync(ctx.device)
        unrange(rec, "recommend")
        trace = summarize(prof, RANGES)
        work["request_users"] = [len(reqs[i % len(reqs)])
                                 for i in range(len(lat))]
        work["request_latency_s"] = lat
    e2e["refresh_s"] = refresh_s
    peak = peak_memory(ctx.device)
    attempted = len(lat)
    del rec, model, params
    free(ctx.device)

    t = time.perf_counter()
    g = gcn.Graph.of(*cat.pairs(0), cat.n_users, cat.n_items, ctx.device)
    users_rep, items_rep = gcn.igcn_serving_reps(
        emb, g, n_core_u, n_core_i, cfg["model"]["n_layers"])
    excluded = excluded_lookup(cat, ctx.device)
    numbers = serve_numbers(users_rep, items_rep, excluded, kept, k)
    numbers["unchecked"] = float(keep - len(kept))
    ctx.log(f"reference {time.perf_counter() - t:.3f} s over {len(kept)} "
            f"requests")
    out = Outcome(e2e, work, numbers, attempted, 0, peak, trace)
    if ctx.keep_check:
        out.check = dict(emb=emb, graph=g, n_core=(n_core_u, n_core_i),
                         excluded=excluded, kept=kept, k=k,
                         ref=(users_rep, items_rep))
    return out
