"""The score-matrix eval's ranking: flat top-k against the exact two-stage
top-k (port of ``tools/microbench_topk.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_topk [--device cuda|cpu]

One block of the eval is a (B, N_ITEMS) = (512, 40,981) f32 score matrix
ranked to its top K = 20; a Gowalla eval of 29,858 users ranks NB = 59 such
blocks. The scores are N(0, 1) from a seeded ``torch.Generator``. Printed
and returned:

  * for chunks 512, 1,024, 2,048 and 4,096, whether ``two_stage_topk``'s
    ids equal ``flat_topk``'s on every row (``exact_match``);
  * the ms of one eval's ranking, NB calls on one block, for ``flat_topk``
    (a stable descending sort of each whole row, the counterpart of a
    flat ``lax.top_k``), for ``two_stage_topk`` at each chunk, and for the
    eval's own ``evaluate.exact_topk`` (one ``torch.topk`` over the int64
    rank keys), its ids against flat;
  * ``torch.topk``'s ms on the same blocks over the scores themselves, and
    whether its ids equal ``flat_topk``'s (it promises no order among
    equal scores);
  * the ms of one block's two-stage at chunk TOPK_CHUNK in its parts: the
    chunked int64 keys (``chunk_keys``), the first stage's ``torch.topk``
    over them, the second's over the C*k candidates, and beside them the
    first stage over the 32-bit total-order keys alone;
  * nvidia-smi's name and power limit of the card.

Times are CUDA events around the NB calls (``utils/timing.cuda_ms``:
median of 10 after 2 warm-ups, the host's time to issue the calls inside).
The calls queue on one stream, which runs them one after another, so each
block waits for the last as the JAX tool's scan carry made it.
"""

from __future__ import annotations

import argparse

import torch

from igcn_cf_tpu_torch.evaluation.evaluate import (
    decode_keys,
    exact_topk_ids,
    rank_keys,
    total_order,
)
from igcn_cf_tpu_torch.tools import device_line
from igcn_cf_tpu_torch.utils.timing import cuda_ms

B = 512
N_ITEMS = 40981
K = 20
NB = 59  # blocks of B users in an eval at 29,858 users
CHUNKS = (512, 1024, 2048, 4096)
TOPK_CHUNK = 1024  # the JAX package's chunk (its evaluate._TOPK_CHUNK)
SEED = 0


def flat_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) int32 ids by one stable descending sort of each row's
    total-order keys."""
    order = torch.sort(total_order(scores), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return order.to(torch.int32)


def chunk_keys(scores: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, C, chunk) ``rank_keys`` of the row padded with -inf to C whole
    chunks."""
    b, n = scores.shape
    c = -(-n // chunk)
    if c * chunk > n:
        scores = torch.cat([scores, scores.new_full((b, c * chunk - n),
                                                    float("-inf"))], dim=1)
    return rank_keys(scores).view(b, c, chunk)


def two_stage_topk(scores: torch.Tensor, k: int, chunk: int) -> torch.Tensor:
    """(B, k) int32 ids in two stages, the JAX package's ``exact_topk``:
    the top k of each ``chunk`` items, then the top k of the C*k
    candidates. Every global top-k element is in its chunk's top k, so the
    result is exact; the keys are distinct, so its order is ``lax.top_k``'s.
    Needs k <= chunk and k <= n."""
    b = scores.shape[0]
    cand = torch.topk(chunk_keys(scores, chunk), k, dim=2, sorted=False).values
    top = torch.topk(cand.reshape(b, -1), k, dim=1).values
    return decode_keys(top, scores.dtype)[1]


def library_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) int32 ids of one ``torch.topk`` call over the scores."""
    return torch.topk(scores, k, dim=1).indices.to(torch.int32)


def eval_ms(rank, scores) -> float:
    """ms of NB calls of ``rank(scores)``: one eval's ranking."""
    def one_eval():
        for _ in range(NB):
            rank(scores)

    return cuda_ms(one_eval)


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    dev = torch.device(args.device)
    print(f"# top-{K} of ({B}, {N_ITEMS}) f32 scores, {NB} blocks an eval; "
          f"{where}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scores = torch.randn((B, N_ITEMS), generator=gen, device=dev)

    want = flat_topk(scores, K)
    result = {"device": where, "b": B, "n_items": N_ITEMS, "k": K, "nb": NB,
              "exact_match": {}, "ms": {}}
    for chunk in CHUNKS:
        ok = torch.equal(two_stage_topk(scores, K, chunk), want)
        result["exact_match"][chunk] = ok
        print(f"two_stage chunk={chunk}: exact_match={ok}", flush=True)
    result["exact_topk_match"] = torch.equal(exact_topk_ids(scores, K), want)

    result["ms"]["flat"] = eval_ms(lambda s: flat_topk(s, K), scores)
    print(f"flat stable sort     x{NB}: {result['ms']['flat']:9.4f} ms/eval",
          flush=True)
    for chunk in CHUNKS:
        ms = eval_ms(lambda s, c=chunk: two_stage_topk(s, K, c), scores)
        result["ms"][chunk] = ms
        print(f"two_stage chunk={chunk:4d} x{NB}: {ms:9.4f} ms/eval", flush=True)
    result["ms"]["exact_topk"] = eval_ms(lambda s: exact_topk_ids(s, K), scores)
    print(f"exact_topk (eval)    x{NB}: {result['ms']['exact_topk']:9.4f} "
          f"ms/eval; ids equal to flat: {result['exact_topk_match']}",
          flush=True)
    result["ms"]["torch_topk"] = eval_ms(lambda s: library_topk(s, K), scores)
    result["torch_topk_match"] = torch.equal(library_topk(scores, K), want)
    print(f"torch.topk (library) x{NB}: {result['ms']['torch_topk']:9.4f} "
          f"ms/eval; ids equal to flat: {result['torch_topk_match']}",
          flush=True)
    result["parts_ms"] = two_stage_parts(scores)
    print(f"one block's two-stage at chunk {TOPK_CHUNK}, ms: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in result["parts_ms"].items()),
        flush=True)
    return result


def two_stage_parts(scores: torch.Tensor) -> dict:
    """ms of one block's two-stage top-k at TOPK_CHUNK by its parts, and
    of its first stage over the 32-bit total-order keys."""
    b, n = scores.shape
    keys = chunk_keys(scores, TOPK_CHUNK)
    cand = torch.topk(keys, K, dim=2, sorted=False).values.reshape(b, -1)
    order = torch.nn.functional.pad(total_order(scores),
                                    (0, keys[0].numel() - n)).view(keys.shape)
    return {
        "keys": cuda_ms(lambda: chunk_keys(scores, TOPK_CHUNK)),
        "first_stage": cuda_ms(lambda: torch.topk(keys, K, dim=2, sorted=False)),
        "second_stage": cuda_ms(lambda: torch.topk(cand, K, dim=1)),
        "first_stage_int32": cuda_ms(lambda: torch.topk(order, K, dim=2,
                                                        sorted=False)),
    }


if __name__ == "__main__":
    main()
