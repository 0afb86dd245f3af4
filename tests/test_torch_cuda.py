"""The CUDA kernels of igcn_cf_tpu_torch against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA Hopper GPU and nvcc,
and skips without them.

This file imports neither jax nor igcn_cf_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from igcn_cf_tpu_torch.kernels import _build, bitpack, retrieval
from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(rng, n_users, n_items, nnz, device):
    pairs = np.stack([rng.integers(0, n_users, nnz),
                      rng.integers(0, n_items, nnz)], axis=1)
    return BipartiteDense.build(pairs, n_users, n_items, device)


@pytest.mark.parametrize("n_users,n_items,nnz,d", [
    (300, 400, 12000, 16),     # one tile, dense rows
    (1100, 9000, 30000, 64),   # several row blocks and column tiles
    (600, 5000, 20000, 100),   # d not a multiple of 32
    (40, 70, 0, 8),            # no set bit at all
])
def test_pair_kernels_match_plain(cuda, n_users, n_items, nnz, d):
    rng = np.random.default_rng(n_users + d)
    g = _graph(rng, n_users, n_items, nnz, cuda)
    m, kw = g.B.shape
    x1t = torch.randn(d, kw * 32, device=cuda)
    x2t = torch.randn(d, m, device=cuda)
    before = dict(_build.LAUNCHES)
    got1, got2 = bitpack.bbt_pair(g.B, x1t, x2t)
    want1, want2 = bitpack.bbt_pair_plain(g.B, x1t, x2t)
    torch.cuda.synchronize()
    assert got1.shape == (d, m) and got2.shape == (d, kw * 32)
    torch.testing.assert_close(got1, want1, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got2, want2, rtol=1e-5, atol=1e-4)
    assert _build.LAUNCHES["K1"] == before["K1"] + 1
    assert _build.LAUNCHES["K2"] == before["K2"] + 1


def test_pair_kernel_is_deterministic(cuda):
    rng = np.random.default_rng(1)
    g = _graph(rng, 2000, 9000, 60000, cuda)
    x2t = torch.randn(64, g.rows_padded, device=cuda)
    a = bitpack.t2(g.B, x2t)
    b = bitpack.t2(g.B, x2t)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,n_items,nip,li,d,k", [
    (70, 300, 384, 128, 16, 10),       # chunks narrower than K5's block
    (150, 1000, 1024, 256, 8, 7),
    (33, 5000, 8192, 4096, 64, 128),   # largest k, ragged user count
    (16, 20, 128, 128, 4, 20),         # k = every real item
])
@pytest.mark.parametrize("dyadic", [True, False])
def test_fused_topk_kernel_matches_plain(cuda, n, n_items, nip, li, d, k,
                                         dyadic):
    rng = np.random.default_rng(n + k)
    ur = rng.standard_normal((n, d)).astype(np.float32)
    it = rng.standard_normal((d, nip)).astype(np.float32)
    if dyadic:  # exact f32 sums: ids must be identical, ties included
        ur, it = np.round(ur * 8) / 8, np.round(it * 8) / 8
    it[:, n_items:] = 0.0
    rows = np.repeat(np.arange(n), 5)
    cols = rng.integers(0, n_items, 5 * n)
    excl = retrieval.pack_exclusion_words_device(rows, cols, n, nip, li=li,
                                                 device=cuda)
    banned = np.zeros((1, nip), np.float32)
    banned[0, n_items:] = retrieval.NEG
    banned[0, rng.choice(n_items, size=n_items // 10, replace=False)] = retrieval.NEG
    args = (torch.as_tensor(ur, device=cuda), torch.as_tensor(it, device=cuda),
            excl, torch.as_tensor(banned, device=cuda))
    before = _build.LAUNCHES["K5"]
    got = retrieval.fused_topk_ids(*args, k=k, li=li)
    want = retrieval.fused_topk_ids_plain(*args, k=k, li=li)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K5"] == before + 1
    if dyadic:
        assert torch.equal(got, want)
    else:  # identical ids except between scores within 1e-5 relative
        s = args[0] @ args[1] + args[3]
        s = torch.where(retrieval.unpack_exclusion(excl, li),
                        torch.tensor(retrieval.NEG, device=cuda), s)
        sg = torch.gather(s, 1, got.long())
        sw = torch.gather(s, 1, want.long())
        assert bool(((sg - sw).abs() <= 1e-5 * sw.abs()).all())


def test_fused_topk_constant_scores_pick_lowest_ids(cuda):
    n, nip, k = 40, 2048, 25
    ur = torch.full((n, 4), 0.25, device=cuda)
    it = torch.full((4, nip), 0.5, device=cuda)
    excl = torch.zeros((n, nip // 32), dtype=torch.int32, device=cuda)
    banned = torch.zeros((1, nip), device=cuda)
    got = retrieval.fused_topk_ids(ur, it, excl, banned, k=k, li=1024)
    want = torch.arange(k, dtype=torch.int32, device=cuda).expand(n, k)
    assert torch.equal(got, want)


def test_cuda_wrappers_refuse_bad_operands(cuda):
    wp = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bitpack.t1(wp, torch.zeros(8, 100, device=cuda))  # wrong K
    with pytest.raises(ValueError):
        bitpack.t1(wp.to(torch.int64), torch.zeros(8, 4096, device=cuda))
    ur = torch.zeros((4, 8), device=cuda)
    it = torch.zeros((8, 4096), device=cuda)
    excl = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    banned = torch.zeros((1, 4096), device=cuda)
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it.T.contiguous().T, excl, banned, k=5)
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it, excl, banned, k=129)
