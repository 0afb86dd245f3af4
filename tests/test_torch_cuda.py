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

import chip_smoke
from igcn_cf_tpu_torch.kernels import _build, bitpack, pcache, retrieval
from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense

# K3/K4 and K6/K7 against plain f32 matmuls of the same bf16 operands: only
# the order of the f32 sums differs (mma tiles vs matmul)
GATHER_TOL = dict(rtol=1e-4, atol=1e-3)


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
    (300, 5000, 8192, 4096, 256, 20),  # NGCF's eval width
    (200, 5000, 8192, 4096, 64, 32),   # one list slot a lane, bound at its limit
    (200, 5000, 8192, 4096, 64, 33),   # four list slots a lane, no bound
    (129, 800, 896, 128, 8, 20),       # a 1-row second user tile; 7 item tiles
    (40, 1000, 1024, 128, 6, 20),      # d not a multiple of 4 or of 16
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


def _dyadic_topk_args(rng, n, nip, d, device):
    ur = np.round(rng.standard_normal((n, d)) * 8) / 8
    it = np.round(rng.standard_normal((d, nip)) * 8) / 8
    return (torch.as_tensor(ur, dtype=torch.float32, device=device),
            torch.as_tensor(it, dtype=torch.float32, device=device))


@pytest.mark.parametrize("k", [20, 40])
@pytest.mark.parametrize("splits", [1, 3])
def test_fused_topk_row_with_fewer_allowed_items_than_k(cuda, k, splits):
    """Row 0 may take 3 items (one of them banned), row 1 none: after the
    allowed ones come the NEG-scored items, lowest id first, as the plain
    version's stable sort orders them, across tiles and ranges."""
    n, n_items, nip, li = 40, 1000, 1024, 128
    rng = np.random.default_rng(k + splits)
    ur, it = _dyadic_topk_args(rng, n, nip, 8, cuda)
    allowed = [5, 300, 777]
    rows = [np.zeros(n_items - 3, np.int64), np.ones(n_items, np.int64),
            np.repeat(np.arange(2, n), 5)]
    cols = [np.setdiff1d(np.arange(n_items), allowed), np.arange(n_items),
            rng.integers(0, n_items, 5 * (n - 2))]
    excl = retrieval.pack_exclusion_words_device(
        np.concatenate(rows), np.concatenate(cols), n, nip, li=li, device=cuda)
    banned = torch.zeros((1, nip), device=cuda)
    banned[0, n_items:] = retrieval.NEG
    banned[0, 300] = retrieval.NEG
    got = retrieval._fused_topk_cuda(ur, it, excl, banned, k, li, splits)
    want = retrieval.fused_topk_ids_plain(ur, it, excl, banned, k=k, li=li)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    s = (ur[0] @ it).cpu()
    head = sorted([5, 777], key=lambda c: (-float(s[c]), c))
    tail = [c for c in range(nip) if c not in (5, 777)]
    assert got[0].tolist() == (head + tail)[:k]
    assert got[1].tolist() == list(range(k))


@pytest.mark.parametrize("splits", [1, 2, 4, 5])
def test_fused_topk_ties_straddle_tile_and_range_edges(cuda, splits):
    """36 items share the top score: items 60-69 lie in three item tiles,
    1020-1029 across the tiles (7 | 8) that begin a range at S 4, 2040-2055
    across tiles 15 | 16, a range edge at S 2. The 25 lowest ids win."""
    n, nip, li, d, k = 20, 4096, 1024, 4, 25
    rng = np.random.default_rng(splits)
    ur = torch.full((n, d), 0.25, device=cuda)
    it = np.round(rng.uniform(-1.0, 0.5, (1, nip)) * 8) / 8
    top = np.r_[60:70, 1020:1030, 2040:2056]
    it[0, top] = 1.0
    it = torch.as_tensor(np.repeat(it, d, axis=0), dtype=torch.float32,
                         device=cuda)
    excl = torch.zeros((n, nip // 32), dtype=torch.int32, device=cuda)
    banned = torch.zeros((1, nip), device=cuda)
    got = retrieval._fused_topk_cuda(ur, it, excl, banned, k, li, splits)
    want = retrieval.fused_topk_ids_plain(ur, it, excl, banned, k=k, li=li)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[0].tolist() == sorted(top.tolist())[:k]


def test_fused_topk_eval_shape_splits_give_identical_ids(cuda):
    """At the validation eval's shape the item ranges S change only which
    block sees which items: the scores are the same sums in the same order,
    so S 1, the library's S and S 4 give identical ids, and two launches
    agree. The chosen S's ids match the plain version rank-wise."""
    n, n_items, nip, d, k = 29858, 40981, 45056, 64, 20
    rng = np.random.default_rng(7)
    ur = torch.as_tensor(rng.standard_normal((n, d), np.float32), device=cuda)
    it = rng.standard_normal((d, nip), np.float32)
    it[:, n_items:] = 0.0
    it = torch.as_tensor(it, device=cuda)
    rows = np.repeat(np.arange(n), 28)
    excl = retrieval.pack_exclusion_words_device(
        rows, rng.integers(0, n_items, 28 * n), n, nip, device=cuda)
    banned = torch.zeros((1, nip), device=cuda)
    banned[0, n_items:] = retrieval.NEG
    chosen = retrieval.topk_splits(n, nip, k, cuda)
    got = {s: retrieval._fused_topk_cuda(ur, it, excl, banned, k,
                                         retrieval.LI, s)
           for s in sorted({1, chosen, 4})}
    again = retrieval._fused_topk_cuda(ur, it, excl, banned, k, retrieval.LI,
                                       chosen)
    torch.cuda.synchronize()
    assert all(torch.equal(g, got[1]) for g in got.values())
    assert torch.equal(again, got[chosen])
    for a in range(0, n, 4096):
        sl = slice(a, a + 4096)
        want = retrieval.fused_topk_ids_plain(ur[sl], it, excl[sl], banned, k=k)
        s = chip_smoke.plain_scores(ur[sl], it, excl[sl], banned, retrieval.LI)
        chip_smoke.topk_agree(got[chosen][sl], want, s, chip_smoke.TOPK_RTOL)


def test_fused_topk_microbench_retrieval_sweep_gives_the_choice_ids(cuda):
    """K5 at ``microbench_retrieval``'s shape and inputs (29,858 users,
    40,981 items, d=64, k=20, the JAX tool's exclusion density, scores
    exact in f32): every S of the tool's sweep gives the library choice's
    ids, and the choice's first 512 rows equal the stable argsort of their
    masked scores."""
    from igcn_cf_tpu_torch.tools import microbench_retrieval as mr

    nip = bitpack.pad_to(mr.N_ITEMS, retrieval.LI)
    excl = mr.exclusion_lists(mr.N_USERS, mr.N_ITEMS)
    words = torch.as_tensor(retrieval.pack_exclusion_words(
        excl, mr.N_USERS, mr.N_ITEMS, nip)).to(cuda)
    ur, it = mr.random_operands(mr.N_USERS, nip, mr.D, cuda)
    banned = torch.zeros((1, nip), device=cuda)
    banned[0, mr.N_ITEMS:] = retrieval.NEG
    chosen = retrieval.topk_splits(mr.N_USERS, nip, mr.K, cuda)
    want = retrieval._fused_topk_cuda(ur, it, words, banned, mr.K,
                                      retrieval.LI, chosen)
    for s in mr.SWEEP_SPLITS:
        got = retrieval._fused_topk_cuda(ur, it, words, banned, mr.K,
                                         retrieval.LI, s)
        assert torch.equal(got, want), s
    assert mr.block0_exact(ur, it, excl, mr.N_ITEMS, mr.K, want)


def test_fused_topk_is_deterministic_at_a_request(cuda):
    """A 4,096-user request runs S > 1 ranges whose shared thresholds are
    read in whatever order the blocks run: two launches give the same
    ids."""
    n, nip, d, k = 4096, 45056, 64, 20
    rng = np.random.default_rng(11)
    ur = torch.as_tensor(rng.standard_normal((n, d), np.float32), device=cuda)
    it = torch.as_tensor(rng.standard_normal((d, nip), np.float32), device=cuda)
    excl = torch.zeros((n, nip // 32), dtype=torch.int32, device=cuda)
    banned = torch.zeros((1, nip), device=cuda)
    assert retrieval.topk_splits(n, nip, k, cuda) > 1
    a = retrieval.fused_topk_ids(ur, it, excl, banned, k=k)
    b = retrieval.fused_topk_ids(ur, it, excl, banned, k=k)
    assert torch.equal(a, b)


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
    with pytest.raises(ValueError):  # K5's item tile needs li % 128 == 0
        retrieval.fused_topk_ids(ur, it[:, :64 * 32].contiguous(),
                                 excl[:, :64], banned[:, :64 * 32], k=5, li=64)
    with pytest.raises(ValueError):  # S beyond one item tile a range
        retrieval._fused_topk_cuda(ur, it, excl, banned, 5, 4096, 33)


@pytest.mark.parametrize("n_users,n_items,nnz,d", [
    (300, 400, 12000, 128),    # the build's block width
    (1100, 9000, 30000, 64),
])
def test_bb_matmul_kernels_match_plain(cuda, n_users, n_items, nnz, d):
    rng = np.random.default_rng(n_users + d)
    g = _graph(rng, n_users, n_items, nnz, cuda)
    m, kw = g.B.shape
    x_cols = torch.randn(kw * 32, d, device=cuda)
    x_rows = torch.randn(m, d, device=cuda)
    before = dict(_build.LAUNCHES)
    got_f = bitpack.mm_fwd(g.B, x_cols)
    got_b = bitpack.mm_bwd(g.B, x_rows)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K6"] == before["K6"] + 1
    assert _build.LAUNCHES["K7"] == before["K7"] + 1
    torch.testing.assert_close(got_f, bitpack.mm_fwd_plain(g.B, x_cols),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_b, bitpack.mm_bwd_plain(g.B, x_rows),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,seed,p", [
    ((512, 128), 0, 0.3),
    ((1536, 384), 2**32 - 1, 0.3),
    ((512, 256), 2**32 - 77, 0.7),
])
def test_mask_words_kernel_is_bit_exact(cuda, shape, seed, p):
    gen = torch.Generator(device=cuda).manual_seed(shape[0])
    wp = torch.randint(-2**31, 2**31, shape, generator=gen, device=cuda,
                       dtype=torch.int64).to(torch.int32)
    wp[::3] = 0  # zero words skip the hash
    before = _build.LAUNCHES["K8"]
    got = bitpack.mask_words(wp, seed, p)
    want = bitpack.mask_words_plain(wp, seed, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K8"] == before + 1
    assert torch.equal(got, want)


def _mask_case(cuda, m, kw, fill, seed):
    """(m, kw) int32 words: "zeros", "ones" (every bit set), "dense" (random,
    every word non-zero) or "sparse" (~3% of the words non-zero, as the
    training B)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if fill == "zeros":
        return torch.zeros((m, kw), dtype=torch.int32, device=cuda)
    if fill == "ones":
        return torch.full((m, kw), -1, dtype=torch.int32, device=cuda)
    wp = torch.randint(-2**31, 2**31, (m, kw), generator=gen, device=cuda,
                       dtype=torch.int64).to(torch.int32)
    wp[wp == 0] = 1
    if fill == "sparse":
        wp[torch.rand((m, kw), generator=gen, device=cuda) >= 0.03] = 0
    return wp


@pytest.mark.parametrize("m,kw,fill", [
    (1, 1, "dense"), (1, 3, "ones"), (1, 5, "dense"), (1, 1408, "sparse"),
    (1, 1408, "dense"),
    (7, 5, "ones"),          # rows that start inside a 16-byte group
    (333, 3, "dense"),       # m * kw not a multiple of 4
    (512, 128, "zeros"),
    (1536, 384, "sparse"),
    (700, 1408, "sparse"),   # the training B's width and density
    (2000, 1408, "dense"),   # the dual tool's words, hashed in place
    (30208, 67, "sparse"),   # high rows, kw odd
    (4, 300001, "dense"),    # high words
])
def test_mask_words_pair_kernel_is_bit_exact(cuda, m, kw, fill):
    """K8p's two copies and K8's one against mask_words_plain: kw not a
    multiple of 4, all-zero, all-one, dense and sparse words, high row and
    word coordinates, seeds at the top of the u32 range; one count a call."""
    wp = _mask_case(cuda, m, kw, fill, m + kw)
    seed_a, seed_b, p = 2**32 - 12345, 2**32 - 1, 0.3
    before = dict(_build.LAUNCHES)
    got_a, got_b = bitpack.mask_words_pair(wp, seed_a, seed_b, p)
    got = bitpack.mask_words(wp, seed_b, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K8p"] == before["K8p"] + 1
    assert _build.LAUNCHES["K8"] == before["K8"] + 1
    assert torch.equal(got_a, bitpack.mask_words_plain(wp, seed_a, p))
    want_b = bitpack.mask_words_plain(wp, seed_b, p)
    assert torch.equal(got_b, want_b) and torch.equal(got, want_b)


def test_mask_words_kernels_read_a_misaligned_view(cuda):
    """Words that start 4 bytes into their storage (the kernel moves 16
    bytes at a time): the wrappers copy them, and the result is the
    aligned one."""
    wp = _mask_case(cuda, 1, 4001, "dense", 3)[0, 1:].view(40, 100)
    assert wp.data_ptr() % 16
    want = bitpack.mask_words_plain(wp, 5, 0.5)
    assert torch.equal(bitpack.mask_words(wp, 5, 0.5), want)
    assert torch.equal(bitpack.mask_words_pair(wp, 5, 6, 0.5)[0], want)


def test_mask_words_pair_refuses_bad_operands(cuda):
    wp = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bitpack.mask_words_pair(wp.to(torch.int64), 1, 2, 0.3)
    with pytest.raises(ValueError):
        bitpack.mask_words_pair(wp.T, 1, 2, 0.3)  # not contiguous
    with pytest.raises(ValueError):
        bitpack.mask_words_pair(wp, 1, 2**32, 0.3)


def test_igcn_step_makes_one_mask_launch(cuda):
    """An IGCN BPR step with edge dropout masks B under its two seeds with
    one K8p launch, and no one-seed K8 launch, on either engine."""
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    ds = synthetic_interactions(n_users=300, n_items=500, avg_degree=12, seed=5)
    model_cfg = {"name": "IGCN", "embedding_size": 64, "n_layers": 2,
                 "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense"}
    trainer_cfg = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
                   "l2_reg": 1e-3, "aux_reg": 0.01, "n_epochs": 1,
                   "batch_size": 256, "topks": [20], "seed": 3}
    for prop_cache in (True, False):
        trainer = get_trainer(trainer_cfg, ds, get_model(
            dict(model_cfg, prop_cache=prop_cache), ds, "cuda"))
        inputs = trainer.sample_step()
        before = dict(_build.LAUNCHES)
        loss = trainer.train_step(*inputs)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss))
        assert _build.LAUNCHES["K8p"] == before["K8p"] + 1, prop_cache
        assert _build.LAUNCHES["K8"] == before["K8"], prop_cache


def _gather_case(cuda, n, r, dup):
    gen = torch.Generator(device=cuda).manual_seed(n + r)
    npad = pcache.pcache_npad(n)
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    if dup:
        rows[r // 2:] = rows[: r - r // 2]  # every id at least twice
    return p, rows


@pytest.mark.parametrize("n,r,d,dup", [
    (700, 300, 64, True),     # ragged R, duplicate rows
    (5000, 1000, 40, False),  # d padded to the kernel tile
])
def test_gather_kernels_match_plain(cuda, n, r, d, dup):
    p, rows = _gather_case(cuda, n, r, dup)
    npad = p.shape[1]
    x0b = torch.randn((npad, d), device=cuda).to(torch.bfloat16)
    ctb = torch.randn((r, d), device=cuda).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    got_f = pcache.gather_fwd(p, rows, x0b)
    got_b = pcache.gather_bwd(p, rows, ctb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K3"] == before["K3"] + 1
    assert _build.LAUNCHES["K4"] == before["K4"] + 1
    assert got_f.shape == (r, d) and got_b.shape == (npad, d)
    torch.testing.assert_close(got_f, pcache.gather_fwd_plain(p, rows, x0b),
                               **GATHER_TOL)
    torch.testing.assert_close(got_b, pcache.gather_bwd_plain(p, rows, ctb),
                               **GATHER_TOL)


def test_gather_bwd_kernel_is_deterministic(cuda):
    p, rows = _gather_case(cuda, 3000, 2048, True)
    ctb = torch.randn((2048, 64), device=cuda).to(torch.bfloat16)
    assert torch.equal(pcache.gather_bwd(p, rows, ctb),
                       pcache.gather_bwd(p, rows, ctb))


def test_cached_prop_grad_matches_plain(cuda):
    p, rows = _gather_case(cuda, 900, 200, True)
    x0 = torch.randn((900, 64), device=cuda, requires_grad=True)
    ct = torch.randn((200, 64), device=cuda)
    pcache.cached_prop(p, rows, x0).backward(ct)
    want = pcache.gather_bwd_plain(p, rows, ct.to(torch.bfloat16))[:900]
    torch.testing.assert_close(x0.grad, want, **GATHER_TOL)


def test_new_wrappers_refuse_bad_operands(cuda):
    p = torch.zeros((100, 128), dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(10, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        pcache.gather_fwd(p.float(), rows, torch.zeros(128, 8, device=cuda))
    with pytest.raises(ValueError):
        pcache.gather_fwd(p, rows, torch.zeros(100, 8, device=cuda))  # npad
    with pytest.raises(ValueError):
        pcache.gather_bwd(p, rows[:, None], torch.zeros(10, 8, device=cuda))
    with pytest.raises(ValueError):
        pcache.gather_bwd(p[:, :100].contiguous(), rows,
                          torch.zeros(10, 8, device=cuda))
    wp = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bitpack.mask_words(wp.to(torch.int64), 1, 0.3)
    with pytest.raises(ValueError):
        bitpack.mask_words(wp, 2**32, 0.3)
    with pytest.raises(ValueError):
        bitpack.mm_fwd(wp, torch.zeros(100, 8, device=cuda))
    with pytest.raises(ValueError):
        bitpack.mm_bwd(wp, torch.zeros(4096, 8, device=cuda))


@pytest.mark.parametrize("n_users,n_items,nnz,d,seed,p", [
    (300, 400, 12000, 64, 7, 0.1),            # NGCF's width and dropout
    (1100, 9000, 30000, 16, 2**32 - 1, 0.3),  # several tiles, top seed
    (600, 5000, 20000, 100, 12345, 0.5),      # d not a multiple of 32
])
def test_masked_matmul_kernels_match_plain_and_premasked(
        cuda, n_users, n_items, nnz, d, seed, p):
    """K6m/K7m against their plain versions, and bit-equal to K6/K7 over
    mask_words' premasked B: the in-kernel keep decision is the same
    function of (seed, row, word)."""
    rng = np.random.default_rng(n_users + d)
    g = _graph(rng, n_users, n_items, nnz, cuda)
    m, kw = g.B.shape
    x_cols = torch.randn(kw * 32, d, device=cuda)
    x_rows = torch.randn(m, d, device=cuda)
    before = dict(_build.LAUNCHES)
    got_f = bitpack.mm_fwd_masked(g.B, x_cols, seed, p)
    got_b = bitpack.mm_bwd_masked(g.B, x_rows, seed, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K6m"] == before["K6m"] + 1
    assert _build.LAUNCHES["K7m"] == before["K7m"] + 1
    torch.testing.assert_close(got_f, bitpack.mm_fwd_masked_plain(g.B, x_cols, seed, p),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_b, bitpack.mm_bwd_masked_plain(g.B, x_rows, seed, p),
                               rtol=1e-5, atol=1e-4)
    premasked = bitpack.mask_words(g.B, seed, p)
    assert torch.equal(got_f, bitpack.mm_fwd(premasked, x_cols))
    assert torch.equal(got_b, bitpack.mm_bwd(premasked, x_rows))
    assert not torch.equal(got_f, bitpack.mm_fwd(g.B, x_cols))  # it drops


def test_masked_bwd_kernel_is_deterministic(cuda):
    rng = np.random.default_rng(2)
    g = _graph(rng, 2000, 9000, 60000, cuda)
    x = torch.randn(g.rows_padded, 64, device=cuda)
    assert torch.equal(bitpack.mm_bwd_masked(g.B, x, 99, 0.1),
                       bitpack.mm_bwd_masked(g.B, x, 99, 0.1))


@pytest.mark.parametrize("transpose", [False, True])
def test_bb_matmul_dropped_grad_matches_plain(cuda, transpose):
    """The backward runs the other masked orientation under the same seed."""
    rng = np.random.default_rng(3)
    g = _graph(rng, 700, 5000, 20000, cuda)
    m, kw = g.B.shape
    x = torch.randn((m if transpose else kw * 32), 64, device=cuda,
                    requires_grad=True)
    ct = torch.randn((kw * 32 if transpose else m), 64, device=cuda)
    bitpack.bb_matmul_dropped(g.B, x, 41, 0.1, transpose).backward(ct)
    plain = bitpack.mm_fwd_masked_plain if transpose else bitpack.mm_bwd_masked_plain
    torch.testing.assert_close(x.grad, plain(g.B, ct, 41, 0.1), rtol=1e-5, atol=1e-4)


def _heavy_graph(rng, n_users, n_items, nnz, heavy_users, device):
    """A random graph whose last item ``heavy_users`` users hold (a row of
    B^T with more set bits than the rows route's warps list at once), with
    B's transposed pack."""
    pairs = np.stack([rng.integers(0, n_users, nnz),
                      rng.integers(0, n_items, nnz)], axis=1)
    heavy = np.stack([np.arange(heavy_users), np.full(heavy_users, n_items - 1)],
                     axis=1)
    return BipartiteDense.build(np.concatenate([pairs, heavy]), n_users, n_items,
                                device, transposed=True)


@pytest.mark.parametrize("n_users,n_items,nnz,heavy,d,seed,p", [
    (300, 400, 12000, 290, 64, 7, 0.1),             # NGCF's width and dropout
    (5000, 9000, 40000, 1500, 16, 2**32 - 1, 0.3),  # two tiles of users, top seed
    (600, 5000, 20000, 600, 100, 12345, 0.5),       # d not a multiple of 32
    (700, 300, 2000, 0, 256, 3, 0.1),               # no heavy row, widest d
])
def test_rows_route_matches_plain(cuda, n_users, n_items, nnz, heavy, d, seed, p):
    """K7m's rows route against its plain version and against K7m's t2 body
    over B, at K7m's tolerances; each launch counts as K7m and K7m_rows."""
    rng = np.random.default_rng(n_users + d)
    g = _heavy_graph(rng, n_users, n_items, nnz, heavy, cuda)
    assert g.BT.heavy == (1 if heavy > bitpack.HEAVY_BITS else 0)
    x = torch.randn(g.rows_padded, d, device=cuda)
    before = dict(_build.LAUNCHES)
    got = bitpack.mm_bwd_masked_rows(g.BT, x, seed, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K7m"] == before["K7m"] + 1
    assert _build.LAUNCHES["K7m_rows"] == before["K7m_rows"] + 1
    assert got.shape == (g.cols_padded, d)
    torch.testing.assert_close(got, bitpack.mm_bwd_masked_rows_plain(g.BT, x, seed, p),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got, bitpack.mm_bwd_masked(g.B, x, seed, p),
                               rtol=1e-5, atol=1e-4)
    assert not torch.any(got[n_items:])  # rows past the pack's are zeros


@pytest.mark.parametrize("seed,p", [(7, 0.1), (2**32 - 3, 0.3)])
def test_rows_route_at_p0_over_a_premasked_pack_is_bit_equal(cuda, seed, p):
    """The rows route at p is bit-equal to itself at p = 0 over the
    transposed pack of ``mask_words(B, seed, p)`` walked in B's schedule
    (its order and heavy rows: a row's sum order depends on whether a block
    or a warp walks it): the in-kernel keep decision is B's, and dropped
    edges leave the order of the rest."""
    rng = np.random.default_rng(5)
    g = _heavy_graph(rng, 2000, 9000, 60000, 900, cuda)
    x = torch.randn(g.rows_padded, 64, device=cuda)
    premasked = bitpack.transpose_words(bitpack.mask_words(g.B, seed, p),
                                        g.n_items)._replace(order=g.BT.order,
                                                            heavy=g.BT.heavy)
    got = bitpack.mm_bwd_masked_rows(g.BT, x, seed, p)
    assert torch.equal(got, bitpack.mm_bwd_masked_rows(premasked, x, seed, 0.0))
    assert not torch.equal(got, bitpack.mm_bwd_masked_rows(g.BT, x, seed, 0.0))


def test_rows_route_is_deterministic_with_heavy_rows(cuda):
    """Two launches bit-equal where several rows of B^T outgrow a warp's
    list, and the heaviest row equal to its plain version."""
    rng = np.random.default_rng(6)
    pairs = np.stack([rng.integers(0, 3000, 50000),
                      rng.zipf(1.3, 50000) % 9000], axis=1)
    g = BipartiteDense.build(pairs, 3000, 9000, cuda, transposed=True)
    assert g.BT.heavy > 1
    x = torch.randn(g.rows_padded, 64, device=cuda)
    a = bitpack.mm_bwd_masked_rows(g.BT, x, 99, 0.1)
    assert torch.equal(a, bitpack.mm_bwd_masked_rows(g.BT, x, 99, 0.1))
    torch.testing.assert_close(a, bitpack.mm_bwd_masked_rows_plain(g.BT, x, 99, 0.1),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("transpose", [False, True])
def test_bb_matmul_dropped_over_a_pack_grad_matches_plain(cuda, transpose):
    """With B's transposed pack, the masked B^T @ X of the forward
    (transpose) or of the backward takes the rows route, and both passes
    match their plain versions."""
    rng = np.random.default_rng(8)
    g = _heavy_graph(rng, 700, 5000, 20000, 500, cuda)
    m, kw = g.B.shape
    x = torch.randn((m if transpose else kw * 32), 64, device=cuda,
                    requires_grad=True)
    ct = torch.randn((kw * 32 if transpose else m), 64, device=cuda)
    before = dict(_build.LAUNCHES)
    y = bitpack.bb_matmul_dropped(g.B, x, 41, 0.1, transpose, g.BT)
    y.backward(ct)
    assert _build.LAUNCHES["K7m_rows"] == before["K7m_rows"] + 1
    fwd = bitpack.mm_bwd_masked_plain if transpose else bitpack.mm_fwd_masked_plain
    bwd = bitpack.mm_fwd_masked_plain if transpose else bitpack.mm_bwd_masked_plain
    torch.testing.assert_close(y.detach(), fwd(g.B, x.detach(), 41, 0.1), rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(x.grad, bwd(g.B, ct, 41, 0.1), rtol=1e-5, atol=1e-4)


def test_rows_route_refuses_bad_operands(cuda):
    rng = np.random.default_rng(9)
    g = _heavy_graph(rng, 300, 400, 3000, 0, cuda)
    with pytest.raises(ValueError):  # X of B's columns, not its rows
        bitpack.mm_bwd_masked_rows(g.BT, torch.zeros(g.cols_padded, 8, device=cuda),
                                   1, 0.1)
    with pytest.raises(ValueError):
        bitpack.mm_bwd_masked_rows(g.BT, torch.zeros(g.rows_padded, 8, device=cuda),
                                   2**32, 0.1)
    with pytest.raises(ValueError):
        bitpack.mm_bwd_masked_rows(g.BT._replace(order=g.BT.order.long()),
                                   torch.zeros(g.rows_padded, 8, device=cuda), 1, 0.1)


def test_ngcf_step_on_the_card_matches_the_cpu(cuda):
    """One NGCF BPR step's loss and gradients through the kernels against
    the same step on the CPU's plain versions: same params, batch and drop."""
    from igcn_cf_tpu_torch.convert import copy_params_, flatten_tree
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    ds = synthetic_interactions(n_users=300, n_items=500, avg_degree=12, seed=5)
    model_cfg = {"name": "NGCF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64], "dropout": 0.1}
    trainer_cfg = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
                   "l2_reg": 1e-3, "n_epochs": 1, "batch_size": 256,
                   "topks": [20], "seed": 3}
    t_gpu = get_trainer(trainer_cfg, ds, get_model(model_cfg, ds, "cuda"))
    t_cpu = get_trainer(trainer_cfg, ds, get_model(model_cfg, ds, "cpu"))
    copy_params_(t_cpu.params, t_gpu.params)
    (users, pos, neg), drop = t_gpu.sample_step()
    before = dict(_build.LAUNCHES)
    loss_g = t_gpu.loss(t_gpu.params, (users, pos, neg), drop)
    grads_g = torch.autograd.grad(loss_g, list(t_gpu.flat_params.values()))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K6m"] == before["K6m"] + 6
    assert _build.LAUNCHES["K7m"] == before["K7m"] + 6
    # every K7m of the step, forward and backward, took the rows route
    assert _build.LAUNCHES["K7m_rows"] == before["K7m_rows"] + 6
    to_cpu = lambda t: t.cpu()  # noqa: E731
    drop_cpu = type(drop)(type(drop.edge)(drop.edge.seed_b, drop.edge.seed_bt,
                                          to_cpu(drop.edge.keep_u),
                                          to_cpu(drop.edge.keep_i)),
                          [to_cpu(f) for f in drop.feat])
    batch_cpu = tuple(map(to_cpu, (users, pos, neg)))
    loss_c = t_cpu.loss(t_cpu.params, batch_cpu, drop_cpu)
    grads_c = torch.autograd.grad(loss_c, list(t_cpu.flat_params.values()))
    assert abs(float(loss_g.detach()) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for name, gg, gc in zip(flatten_tree(t_gpu.params), grads_g, grads_c):
        scale = float(gc.abs().max())
        assert float((gg.cpu() - gc).abs().max()) <= 1e-2 * scale, name


def test_masked_wrappers_refuse_bad_operands(cuda):
    wp = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bitpack.mm_fwd_masked(wp, torch.zeros(100, 8, device=cuda), 1, 0.1)
    with pytest.raises(ValueError):
        bitpack.mm_bwd_masked(wp, torch.zeros(4096, 8, device=cuda), 1, 0.1)
    with pytest.raises(ValueError):
        bitpack.mm_fwd_masked(wp, torch.zeros(4096, 8, device=cuda), 2**32, 0.1)


@pytest.mark.parametrize("n_users,n_items,nnz,d,seed,p", [
    (300, 400, 12000, 64, 7, 0.3),            # IGCN's width and dropout
    (1100, 9000, 30000, 16, 2**32 - 1, 0.1),  # several tiles, top seed
    (600, 5000, 20000, 100, 12345, 0.5),      # d not a multiple of 32
])
def test_masked_pair_kernels_match_plain_and_premasked(
        cuda, n_users, n_items, nnz, d, seed, p):
    """K1m/K2m against their plain versions, and bit-equal to K1/K2 over
    mask_words' premasked B."""
    rng = np.random.default_rng(n_users + d)
    g = _graph(rng, n_users, n_items, nnz, cuda)
    m, kw = g.B.shape
    x1t = torch.randn(d, kw * 32, device=cuda)
    x2t = torch.randn(d, m, device=cuda)
    before = dict(_build.LAUNCHES)
    got1 = bitpack.t1_masked(g.B, x1t, seed, p)
    got2 = bitpack.t2_masked(g.B, x2t, seed, p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K1m"] == before["K1m"] + 1
    assert _build.LAUNCHES["K2m"] == before["K2m"] + 1
    assert got1.shape == (d, m) and got2.shape == (d, kw * 32)
    torch.testing.assert_close(got1, bitpack.t1_masked_plain(g.B, x1t, seed, p),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got2, bitpack.t2_masked_plain(g.B, x2t, seed, p),
                               rtol=1e-5, atol=1e-4)
    premasked = bitpack.mask_words(g.B, seed, p)
    assert torch.equal(got1, bitpack.t1(premasked, x1t))
    assert torch.equal(got2, bitpack.t2(premasked, x2t))


def test_bbt_pair_dropped_grad_matches_plain(cuda):
    """The backward swaps directions and keeps each direction's seed."""
    rng = np.random.default_rng(4)
    g = _graph(rng, 700, 5000, 20000, cuda)
    m, kw = g.B.shape
    s1, s2, p = 2**32 - 3, 91, 0.3
    x1t = torch.randn(64, kw * 32, device=cuda, requires_grad=True)
    x2t = torch.randn(64, m, device=cuda, requires_grad=True)
    c1, c2 = torch.randn(64, m, device=cuda), torch.randn(64, kw * 32, device=cuda)
    y1t, y2t = bitpack.bbt_pair_dropped(g.B, x1t, x2t, s1, s2, p)
    torch.autograd.backward((y1t, y2t), (c1, c2))
    torch.testing.assert_close(x1t.grad, bitpack.t2_masked_plain(g.B, c1, s1, p),
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(x2t.grad, bitpack.t1_masked_plain(g.B, c2, s2, p),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,npad,nj,r,d,tr,dup", [
    (712, 1024, 2, 256, 64, 64, False),   # the tool's correctness shape
    (700, 2048, 4, 300, 40, 128, True),   # ragged R, d padded, duplicates
    (3000, 4096, 2, 520, 128, 256, True),  # two feature tiles, largest TR
    (500, 1024, 1, 100, 64, 16, False),   # one slab, smallest TR
])
def test_fused_4d_kernels_match_plain_and_k3_k4(cuda, n, npad, nj, r, d, tr,
                                                dup):
    """T1/T2 against their plain versions and against K3/K4 on the same
    row-major P; T2 runs K4's body, so it is bit-equal to K4 and to T4
    transposed at every TR (the rows of a ring stage move, the sums do
    not), also where npad is not a multiple of K4's 320-column tile."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    gen = torch.Generator(device=cuda).manual_seed(n + r)
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    if dup:
        rows[r // 2:] = rows[: r - r // 2]
    x0 = torch.randn((npad, d), generator=gen, device=cuda)
    ct = torch.randn((r, d), generator=gen, device=cuda)
    p4 = mpc.to4d(p, nj)
    before = dict(_build.LAUNCHES)
    got_f = mpc.fused_fwd_4d(p4, rows, x0, tr)
    got_b = mpc.fused_bwd_4d(p4, rows, ct, tr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["T1"] == before["T1"] + 1
    assert _build.LAUNCHES["T2"] == before["T2"] + 1
    assert got_f.shape == (r, d) and got_b.shape == (npad, d)
    torch.testing.assert_close(got_f, mpc.fused_fwd_4d_plain(p4, rows, x0),
                               **GATHER_TOL)
    torch.testing.assert_close(got_b, mpc.fused_bwd_4d_plain(p4, rows, ct),
                               **GATHER_TOL)
    torch.testing.assert_close(got_f, pcache.gather_fwd(p, rows, x0.to(torch.bfloat16)),
                               **GATHER_TOL)
    k4 = pcache.gather_bwd(p, rows, ct.to(torch.bfloat16))
    torch.testing.assert_close(got_b, k4, **GATHER_TOL)
    assert torch.equal(got_b, mpc.fused_bwd_4d(p4, rows, ct, tr))  # one writer
    assert torch.equal(got_b, k4)
    for other in (16, 32, 64, 128, 256):
        assert torch.equal(mpc.fused_bwd_4d(p4, rows, ct, other), k4), other
        assert torch.equal(mpt.bwd_t(p4, rows, ct, other).T, k4), other


@pytest.mark.parametrize("npad,d", [(73728, 64), (1024, 64), (2048, 40)])
@pytest.mark.parametrize("tr", [16, 32, 64, 128, 256])
def test_t2_launch_shape_maps_tr_to_ring_stages(cuda, npad, d, tr):
    """T2's launch is T4's with K4's store: 320-column tiles, TR 32 -> 4
    stages of 32 rows, TR 64 -> 2 of 64, any other TR K4's 5 of 16; 2
    blocks an SM at each."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    shape = mpc.bwd_launch_shape(npad, d, tr)
    want = {32: (32, 4), 64: (64, 2)}.get(tr, (16, 5))
    assert (shape["rows_a_stage"], shape["stages"]) == want
    assert shape["grid_x"] == -(-npad // 320) and shape["d_tiles"] == 1
    assert shape["threads"] == 320 and shape["blocks_per_sm"] == 2
    assert shape == dict(mpc.bwd_launch_shape(npad, d, tr, transposed=True),
                         blocks_per_sm=shape["blocks_per_sm"])
    line = mpc.bwd_launch_line(npad, d, tr, cuda)
    assert f"{want[1]} stages of {want[0]} rows" in line


def test_fused_4d_wrappers_refuse_bad_operands(cuda):
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    p4 = torch.zeros((100, 2, 4, 128), dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(10, dtype=torch.int64, device=cuda)
    x0 = torch.zeros((1024, 64), device=cuda)
    with pytest.raises(ValueError):
        mpc.fused_fwd_4d(p4.float(), rows, x0)
    with pytest.raises(ValueError):
        mpc.fused_fwd_4d(p4, rows, x0[:1000])  # npad
    with pytest.raises(ValueError):
        mpc.fused_fwd_4d(p4, rows, x0, tr=24)  # TR not a multiple of 16
    with pytest.raises(ValueError):
        mpc.fused_bwd_4d(p4, rows, torch.zeros((9, 64), device=cuda))
    with pytest.raises(ValueError):
        bitpack.t1_masked(torch.zeros((512, 128), dtype=torch.int32, device=cuda),
                          torch.zeros(8, 100, device=cuda), 1, 0.3)


def _assert_close_scaled(got, want, rtol=1e-4, atol=1e-5):
    """max |got - want| <= rtol * max |want| + atol, as chip_smoke.py's
    assert_close_scaled: sums of random products whose f32 order differs."""
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()) + atol, err


@pytest.mark.parametrize("n,npad,nj,r,d,tr,dup", [
    (700, 2048, 2, 192, 32, 64, False),   # the JAX tune tool's correctness shape
    (700, 2048, 4, 300, 40, 128, True),   # ragged R, d padded, duplicates
    (3000, 4096, 2, 520, 128, 32, True),  # two feature tiles, TR 32
    (500, 1024, 1, 100, 64, 16, False),   # one slab, smallest TR
])
def test_tune_kernels_match_plain_and_t1_t2(cuda, n, npad, nj, r, d, tr, dup):
    """T3 in both variants against its plain version, bit-equal to each
    other and to T1; T4 against its plain version and T2 transposed, and
    deterministic."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    gen = torch.Generator(device=cuda).manual_seed(n + r + tr)
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    if dup:
        rows[r // 2:] = rows[: r - r // 2]
    x0 = torch.randn((npad, d), generator=gen, device=cuda)
    ct = torch.randn((r, d), generator=gen, device=cuda)
    p4 = mpc.to4d(p, nj)
    before = dict(_build.LAUNCHES)
    fwd = {res: mpt.fwd_tune(p4, rows, x0, tr, res) for res in (False, True)}
    got_t = mpt.bwd_t(p4, rows, ct, tr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["T3"] == before["T3"] + 2
    assert _build.LAUNCHES["T4"] == before["T4"] + 1
    assert fwd[True].shape == (r, d) and got_t.shape == (d, npad)
    _assert_close_scaled(fwd[True], mpt.fwd_tune_plain(p4, rows, x0))
    assert torch.equal(fwd[False], fwd[True])
    assert torch.equal(fwd[False], mpc.fused_fwd_4d(p4, rows, x0, tr))
    _assert_close_scaled(got_t, mpt.bwd_t_plain(p4, rows, ct))
    _assert_close_scaled(got_t, mpc.fused_bwd_4d(p4, rows, ct, tr).T)
    assert torch.equal(got_t, mpt.bwd_t(p4, rows, ct, tr))  # one writer


@pytest.mark.parametrize("n,nj,sub,r,d,tr,dup", [
    (700, 2, 8, 300, 64, 128, True),    # npad 2,048: 6.4 tiles of 320
    (900, 1, 8, 517, 40, 64, False),    # ragged R, d padded, 64-row stages
    (1500, 4, 3, 1000, 128, 32, True),  # npad 1,536, two feature tiles
    (100, 1, 1, 33, 64, 16, True),      # npad 128: one part-full tile
])
def test_t4_is_k4_transposed(cuda, n, nj, sub, r, d, tr, dup):
    """T4 runs K4's body with a transposed store: bit-equal to K4 on the
    same memory, transposed, at an npad that is not a multiple of 320 and
    at every TR (the rows of a ring stage move, the sums do not);
    deterministic; its launch shape maps TR 32 and 64 to stage rows."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    gen = torch.Generator(device=cuda).manual_seed(n + r + tr)
    npad = nj * sub * 128
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    if dup:
        rows[r // 2:] = rows[: r - r // 2].clone()
    ct = torch.randn((r, d), generator=gen, device=cuda).to(torch.bfloat16)
    p4 = mpc.to4d(p, nj)
    shape = mpc.bwd_launch_shape(npad, d, tr, transposed=True)
    assert shape["rows_a_stage"] == (tr if tr in (32, 64) else 16)
    assert shape["grid_x"] == -(-npad // 320) and shape["blocks_per_sm"] == 2
    before = _build.LAUNCHES["T4"]
    got = mpt.bwd_t(p4, rows, ct, tr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["T4"] == before + 1
    assert got.shape == (d, npad)
    assert torch.equal(got, pcache.gather_bwd(p, rows, ct).T)
    assert torch.equal(got, mpt.bwd_t(p4, rows, ct, tr))
    for other in (16, 32, 64, 128):
        assert torch.equal(got, mpt.bwd_t(p4, rows, ct, other)), other


# -- the redesigned forward body of T1/T3: column splits summed in order ----


def _fwd_case(cuda, n, npad, r, d, seed):
    """P (n, npad) bf16, rows with ids outside [0, n) among them, X0 (npad,
    d) bf16, and the plain result with those rows zero."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    bad = torch.tensor([-1, n, n + 7, -n], device=cuda)
    rows[torch.arange(4, device=cuda) * (r // 4)] = bad
    x0 = torch.randn((npad, d), generator=gen, device=cuda).to(torch.bfloat16)
    ok = (rows >= 0) & (rows < n)
    want = mpc.fused_fwd_4d_plain(mpc.to4d(p, 1), rows.clamp(0, n - 1), x0)
    want[~ok] = 0
    return p, rows, x0, want


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tr", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("nj", [1, 2, 4])
def test_fwd_body_matches_plain_at_every_split(cuda, nj, tr, d):
    """T1 and T3's entry (both variants) at S = 1, the chosen S and the largest S
    against the plain version, R not a multiple of TR and ids outside [0, n)
    reading as zeros; one count a call; two launches bit-equal; T3's wrapper
    bit-equal to T1 at the chosen S; T1 against K3 on the same row-major P."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    n, npad, r = 900, 2048, 3 * tr + 5
    p, rows, x0, want = _fwd_case(cuda, n, npad, r, d, nj * 1000 + tr + d)
    p4 = mpc.to4d(p, nj)
    shape = mpc.fwd_launch_shape(r, npad, d, tr)
    chosen = mpc.fwd_splits(r, npad, d, tr)
    assert shape["splits"] == chosen and shape["max_splits"] == npad // 64
    for splits in sorted({1, chosen, shape["max_splits"]}):
        before = dict(_build.LAUNCHES)
        t1 = mpc.fused_fwd_4d(p4, rows, x0, tr, splits)
        t3 = [mpc._fwd_launch("igcn_fused_fwd_tune", "T3", p4, rows, x0, tr, res,
                              splits=splits) for res in (0, 1)]
        torch.cuda.synchronize()
        assert _build.LAUNCHES["T1"] == before["T1"] + 1
        assert _build.LAUNCHES["T3"] == before["T3"] + 2
        assert t1.shape == (r, d)
        _assert_close_scaled(t1, want)
        assert all(torch.equal(t1, got) for got in t3)
        assert torch.equal(t1[~((rows >= 0) & (rows < n))], torch.zeros(4, d, device=cuda))
    t1 = mpc.fused_fwd_4d(p4, rows, x0, tr)
    assert torch.equal(t1, mpc.fused_fwd_4d(p4, rows, x0, tr))
    assert all(torch.equal(mpt.fwd_tune(p4, rows, x0, tr, res), t1)
               for res in (False, True))
    _assert_close_scaled(t1, pcache.gather_fwd(p, rows, x0))


@pytest.mark.parametrize("nj", [4, 2])
def test_tune_rows_are_bit_equal_to_t1(cuda, nj):
    """Every (TR, resident_x0) row of the tune tool's grid, at each of its NJ:
    T3 bit-equal to T1 at that TR, at the default S."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    n, npad, r = 1500, 4096, 700
    p, rows, x0, want = _fwd_case(cuda, n, npad, r, 64, nj)
    p4 = mpc.to4d(p, nj)
    for tr, res in mpt.FWD_GRID:
        t1 = mpc.fused_fwd_4d(p4, rows, x0, tr)
        assert torch.equal(mpt.fwd_tune(p4, rows, x0, tr, res), t1), (tr, res)
        _assert_close_scaled(t1, want)


def test_fwd_splits_fill_the_card_in_one_wave(cuda):
    """S gives several blocks an SM at every TR of the tune tool's sweep, at
    the tool's shape, and never more blocks than one wave holds."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for tr in (128, 64, 32):
        s = mpc.fwd_launch_shape(mpc.R, mpc.NPAD, mpc.D, tr)
        blocks = s["row_blocks"] * s["splits"] * s["d_tiles"]
        assert s["blocks_per_sm"] >= 1 and s["splits"] > 1, s
        assert blocks <= s["blocks_per_sm"] * sms, s
        assert blocks >= sms, s
    assert mpc.fwd_splits(0, 2048, 64, 64) == 1


def test_fwd_wrappers_refuse_bad_splits(cuda):
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    p4 = torch.zeros((100, 2, 4, 128), dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(10, dtype=torch.int64, device=cuda)
    x0 = torch.zeros((1024, 64), device=cuda)
    before = dict(_build.LAUNCHES)
    for splits in (0, 17):  # 1,024 columns: 16 stages
        with pytest.raises(ValueError, match="splits"):
            mpc.fused_fwd_4d(p4, rows, x0, 64, splits)
        with pytest.raises(ValueError, match="splits"):
            mpc._fwd_launch("igcn_fused_fwd_tune", "T3", p4, rows, x0, 64, 1,
                            splits=splits)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("n,dtype,reps,shift", [
    (512, torch.float32, 50, 0),     # the gather tool's cases
    (2048, torch.float32, 50, 0),
    (8192, torch.float32, 50, 0),
    (2048, torch.bfloat16, 50, 0),
    (300, torch.float32, 1000, 0),   # many wraps of every index
    (777, torch.bfloat16, 20, -3 * 777 - 5),  # negative ids wrap as mod N
    (1000, torch.float32, 0, 0),     # no gather: zeros
    (58112, torch.float32, 50, 0),   # one-column stripe at the limit, wrapping
    (1, torch.float32, 7, 0),        # N 1: every read is row 0
    (1, torch.bfloat16, 0, 0),
    (999, torch.float32, 50, 0),     # N not divisible by the row split
    (2047, torch.bfloat16, 2047, 0),  # reps = N: the padded layout off
])
def test_gather_chain_kernel_is_bit_exact(cuda, n, dtype, reps, shift):
    """T5 against its plain version, bit for bit, in one wave of its launch
    plan."""
    from igcn_cf_tpu_torch.tools import microbench_gather as mg

    idx, x = mg.gather_inputs(n, dtype, cuda)
    idx = idx + shift
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = mg.launch_plan(n, dtype, sms, reps)
    assert plan.grid <= sms and plan.padded == (reps < n and n < 58112)
    before = _build.LAUNCHES["T5"]
    got = mg.gather_chain(idx, x, reps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["T5"] == before + 1
    assert got.dtype == dtype and torch.equal(got, mg.gather_chain_plain(idx, x, reps))


@pytest.mark.parametrize("n,dtype,reps", [
    (8192, torch.float32, 50),    # the tool's largest case, sorted
    (4099, torch.bfloat16, 37),   # sorted, with a short last row range
    (999, torch.bfloat16, 31),    # ragged row ranges, runs of 31
    (400, torch.float32, 3),      # up to 128-column stripes
    (600, torch.float32, 700),    # reps > N: wrapping columns
])
def test_gather_chain_is_bit_exact_at_every_plan(cuda, n, dtype, reps):
    """T5 at every stripe width that fits, and with blocks walking several
    work items (plans for 1 and 7 SMs on this card), each with its padded
    runs sorted by bank group and not, bit-equal to its plain version each
    time."""
    from igcn_cf_tpu_torch.tools import microbench_gather as mg

    idx, x = mg.gather_inputs(n, dtype, cuda)
    want = mg.gather_chain_plain(idx, x, reps)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans, w = [mg.launch_plan(n, dtype, 1, reps),
                mg.launch_plan(n, dtype, 7, reps)], 1
    while w <= mg.WIDTH:
        try:
            plans.append(mg.launch_plan(n, dtype, sms, reps, width=w))
        except ValueError:  # no longer fits
            break
        w *= 2
    assert len(plans) > 3
    plans += [plan._replace(sorted=False) for plan in plans if plan.sorted]
    for plan in plans:
        assert torch.equal(mg.gather_chain(idx, x, reps, plan), want), plan


def test_gather_chain_reads_misaligned_views(cuda):
    """x and idx that start 4 bytes into their storage are copied to an
    aligned buffer; the result is the plain version's."""
    from igcn_cf_tpu_torch.tools import microbench_gather as mg

    idx, x = mg.gather_inputs(640, torch.float32, cuda)
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view_as(x)
    ids = torch.empty(idx.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    xs.copy_(x)
    ids = ids.view_as(idx).copy_(idx)
    assert xs.data_ptr() % 16 and ids.data_ptr() % 16
    assert torch.equal(mg.gather_chain(ids, xs, 50), mg.gather_chain_plain(idx, x, 50))


def test_tune_and_gather_wrappers_refuse_bad_operands(cuda):
    from igcn_cf_tpu_torch.tools import microbench_gather as mg
    from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt

    p4 = torch.zeros((100, 2, 4, 128), dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(10, dtype=torch.int64, device=cuda)
    x0 = torch.zeros((1024, 64), device=cuda)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        mpt.fwd_tune(p4, rows, x0, tr=24, resident_x0=True)  # TR
    with pytest.raises(ValueError):
        mpt.fwd_tune(p4, rows, x0[:1000])  # npad
    with pytest.raises(ValueError):
        mpt.bwd_t(p4, rows, torch.zeros((9, 64), device=cuda))  # R
    idx, x = mg.gather_inputs(58113, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mg.gather_chain(idx, x)  # a one-column stripe is 232,452 bytes
    idx, x = mg.gather_inputs(64, torch.float32, cuda)
    with pytest.raises(ValueError):
        mg.gather_chain(idx.long(), x)
    with pytest.raises(ValueError):
        mg.gather_chain(idx, x.double())
    with pytest.raises(ValueError, match="reps"):
        mg.gather_chain(idx, x, -1)
    with pytest.raises(ValueError, match="shared memory"):
        mg.launch_plan(8192, torch.float32, 132, width=8)
    bad = mg.launch_plan(64, torch.float32, 132)._replace(row_ranges=1,
                                                          rows_per_range=32)
    with pytest.raises(RuntimeError, match="igcn_gather_chain"):
        mg.gather_chain(idx, x, 50, bad)  # rows 32-63 left out: refused
    assert _build.LAUNCHES == before


# -- the propagation cache's pair: K4's 320-column body, K3 as T1's body at
#    TR 128 ---------------------------------------------------------------------


def _pcache_case(cuda, n, npad, r, d, dup, seed):
    """P (n, npad) bf16 (npad a multiple of 64), rows with four ids outside
    [0, n) and, with ``dup``, every id at least twice, and the same rows
    clamped into range with a mask of the bad ones."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = torch.randn((n, npad), generator=gen, device=cuda).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=gen, device=cuda)
    if dup:
        rows[r // 2:] = rows[: r - r // 2].clone()
    rows[torch.arange(4, device=cuda) * (r // 4)] = torch.tensor(
        [-1, n, n + 7, -n], device=cuda)
    ok = (rows >= 0) & (rows < n)
    return p, rows, rows.clamp(0, n - 1), ok


@pytest.mark.parametrize("n,npad,r,d,dup", [
    (700, 704, 300, 64, True),      # npad 11 x 64: a part-full last tile
    (900, 1024, 517, 40, False),    # ragged R, d padded to the tile
    (1500, 1600, 1000, 128, True),  # two feature tiles, npad 25 x 64
    (300, 320, 33, 64, True),       # one stage and a row
])
def test_gather_bwd_matches_plain(cuda, n, npad, r, d, dup):
    """K4 against the plain version, ids outside [0, n) reading as zeros and
    duplicate ids summing; its launch shape; one count a call; two launches
    bit-equal."""
    p, rows, clamped, ok = _pcache_case(cuda, n, npad, r, d, dup, n + r + d)
    ctb = torch.randn((r, d), device=cuda).to(torch.bfloat16)
    want = pcache.gather_bwd_plain(p, clamped, ctb * ok[:, None])
    shape = pcache.gather_launch_shape("K4", r, npad, d)
    assert shape["grid_x"] == -(-npad // 320) and shape["d_tiles"] == -(-d // 64)
    before = _build.LAUNCHES["K4"]
    got = pcache.gather_bwd(p, rows, ctb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K4"] == before + 1
    assert got.shape == (npad, d)
    torch.testing.assert_close(got, want, **GATHER_TOL)
    assert torch.equal(got, pcache.gather_bwd(p, rows, ctb))


def test_gather_bwd_is_bit_equal_at_the_training_rows(cuda):
    """Two K4 launches at R = 6,144 (the training slice's 3 x 2048 rows,
    repeats included) are bit-equal."""
    p, rows = _gather_case(cuda, 8000, 6144, True)
    ctb = torch.randn((6144, 64), device=cuda).to(torch.bfloat16)
    got = pcache.gather_bwd(p, rows, ctb)
    assert torch.equal(got, pcache.gather_bwd(p, rows, ctb))
    torch.testing.assert_close(got, pcache.gather_bwd_plain(p, rows, ctb),
                               **GATHER_TOL)


def test_gather_bwd_reads_a_misaligned_int32_view(cuda):
    """An int32 rows view that starts 4 bytes into its storage (K4 copies
    ids 16 bytes at a time) gives the aligned result."""
    p, rows = _gather_case(cuda, 900, 302, True)
    ctb = torch.randn((301, 64), device=cuda).to(torch.bfloat16)
    view = rows.to(torch.int32)[1:]
    assert view.data_ptr() % 16
    torch.testing.assert_close(pcache.gather_bwd(p, view, ctb),
                               pcache.gather_bwd_plain(p, view, ctb), **GATHER_TOL)
    assert torch.equal(pcache.gather_bwd(p, view, ctb),
                       pcache.gather_bwd(p, view.clone(), ctb))


@pytest.mark.parametrize("nj", [1, 2, 4])
def test_k3_is_bit_equal_to_t1_at_tr128(cuda, nj):
    """K3 runs T1's body at TR 128 with T1's S: bit-equal to T1 on the 4-D
    view of the same row-major P, ids outside [0, n) included."""
    from igcn_cf_tpu_torch.tools import microbench_pcache as mpc

    n, npad, r = 900, 2048, 3 * 128 + 5
    p, rows, _, _ = _pcache_case(cuda, n, npad, r, 64, True, nj)
    x0b = torch.randn((npad, 64), device=cuda).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    got = pcache.gather_fwd(p, rows, x0b)
    t1 = mpc.fused_fwd_4d(mpc.to4d(p, nj), rows, x0b, 128)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K3"] == before["K3"] + 1
    assert _build.LAUNCHES["T1"] == before["T1"] + 1
    assert torch.equal(got, t1)
    k3, t1_shape = (pcache.gather_launch_shape("K3", r, npad, 64),
                    mpc.fwd_launch_shape(r, npad, 64, 128))
    assert list(k3.values()) == list(t1_shape.values())


@pytest.mark.parametrize("n,npad,r,d", [
    (700, 704, 300, 40),   # npad 11 x 64, d padded
    (300, 320, 129, 64),   # npad 5 x 64, one row past a block
    (1500, 1600, 700, 128),
])
def test_k3_matches_plain_at_npad_not_a_multiple_of_128(cuda, n, npad, r, d):
    """K3 where the 4-D entries refuse npad (not a multiple of 128), at its
    chosen S, ids outside [0, n) reading as zeros; one count a call."""
    p, rows, clamped, ok = _pcache_case(cuda, n, npad, r, d, False, n + d)
    x0b = torch.randn((npad, d), device=cuda).to(torch.bfloat16)
    want = pcache.gather_fwd_plain(p, clamped, x0b) * ok[:, None]
    shape = pcache.gather_launch_shape("K3", r, npad, d)
    assert 1 <= shape["splits"] <= shape["max_splits"] == npad // 64
    before = _build.LAUNCHES["K3"]
    got = pcache.gather_fwd(p, rows, x0b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K3"] == before + 1
    assert got.shape == (r, d)
    _assert_close_scaled(got, want)
    assert torch.equal(got[~ok], torch.zeros((4, d), device=cuda))


def test_gather_pair_fills_the_card_at_the_training_slice(cuda):
    """At R = 6,144 and npad = 70,912 (d = 64) K4's grid fits the card in
    one wave, and K3's S fills it as T1's does."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k4 = pcache.gather_launch_shape("K4", 6144, 70912, 64)
    assert k4["grid_x"] == -(-70912 // 320), k4  # 320 columns a block
    assert k4["d_tiles"] == 1 and k4["grid_x"] <= k4["blocks_per_sm"] * sms, k4
    k3 = pcache.gather_launch_shape("K3", 6144, 70912, 64)
    blocks = k3["grid_x"] * k3["splits"] * k3["d_tiles"]
    assert sms <= blocks <= k3["blocks_per_sm"] * sms, k3


# -- the redesigned bodies: t2 (row chunks, summed in order) and t1 (16-byte
#    word and X1 loads, lane groups) at ragged shapes ----------------------

# entry -> (kernel, plain, X rows "K" (B @ X) or "m" (B^T @ X), masked), as
# chip_smoke.py holds them
PAIR_ENTRIES = chip_smoke.pair_entries()
UNMASKED = {"K1m": "K1", "K2m": "K2", "K6m": "K6", "K7m": "K7"}
MASK_SEED, MASK_P = 2**32 - 5, 0.3


def _sparse_words(seed, m, kw, live, device):
    """(m, kw) int32 words from numpy: a share ``live`` of the words hold
    1-32 random set bits (high bits included), the rest are zero."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (m, kw), dtype=np.uint64)
    words &= rng.integers(0, 2**32, (m, kw), dtype=np.uint64)  # ~8 bits
    words[rng.random((m, kw)) >= live] = 0
    return torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(device)


def _run_entry(name, wp, d, cuda, seed=0):
    kern, plain, rows, masked = PAIR_ENTRIES[name]
    m, kw = wp.shape
    gen = torch.Generator(device=cuda).manual_seed(seed + d)
    x = torch.randn((kw * 32 if rows == "K" else m, d), generator=gen, device=cuda)
    mask = (MASK_SEED, MASK_P) if masked else ()
    return kern(wp, x, *mask), plain(wp, x, *mask), x


@pytest.mark.parametrize("d", [1, 33, 64, 128, 256])
@pytest.mark.parametrize("m,kw,live", [
    (1000, 128, 0.02),  # 8 row chunks, the last one short
    (700, 256, 0.02),   # 6 chunks, two column tiles
    (100, 128, 0.1),    # one chunk: t2 writes y directly
])
@pytest.mark.parametrize("name", list(PAIR_ENTRIES))
def test_pair_bodies_match_plain_at_ragged_shapes(cuda, name, m, kw, live, d):
    """All eight entries against their plain versions where one word
    column's set bits fall in several row chunks and m is not a multiple of
    a chunk. (kw is a multiple of the layout's 128-word tile, so of a
    block's words too: the wrappers refuse any other kw.)"""
    wp = _sparse_words(m * kw, m, kw, live, cuda)
    before = _build.LAUNCHES[name]
    got, want, _ = _run_entry(name, wp, d, cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_t2_splits_cover_the_test_shapes(cuda):
    """The ragged cases above do cross chunk boundaries, and the small one
    has a single chunk."""
    for d in (1, 33, 64, 128, 256):
        assert bitpack.t2_splits(1000, 128, d) > 1
        assert bitpack.t2_splits(700, 256, d) > 1
        assert bitpack.t2_splits(100, 128, d) == 1
    assert bitpack.t2_splits(0, 128, 64) == bitpack.t2_splits(64, 0, 64) == 1


@pytest.mark.parametrize("m,kw", [(0, 128), (300, 0), (0, 0)])
@pytest.mark.parametrize("name", list(PAIR_ENTRIES))
def test_pair_bodies_take_empty_operands(cuda, name, m, kw):
    """m = 0 and kw = 0: outputs of the right shape, zeros where they have
    any element."""
    wp = torch.zeros((m, kw), dtype=torch.int32, device=cuda)
    got, want, _ = _run_entry(name, wp, 64, cuda)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("name", ["K2", "K2m", "K7", "K7m"])
def test_t2_entries_are_deterministic_across_chunks(cuda, name):
    """Two launches of every t2 entry at a shape with several row chunks are
    bit-equal."""
    wp = _sparse_words(7, 3000, 128, 0.05, cuda)
    assert bitpack.t2_splits(3000, 128, 64) > 1
    a, _, x = _run_entry(name, wp, 64, cuda)
    kern, _, _, masked = PAIR_ENTRIES[name]
    b = kern(wp, x, *((MASK_SEED, MASK_P) if masked else ()))
    assert torch.equal(a, b)


@pytest.mark.parametrize("d", [33, 64, 128])
@pytest.mark.parametrize("m,kw", [(1000, 128), (700, 256)])
@pytest.mark.parametrize("name", list(UNMASKED))
def test_masked_bodies_equal_unmasked_over_mask_words(cuda, name, m, kw, d):
    """K1m/K2m/K6m/K7m bit-equal to K1/K2/K6/K7 over mask_words' copy of B,
    at ragged shapes and across row chunks."""
    wp = _sparse_words(m + kw, m, kw, 0.05, cuda)
    got, _, x = _run_entry(name, wp, d, cuda)
    unmasked = PAIR_ENTRIES[UNMASKED[name]][0]
    want = unmasked(bitpack.mask_words(wp, MASK_SEED, MASK_P), x)
    assert torch.equal(got, want)
    assert not torch.equal(got, unmasked(wp, x))  # it drops


@pytest.mark.parametrize("d", [8, 64, 256])
@pytest.mark.parametrize("name", ["K1", "K6", "K1m", "K6m"])
def test_t1_rows_with_0_1_and_many_bits_in_one_step(cuda, name, d):
    """Rows whose 128-word step holds no set bit, one, a few in one word and
    one lane, and more than the lane groups take in one round (several
    rounds, words of several lanes, bits up to 31), against the plain
    versions."""
    kw = 256
    words = np.zeros((6, kw), np.uint64)
    words[1, 5] = 1 << 31                                  # one bit
    words[2, 4] = 0b1011                                    # 3 bits, one word
    words[2, 7] = 1 << 17                                   # and one lane over
    words[3, [0, 1, 2, 3, 50, 127]] = 0xF0F0F0F1            # 6 x 13 bits
    words[4, 128:256:3] = 0xFFFFFFFF                        # dense second step
    words[5, [3, 130]] = [1 << 9, 1 << 30]                  # one in each step
    wp = torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(cuda)
    kern, plain, _, masked = PAIR_ENTRIES[name]
    x = torch.randn((kw * 32, d), device=cuda)
    mask = (MASK_SEED, 0.0) if masked else ()  # p = 0 keeps every edge
    got, want = kern(wp, x, *mask), plain(wp, x, *mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("name", list(PAIR_ENTRIES))
def test_pair_bodies_read_a_misaligned_view(cuda, name):
    """B given as a contiguous view that starts 4 bytes into a 16-byte
    vector: the bodies load its words one by one, with the same sums in the
    same order as over an aligned copy."""
    wp = _sparse_words(11, 500, 128, 0.05, cuda)
    flat = torch.empty(wp.numel() + 1, dtype=torch.int32, device=cuda)
    view = flat[1:].view(wp.shape)
    view.copy_(wp)
    assert view.data_ptr() % 16
    got, _, x = _run_entry(name, view, 64, cuda)
    kern, _, _, masked = PAIR_ENTRIES[name]
    assert torch.equal(got, kern(wp, x, *((MASK_SEED, MASK_P) if masked else ())))


def test_pair_wrappers_refuse_words_outside_the_layout(cuda):
    """kw not a multiple of 128 would put columns past 32 * kw."""
    wp = torch.zeros((64, 100), dtype=torch.int32, device=cuda)
    for fn, x in ((bitpack.t1, torch.zeros(8, 3200, device=cuda)),
                  (bitpack.t2, torch.zeros(8, 64, device=cuda)),
                  (bitpack.mm_fwd, torch.zeros(3200, 8, device=cuda)),
                  (bitpack.mm_bwd, torch.zeros(64, 8, device=cuda))):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(wp, x)


@pytest.mark.parametrize("name", ["K1m", "K6m"])
def test_masked_t1_is_bit_equal_on_rows_past_one_list(cuda, name):
    """Rows with more set bits than the t1 body lists at once (256): the
    masked body lists the undropped edges and drops them at each gather,
    the unmasked body over mask_words' copy lists only the kept ones, and
    both give every kept edge the same lane group and order."""
    rng = np.random.default_rng(12)
    words = np.zeros((8, 256), np.uint64)
    words[0] = 0xFFFFFFFF                                      # 8,192 bits
    words[1, ::2] = rng.integers(0, 2**32, 128, dtype=np.uint64)  # ~2,048
    words[2, :40] = 0x0F0F0F0F                                 # 640
    words[3, 7] = 1                                            # one
    wp = torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(cuda)
    got, _, x = _run_entry(name, wp, 64, cuda)
    unmasked = PAIR_ENTRIES[UNMASKED[name]][0]
    assert torch.equal(got, unmasked(bitpack.mask_words(wp, MASK_SEED, MASK_P), x))


def test_take_rows_gradient_is_deterministic(cuda):
    """The batch-row gather's gradient is bit-equal over two calls with
    heavy duplicates (each of 512 rows taken ~64 times), and equals the
    CPU's within f32 rounding."""
    from igcn_cf_tpu_torch.models.base import take_rows

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(512, 64, generator=gen)
    idx = torch.randint(0, 512, (3 * 2048, 5), generator=gen)[:, 0]
    ct = torch.randn(idx.shape[0], 64, generator=gen)
    xc = x.to(cuda).requires_grad_()
    grads = [torch.autograd.grad(take_rows(xc, idx.to(cuda)), xc, ct.to(cuda))[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(take_rows(xc, idx.to(cuda)).detach().cpu(), x[idx])
    xh = x.clone().requires_grad_()
    want = torch.autograd.grad(take_rows(xh, idx), xh, ct)[0]
    torch.testing.assert_close(grads[0].cpu(), want, rtol=1e-5, atol=1e-5)


# -- the multi-device layer's shapes on the card ----------------------------------


@pytest.mark.parametrize("n,width,rps,r,d", [
    (17709, 12288, 8856, 6144, 64),   # the quarter catalog's slab at table 2
    (70839, 40960, 35424, 6144, 64),  # the Gowalla slice's slab at table 2
    (5000, 4096, 1256, 300, 40),      # table 4, d not a multiple of 64
])
def test_gather_kernels_on_a_narrow_slab(cuda, n, width, rps, r, d):
    """K3/K4 on a sharded cache's column slab (fewer columns than rows),
    against their plain versions; K4 bit-equal over two launches; and
    cached_prop, which zero-pads X0's rps rows to the slab's width and
    returns dX0 for those rows."""
    g = torch.Generator(device=cuda).manual_seed(n)
    p = (torch.rand((n, width), generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    rows = torch.randint(0, n, (r,), generator=g, device=cuda)
    x0b = torch.randn((width, d), generator=g, device=cuda).to(torch.bfloat16)
    ctb = torch.randn((r, d), generator=g, device=cuda).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    fwd, bwd = pcache.gather_fwd(p, rows, x0b), pcache.gather_bwd(p, rows, ctb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K3"] == before["K3"] + 1
    assert _build.LAUNCHES["K4"] == before["K4"] + 1
    torch.testing.assert_close(fwd, pcache.gather_fwd_plain(p, rows, x0b),
                               **GATHER_TOL)
    torch.testing.assert_close(bwd, pcache.gather_bwd_plain(p, rows, ctb),
                               **GATHER_TOL)
    assert torch.equal(bwd, pcache.gather_bwd(p, rows, ctb))
    x0 = torch.randn((rps, d), generator=g, device=cuda, requires_grad=True)
    ct = torch.randn((r, d), generator=g, device=cuda)
    y = pcache.cached_prop(p, rows, x0)
    y.backward(ct)
    pad = torch.zeros((width, d), device=cuda)
    pad[:rps] = x0.detach()
    torch.testing.assert_close(
        y, pcache.gather_fwd_plain(p, rows, pad.to(torch.bfloat16)),
        **GATHER_TOL)
    torch.testing.assert_close(
        x0.grad, pcache.gather_bwd_plain(p, rows, ct.to(torch.bfloat16))[:rps],
        **GATHER_TOL)


@pytest.mark.parametrize("t", [0, 1])
def test_fused_topk_on_an_offset_item_block(cuda, t):
    """K5 over table rank t's item block of the sharded evaluator (offset
    t * ceil(n_items / 2), the last block short, exclusion words packed for
    the block, banned items and the padding at NEG) against its plain
    version; then the merge's scores (``parallel/eval.k5_scores``, K5's
    FMA order) of the ids it returned against the plain scores."""
    from igcn_cf_tpu_torch.core.mesh import Mesh
    from igcn_cf_tpu_torch.parallel.eval import ItemBlock, k5_scores

    g = torch.Generator(device=cuda).manual_seed(t)
    n_users, n_items = 4096, 10245
    users = torch.randn((n_users, 64), generator=g, device=cuda)
    items = torch.randn((n_items, 64), generator=g, device=cuda)
    mesh = Mesh(1, 2, 0, t, cuda, "nccl", None, None)
    block = ItemBlock.from_reps(items, n_items, mesh)
    assert block.offset == t * 5123 and block.n_real == (5123, 5122)[t]
    rng = np.random.default_rng(t)
    words = block.exclusion_words(rng.integers(0, n_users, 60000),
                                  rng.integers(0, n_items, 60000), n_users)
    banned = block.with_banned(np.arange(0, n_items, 7))
    before = dict(_build.LAUNCHES)
    got = retrieval.fused_topk_ids(users, block.items_t, words, banned, k=20)
    want = retrieval.fused_topk_ids_plain(users, block.items_t, words, banned,
                                          k=20)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K5"] == before["K5"] + 1
    scores = chip_smoke.plain_scores(users, block.items_t, words, banned,
                                     retrieval.LI)
    chip_smoke.topk_agree(got, want, scores, chip_smoke.TOPK_RTOL)
    ids = got.long()
    merged = k5_scores(users, block.items_t, ids) + banned[0][ids]
    torch.testing.assert_close(merged, torch.gather(users @ block.items_t, 1, ids)
                               + banned[0][ids], rtol=1e-5, atol=1e-5)
