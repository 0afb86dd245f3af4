"""The port's retrieval layer against the JAX package: exclusion packing
bit-exact (host and device), and the plain ``fused_topk_ids`` giving the
JAX kernel's ids (interpret mode) on dyadic and tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.retrieval as jret
from igcn_cf_tpu_torch.kernels import retrieval
from igcn_cf_tpu_torch.kernels.retrieval import NEG
from torch_threads import one_thread  # noqa: F401


def test_constants_match_jax():
    assert (retrieval.BU, retrieval.LI, retrieval.KPAD, retrieval.NEG) == (
        jret.BU, jret.LI, jret.KPAD, jret.NEG)


def _lists(rng, n_users, n_items, max_len=20, dups=False):
    out = []
    for _ in range(n_users):
        items = list(rng.choice(n_items, size=rng.integers(0, max_len),
                                replace=False))
        if dups and items:
            items += items[: len(items) // 2 + 1]
        out.append(items)
    return out


@pytest.mark.parametrize("n_users,n_items,nip,li", [
    (70, 300, 384, 128), (150, 1000, 1024, 256), (40, 5000, 8192, None),
])
def test_pack_exclusion_words_identical_to_jax(rng, n_users, n_items, nip, li):
    lists = _lists(rng, n_users, n_items)
    got = retrieval.pack_exclusion_words(lists, n_users, n_items, nip, li=li,
                                         user_chunk=32)
    want = jret.pack_exclusion_words(lists, n_users, n_items, nip, li=li)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("n_users,n_items,nip,li", [
    (8, 300, 384, 128), (150, 1000, 1024, 256), (40, 5000, 8192, None),
])
def test_pack_exclusion_words_device_identical_to_jax(rng, n_users, n_items,
                                                      nip, li):
    """Repeated (user, item) pairs pack like unique ones (the scatter adds
    powers of two, so the packer must deduplicate)."""
    lists = _lists(rng, n_users, n_items, dups=True)
    rows = np.concatenate([np.full(len(x), u) for u, x in enumerate(lists)])
    cols = np.concatenate([np.asarray(x, np.int64) for x in lists])
    got = retrieval.pack_exclusion_words_device(rows, cols, n_users, nip, li=li,
                                                device="cpu")
    want = jret.pack_exclusion_words_device(rows.astype(np.int32),
                                            cols.astype(np.int32), n_users,
                                            nip, li=li)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    host = retrieval.pack_exclusion_words(lists, n_users, n_items, nip, li=li)
    np.testing.assert_array_equal(got.numpy(), host)
    unpacked = retrieval.unpack_exclusion(got, li)
    for u, items in enumerate(lists):
        assert set(torch.nonzero(unpacked[u]).flatten().tolist()) == set(items)


def test_pack_exclusion_words_device_refuses_bad_ids():
    with pytest.raises(ValueError):
        retrieval.pack_exclusion_words_device([0, 3], [1, 2], 3, 128, li=128, device="cpu")
    with pytest.raises(ValueError):
        retrieval.pack_exclusion_words_device([0], [128], 3, 128, li=128, device="cpu")
    with pytest.raises(ValueError):
        retrieval.pack_exclusion_words_device([0], [1], 3, 200, li=128, device="cpu")


def _case(rng, n_users, n_items, d, nup, nip, li, dyadic):
    ur = rng.normal(size=(nup, d)).astype(np.float32)
    it = rng.normal(size=(d, nip)).astype(np.float32)
    if dyadic:  # multiples of 1/8: every f32 dot is exact, ties abound
        ur, it = np.round(ur * 8) / 8, np.round(it * 8) / 8
    it[:, n_items:] = 0.0
    excl = _lists(rng, n_users, n_items) + [[] for _ in range(nup - n_users)]
    words = retrieval.pack_exclusion_words(excl, nup, n_items, nip, li=li)
    return ur, it, words


def _both(ur, it, words, banned, k, bu, li):
    got = retrieval.fused_topk_ids(
        torch.as_tensor(ur), torch.as_tensor(it), torch.as_tensor(words),
        torch.as_tensor(banned), k=k, li=li)
    want = jret.fused_topk_ids(
        jnp.asarray(ur), jnp.asarray(it), jnp.asarray(words.view(np.uint32)),
        jnp.asarray(banned), k=k, interpret=True, bu=bu, li=li)
    assert got.dtype == torch.int32 and got.shape == (ur.shape[0], k)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dyadic", [True, False])
def test_fused_topk_matches_jax_single_chunk_with_banned(dyadic):
    """tests/test_retrieval.py::test_fused_topk_matches_oracle's case."""
    rng = np.random.default_rng(0)
    n_users, n_items, d, k, bu, li, nup, nip = 70, 300, 16, 10, 32, 128, 96, 384
    ur, it, words = _case(rng, n_users, n_items, d, nup, nip, li, dyadic)
    banned = np.zeros((1, nip), np.float32)
    banned[0, rng.choice(n_items, size=15, replace=False)] = NEG
    banned[0, n_items:] = NEG
    got, want = _both(ur, it, words, banned, k, bu, li)
    np.testing.assert_array_equal(got[:n_users], want[:n_users])


@pytest.mark.parametrize("dyadic", [True, False])
def test_fused_topk_matches_jax_multi_chunk_and_blocks(dyadic):
    """tests/test_retrieval.py::test_fused_topk_multi_chunk_and_blocks."""
    rng = np.random.default_rng(3)
    n_users, n_items, d, k, bu, li, nup, nip = 150, 1000, 8, 7, 64, 256, 192, 1024
    ur, it, words = _case(rng, n_users, n_items, d, nup, nip, li, dyadic)
    banned = np.zeros((1, nip), np.float32)
    banned[0, n_items:] = NEG
    got, want = _both(ur, it, words, banned, k, bu, li)
    np.testing.assert_array_equal(got[:n_users], want[:n_users])


@pytest.mark.parametrize("field", ["constant", "bf16"])
def test_fused_topk_matches_jax_adversarial_ties(field):
    """tests/test_retrieval.py::test_fused_topk_adversarial_ties: equal
    scores resolve lowest-item-id-first across chunk boundaries."""
    bu, li, k = 32, 128, 10
    n_users, n_items, d, nup, nip = 40, 1000, 4, 64, 1024
    rng = np.random.default_rng(17)
    if field == "constant":
        it_row = np.full((nip,), 0.5, np.float32)
    else:
        vals = rng.uniform(0.1, 1.0, size=nip).astype(np.float32)
        it_row = vals.astype(jnp.bfloat16).astype(np.float32)
    ur = np.ones((nup, d), np.float32) / d
    it = np.broadcast_to(it_row, (d, nip)).astype(np.float32).copy()
    it[:, n_items:] = 0.0
    words = retrieval.pack_exclusion_words([[]] * nup, nup, n_items, nip, li=li)
    banned = np.zeros((1, nip), np.float32)
    banned[0, n_items:] = NEG
    got, want = _both(ur, it, words, banned, k, bu, li)
    np.testing.assert_array_equal(got[:n_users], want[:n_users])
    scores = (ur @ it).astype(np.float32)
    scores[:, n_items:] = -np.inf
    stable = np.argsort(-scores, axis=1, kind="stable")[:n_users, :k]
    np.testing.assert_array_equal(got[:n_users], stable)


@pytest.mark.parametrize("k", [20, 33])
def test_fused_topk_matches_jax_with_fewer_allowed_items_than_k(k):
    """Row 0 may take 3 items (one of them banned), row 1 none. Every other
    row equals the JAX kernel's; rows 0 and 1 begin with its allowed items,
    then hold the NEG-scored items lowest id first, the plain version's
    stable order, which K5 keeps across its item tiles and ranges. There
    the JAX kernel repeats id 0 (its merge evicts a winner by writing NEG,
    the score those items already have): a fault of the reference that the
    port does not copy. k 20 and 33 lie on either side of K5's 32-entry
    lists."""
    rng = np.random.default_rng(k)
    n_users, n_items, d, bu, li, nup, nip = 40, 300, 8, 32, 128, 64, 384
    ur, it, _ = _case(rng, n_users, n_items, d, nup, nip, li, dyadic=True)
    allowed = [5, 150, 299]
    excl = _lists(rng, n_users, n_items) + [[] for _ in range(nup - n_users)]
    excl[0] = [c for c in range(n_items) if c not in allowed]
    excl[1] = list(range(n_items))
    words = retrieval.pack_exclusion_words(excl, nup, n_items, nip, li=li)
    banned = np.zeros((1, nip), np.float32)
    banned[0, n_items:] = NEG
    banned[0, 150] = NEG
    got, want = _both(ur, it, words, banned, k, bu, li)
    np.testing.assert_array_equal(got[2:n_users], want[2:n_users])
    np.testing.assert_array_equal(got[0, :2], want[0, :2])
    assert sorted(want[0, :2]) == [5, 299]
    tail = [c for c in range(nip) if c not in (5, 299)]
    assert got[0].tolist() == want[0, :2].tolist() + tail[:k - 2]
    assert got[1].tolist() == list(range(k))


def test_fused_topk_refuses_bad_arguments():
    ur = torch.zeros((4, 8))
    it = torch.zeros((8, 256))
    excl = torch.zeros((4, 8), dtype=torch.int32)
    banned = torch.zeros((1, 256))
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it, excl, banned, k=129, li=128)
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it, excl, banned, k=5)  # 256 % LI
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it, excl[:, :4], banned, k=5, li=128)
    with pytest.raises(ValueError):
        retrieval.fused_topk_ids(ur, it[:4], excl, banned, k=5, li=128)
