"""The port's data loaders against the JAX package: the reference text
format written byte for byte, processed splits read identically, tiny raw
dumps (Gowalla, Yelp, Amazon) parsed into identical datasets, temporal and
shuffled, ``process`` writing identical split trees, the native k-core and
dedupe kernels, and the evaluator's caches that ``with_splits`` carries."""

import json
import time

import numpy as np
import pytest
import torch

from igcn_cf_tpu import native as jax_native
from igcn_cf_tpu.cli.main import build_parser as jax_build_parser
from igcn_cf_tpu.core.prng import set_seed as jax_set_seed
from igcn_cf_tpu.data.dataset import get_dataset as jax_get_dataset
from igcn_cf_tpu.data.synthetic import synthetic_interactions as jax_synthetic
from igcn_cf_tpu_torch import native
from igcn_cf_tpu_torch.cli.main import main
from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.dataset import get_dataset
from igcn_cf_tpu_torch.data.loaders import split_interactions
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.evaluation.evaluate import evaluate, recommend
from igcn_cf_tpu_torch.evaluation.metrics import calculate_metrics
from igcn_cf_tpu_torch.models.base import get_model
from torch_threads import one_thread  # noqa: F401

SYNTH = dict(n_users=70, n_items=90, avg_degree=14, seed=5)
RAW_FILES = {"Gowalla": "Gowalla_totalCheckins.txt",
             "Yelp": "yelp_academic_dataset_review.json",
             "Amazon": "ratings_Books.csv"}
SPLIT = [0.7, 0.1, 0.2]


def _same_dataset(a, b):
    assert (a.name, a.n_users, a.n_items, a.neg_ratio) == (
        b.name, b.n_users, b.n_items, b.neg_ratio)
    assert a.train == b.train and a.val == b.val and a.test == b.test
    np.testing.assert_array_equal(a.train_array, b.train_array)
    assert a.train_array.dtype == b.train_array.dtype == np.int64


def _tree_bytes(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.txt"))}


# -- the reference text format ---------------------------------------------------


def test_output_writes_the_jax_bytes(tmp_path):
    synthetic_interactions(**SYNTH).output(str(tmp_path / "port"))
    jax_synthetic(**SYNTH).output(str(tmp_path / "jax"))
    port, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(port) == ["test.txt", "train.txt", "val.txt"]
    assert port == want


def test_load_processed_of_a_jax_written_dataset(tmp_path):
    path = str(tmp_path / "Gowalla" / "1")
    jax_synthetic(**SYNTH).output(path)
    for config in ({"name": "ProcessedDataset", "path": path},
                   {"name": "ProcessedDataset", "path": path,
                    "dataset_name": "Gowalla", "neg_ratio": 3}):
        got, want = get_dataset(config), jax_get_dataset(config)
        _same_dataset(got, want)
        for a, b in zip(got.train_csr(), want.train_csr()):
            np.testing.assert_array_equal(a, b)
    assert got.name == "Gowalla" and got.neg_ratio == 3


# -- raw dumps -------------------------------------------------------------------


def _raw_records(seed, n_users=40, n_items=30):
    """(user, item, unix time) records: a dense block that survives the
    10-core, users and items with a few interactions that the peel drops,
    and repeated pairs with later and earlier timestamps."""
    rng = np.random.default_rng(seed)
    recs = []
    for u in range(n_users):
        for i in rng.choice(n_items, size=rng.integers(12, 22), replace=False):
            recs.append((u, int(i), int(rng.integers(1.3e9, 1.4e9))))
    for u in range(n_users, n_users + 4):  # sparse users
        for i in rng.choice(n_items, size=3, replace=False):
            recs.append((u, int(i), int(rng.integers(1.3e9, 1.4e9))))
    for i in range(n_items, n_items + 3):  # sparse items
        for u in rng.choice(n_users, size=4, replace=False):
            recs.append((int(u), i, int(rng.integers(1.3e9, 1.4e9))))
    for k in rng.choice(len(recs), size=40, replace=False):  # duplicates
        u, i, t = recs[k]
        recs.append((u, i, t + int(rng.integers(-1e6, 1e6))))
    order = rng.permutation(len(recs))
    return [recs[k] for k in order]


def _write_raw(root, name, seed):
    """The dataset's raw dump under ``root/name`` in its own format, with
    low ratings (dropped by the parser) among the kept ones."""
    rng = np.random.default_rng(seed + 1)
    base = root / name
    base.mkdir(parents=True)
    lines = []
    for u, i, t in _raw_records(seed):
        stamp = time.localtime(t)
        if name == "Gowalla":
            lines.append(f"{u}\t{time.strftime('%Y-%m-%dT%H:%M:%SZ', stamp)}"
                         f"\t30.2\t-97.7\t{i}")
            continue
        stars = float(rng.choice([2.0, 4.0, 5.0], p=[0.1, 0.45, 0.45]))
        if name == "Yelp":
            lines.append(json.dumps({
                "user_id": f"user-{u}", "business_id": f"biz-{i}",
                "stars": stars,
                "date": time.strftime("%Y-%m-%d %H:%M:%S", stamp)}))
        else:
            lines.append(f"A{u:05d},B{i:04d},{stars},{t}")
    (base / RAW_FILES[name]).write_text("\n".join(lines) + "\n")
    return base


@pytest.mark.parametrize("name", sorted(RAW_FILES))
@pytest.mark.parametrize("shuffle", [False, True], ids=["temporal", "shuffled"])
def test_raw_dumps_parse_as_in_jax(tmp_path, name, shuffle):
    base = _write_raw(tmp_path, name, seed=len(name))
    config = {"name": name + "Dataset", "path": str(base),
              "split_ratio": SPLIT, "min_inter": 10, "shuffle": shuffle}
    set_seed(11)
    got = get_dataset(config)
    jax_set_seed(11)
    want = jax_get_dataset(config)
    _same_dataset(got, want)
    # the peel dropped the sparse nodes, and every survivor has 10 or more
    assert 0 < got.n_users < 44 and 0 < got.n_items < 33
    deg_u = [len(a) + len(b) + len(c)
             for a, b, c in zip(got.train, got.val, got.test)]
    assert min(deg_u) >= 10


def test_split_interactions_shuffles_with_numpys_global_rng():
    inter = [[[i, 100 - i] for i in range(20)] for _ in range(3)]
    set_seed(5)
    a = split_interactions(inter, 3, 20, SPLIT, shuffle=True)
    set_seed(5)
    b = split_interactions(inter, 3, 20, SPLIT, shuffle=True)
    temporal = split_interactions(inter, 3, 20, SPLIT)
    assert a.train == b.train and a.test == b.test
    assert a.train != temporal.train
    assert temporal.train[0] == list(range(19, 5, -1))


def test_process_writes_the_jax_trees(tmp_path):
    for pkg in ("port", "jax"):
        _write_raw(tmp_path / pkg, "Gowalla", seed=7)
    main(["process", "--dataset", "Gowalla", "--root", str(tmp_path / "port")])
    args = jax_build_parser().parse_args(
        ["process", "--dataset", "Gowalla", "--root", str(tmp_path / "jax")])
    args.fn(args)
    got = _tree_bytes(tmp_path / "port" / "Gowalla")
    want = _tree_bytes(tmp_path / "jax" / "Gowalla")
    assert got.pop(RAW_FILES["Gowalla"]) == want.pop(RAW_FILES["Gowalla"])
    assert len(got) == 18 and {k.split("/")[0] for k in got} == {
        "time", "0", "1", "2", "3", "4"}
    assert got == want
    assert got["0/train.txt"] != got["time/train.txt"]


# -- native kernels --------------------------------------------------------------


@pytest.mark.parametrize("seed,min_inter", [(0, 3), (1, 10), (2, 1)])
def test_native_kernels_equal_numpy_and_jax(seed, min_inter):
    rng = np.random.default_rng(seed)
    n_users, n_items, n = 90, 70, 2500
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    times = rng.integers(0, 10_000, n)
    got = native.kcore_filter(users, items, n_users, n_items, min_inter)
    for want in (native.kcore_filter_numpy(users, items, n_users, n_items,
                                           min_inter),
                 jax_native.kcore_filter(users, items, n_users, n_items,
                                         min_inter)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert got[0].dtype == bool and got[1].dtype == np.int64
    got = native.dedup_earliest(users, items, times)
    for want in (native.dedup_earliest_numpy(users, items, times),
                 jax_native.dedup_earliest(users, items, times)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(got[0]) == len(np.unique(users * n_items + items))


def test_native_build_failures_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        monkeypatch.setenv("CXX", "no-such-compiler-here")
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            native.kcore_filter([0], [0], 1, 1, 1)
        monkeypatch.delenv("CXX")
        bad = tmp_path / "kcore.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        with pytest.raises(RuntimeError, match="building kcore.cpp failed"):
            native.dedup_earliest([0], [0], [0])
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native.library.cache_clear()


def test_native_refuses_out_of_range_ids():
    with pytest.raises(ValueError, match="user ids"):
        native.kcore_filter([0, 5], [0, 1], 5, 2, 1)


# -- the caches with_splits carries ----------------------------------------------


def test_with_splits_carries_exclusion_caches_not_eval_lists():
    ds = synthetic_interactions(**SYNTH)
    cfg = {"name": "MF", "embedding_size": 8}
    model = get_model(cfg, ds, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    evaluate(model, params, {}, ds, "test", [10])
    assert {"_exclusion_cache", "_packed_excl_cache", "_eval_pad_cache"} <= set(
        vars(ds))

    sliced_test = [t if u % 2 else [] for u, t in enumerate(ds.test)]
    sliced = ds.with_splits(test=sliced_test)
    assert sliced._exclusion_cache is ds._exclusion_cache
    assert sliced._packed_excl_cache is ds._packed_excl_cache
    assert "_eval_pad_cache" not in vars(sliced)
    # the slice is scored against its own lists, not the carried-over ones
    _, got = evaluate(model, params, {}, sliced, "test", [10])
    _, full = evaluate(model, params, {}, ds, "test", [10])
    rec = recommend(model, params, {}, ds, "test", 10).numpy()
    want = calculate_metrics(sliced_test, rec, [10])
    for name in want:
        assert got[name][10] == pytest.approx(want[name][10], abs=1e-6)
    assert got["Recall"][10] != full["Recall"][10]

    for changed in (dict(train=ds.train), dict(val=ds.val)):
        assert not {"_exclusion_cache", "_packed_excl_cache",
                    "_eval_pad_cache"} & set(vars(ds.with_splits(**changed)))
