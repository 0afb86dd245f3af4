"""The least-time counts at the cells' real shapes, and the training step's
operation count."""

import pytest

from benchmark.roofline import (datasheet, k1, k2, k3, k4, k5, k8p,
                                least_s, train_step_flops, words_per_row)
from benchmark.run import Reading, reader

H100 = datasheet("NVIDIA H100 80GB HBM3")
NU, NI, D = 29_858, 40_981, 64
N = NU + NI


def test_k3_at_6144_rows_is_bound_by_p():
    # 3 x 2,048 rows of the bf16 P over 70,839 columns: ~0.263 ms, PERF.md's
    # 0.2633 counted P's 70,912 padded columns
    ms = 1e3 * least_s(k3(6144, N, D), H100)
    assert ms == pytest.approx(0.2630, abs=2e-4)
    assert 6144 * N * 2 / H100.hbm_bytes_s > 2 * 6144 * N * D / H100.bf16_flops
    # K4 writes dX0 over all n rows in f32: PERF.md's 0.2658
    assert 1e3 * least_s(k4(6144, N, D), H100) == pytest.approx(0.2655,
                                                                abs=2e-4)


def test_k5_at_4096_users_counts_the_real_items():
    # users x items x d x 2 at the f32 peak: 0.3207 ms over the 40,981
    # items; PERF.md's 0.3526 counted the 45,056 padded ones
    ms = 1e3 * least_s(k5(4096, NI, D, 20), H100)
    assert ms == pytest.approx(0.3207, abs=1e-4)
    w = k5(4096, NI, D, 20)
    assert w.nbytes / H100.hbm_bytes_s < w.flops / H100.fp32_flops


def test_bitpack_counts_are_bytes_bound():
    assert words_per_row(NI) == 1281  # not the 1,408 of the padded tiles
    nnz = 719_000
    for w in (k1(NU, NI, nnz, D), k2(NU, NI, nnz, D), k8p(NU, NI)):
        assert w.nbytes / H100.hbm_bytes_s > w.flops / H100.bf16_flops
    assert k8p(NU, NI).nbytes == 3 * NU * 1281 * 4


def test_train_flops_by_hand():
    nnz, batch, params = 700_000, 2048, (N + 2) * D + D
    prop = 3 * 2 * 2 * 2 * nnz * D
    igcn = prop + 2 * 2 * 2 * nnz * D + 3 * 4 * batch * 2 * D + 12 * params
    assert train_step_flops("IGCN", NU, NI, nnz, D, 3, batch, params) == igcn
    lgcn = prop + 3 * 2 * batch * 2 * D + 12 * (N * D)
    assert train_step_flops("LightGCN", NU, NI, nnz, D, 3, batch,
                            N * D) == lgcn


def test_train_mfu_is_the_same_on_either_engine():
    work = {"model": "IGCN", "n_users": NU, "n_items": NI, "nnz": 700_000,
            "d": D, "n_layers": 3, "batch": 2048,
            "n_params": (N + 2) * D + D, "step_wall_s": 3e-3}
    read = reader("train_mfu")
    cache = read(Reading(None, dict(work, engine="cache"), {}, H100))
    recompute = read(Reading(None, dict(work, engine="recompute"), {}, H100))
    assert cache == recompute
    flops = train_step_flops("IGCN", NU, NI, 700_000, D, 3, 2048,
                             (N + 2) * D + D)
    assert cache == pytest.approx(100 * flops / (3e-3 * 67e12))


def test_unknown_card_is_refused():
    with pytest.raises(ValueError):
        datasheet("NVIDIA A100-SXM4-80GB")
