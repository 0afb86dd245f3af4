"""On the card (skips without one): the trace reader against the profiler,
and the serving cell's precision control at the cell's own size."""

import pytest
import torch

from benchmark.trace import WINDOW, summarize


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def test_trace_finds_and_charges_device_work(cuda):
    from torch.profiler import ProfilerActivity, profile, record_function

    from igcn_cf_tpu_torch.kernels.bitpack import mask_words_pair

    wp = torch.randint(-2**31, 2**31 - 1, (1024, 1408), dtype=torch.int32,
                       device=cuda)
    x = torch.randn(2048, 2048, device=cuda)
    mask_words_pair(wp, 1, 2, 0.3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            with record_function("mask"):
                mask_words_pair(wp, 1, 2, 0.3)
            with record_function("matmul"):
                (x @ x).sum().item()
            torch.cuda.synchronize()
    t = summarize(prof, ("mask", "matmul"))
    assert t.families["K8p"][0] == 1
    assert t.by_range["mask"] > 0 and t.by_range["matmul"] > 0
    assert 0 < t.busy_s <= t.window_s
    assert t.kernel_count >= 2


def test_the_serving_control_is_not_correct_at_the_cells_size(cuda):
    import time

    from benchmark.calibrate import readings
    from benchmark.harness import Context
    from benchmark.reference.compare import judge
    from benchmark.run import cell_files, cell_of, load_spec

    spec = load_spec()
    cell = cell_of(spec, "igcn.serve_overload")
    config, traffic, limits = cell_files(spec, cell)
    ctx = Context(cell["name"], 2**31 + 4099, 1.0, False, config, traffic,
                  cuda, time.perf_counter())
    r = readings(ctx)
    assert judge(r["program"], limits)[0], r["program"]
    assert not judge(r["control"], limits)[0], r["control"]
