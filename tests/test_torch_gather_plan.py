"""T5's launch plan (``microbench_gather.launch_plan``), a pure function of
N, x's dtype, the card's SM count and reps, on the CPU: one wave, column
stripes and row ranges that tile the output exactly, and the padded column
runs, and their sort by bank group, only where they fit a block's shared
memory."""

import pytest
import torch

from igcn_cf_tpu_torch.tools import microbench_gather as mg
from torch_threads import one_thread  # noqa: F401

# the gather tool's four cases, then wrapped runs (reps >= N), a ragged
# bf16 N and a one-column stripe at the shared-memory limit
CASES = [(512, torch.float32, 50), (2048, torch.float32, 50),
         (8192, torch.float32, 50), (2048, torch.bfloat16, 50),
         (300, torch.float32, 1000), (300, torch.float32, 50),
         (777, torch.bfloat16, 20), (58112, torch.float32, 50)]


def _padded_fits(n, dtype, reps):
    """One column fits: from the last 16-byte-aligned start below N, the
    chunks of a run at any start."""
    vec = 16 // dtype.itemsize
    col = ((n - 1) // vec + ((reps + 2 * vec - 2) // vec if reps else 1)) * vec
    return reps < n and col * dtype.itemsize <= mg.SMEM_LIMIT


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("n,dtype,reps", CASES)
def test_launch_plan_is_one_wave_and_tiles_the_output(n, dtype, reps, sms):
    plan = mg.launch_plan(n, dtype, sms, reps)
    # one block an SM, at most one wave; items beyond it are walked
    assert 1 <= plan.grid <= sms and plan.grid == min(plan.items, sms)
    # column stripes of a power-of-two width tile the 128 columns
    assert plan.width & (plan.width - 1) == 0
    assert plan.width * plan.stripes == mg.WIDTH
    # the most equal row ranges tile [0, N): no gap, no overlap, none empty
    assert plan.rows_per_range == -(-n // plan.row_ranges)
    assert (plan.row_ranges - 1) * plan.rows_per_range < n
    assert plan.row_ranges * plan.rows_per_range >= n
    # rows are split only while stripes x ranges still fit the SMs
    assert plan.items <= sms or plan.row_ranges == 1
    # the padded layout exactly where it fits, in the block's memory
    assert plan.padded == _padded_fits(n, dtype, reps)
    vec = 16 // dtype.itemsize
    if plan.padded:
        assert plan.pitch >= n + reps - 1 and plan.pitch % vec == 0
        assert plan.width == 1 or plan.pitch // vec % 2 == 1  # bank offset
    else:
        assert plan.pitch == n
    # the sort where its entries, results and counters fit beside the stripe
    stripe = plan.width * plan.pitch * dtype.itemsize
    outputs = plan.rows_per_range * plan.width
    sort = mg.sort_bytes(outputs, dtype)
    assert sort == (-(-4 * outputs // 16) * 16
                    + -(-dtype.itemsize * outputs // 16) * 16 + 1056)
    assert plan.sorted == (plan.padded and n <= 65536
                           and mg.SORT_MIN <= outputs <= mg.SORT_MAX
                           and stripe + sort <= mg.SMEM_LIMIT)
    assert plan.smem_bytes == stripe + (sort if plan.sorted else 0)
    assert plan.smem_bytes <= mg.SMEM_LIMIT


@pytest.mark.parametrize("n,dtype,width,ranges,rows,sort", [
    (512, torch.float32, 8, 8, 64, False),
    (2048, torch.float32, 8, 8, 256, False),
    (8192, torch.float32, 4, 4, 2048, True),
    (2048, torch.bfloat16, 16, 16, 128, False)])
def test_launch_plan_of_the_tools_cases_on_an_h100(n, dtype, width, ranges,
                                                   rows, sort):
    """132 SMs: 32-byte stripe rows (narrower where the padded stripe does
    not fit), 128 work items in one wave of 128 blocks; only N = 8,192's
    items (8,192 outputs) are sorted by bank group."""
    plan = mg.launch_plan(n, dtype, 132)
    assert (plan.width, plan.row_ranges, plan.rows_per_range) == (width, ranges,
                                                                 rows)
    assert plan.padded and plan.items == plan.grid == 128
    assert plan.sorted == sort


def test_launch_plan_takes_a_width_that_fits_and_refuses_one_that_does_not():
    assert [mg.launch_plan(8192, torch.float32, 132, width=w).items
            for w in (1, 2, 4)] == [128, 128, 128]
    with pytest.raises(ValueError, match="shared memory"):
        mg.launch_plan(8192, torch.float32, 132, width=8)  # 263,808 B
    with pytest.raises(ValueError, match="shared memory"):
        mg.launch_plan(58113, torch.float32, 132)  # one column: 232,452 B
    with pytest.raises(ValueError, match="shared memory"):
        mg.launch_plan(116225, torch.bfloat16, 132)


def test_plan_line_names_the_layout():
    line = mg.plan_line(mg.launch_plan(8192, torch.float32, 132), 132)
    assert line.startswith("32 stripes of 4 x 4 row ranges of 2048 = 128 "
                           "items, grid 128 on 132 SMs")
    assert "padded runs, sorted by bank group" in line
    line = mg.plan_line(mg.launch_plan(58112, torch.float32, 114), 114)
    assert "grid 114 on 114 SMs (at most 2 items a block)" in line
    assert "wrapping columns" in line
