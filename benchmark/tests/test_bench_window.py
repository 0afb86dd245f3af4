"""The window's arithmetic: a rate over the whole window, a percentile over
every request, and the device's busy time as a union of intervals."""

import pytest

from benchmark.window import busy, gaps, merge, percentile, rate


def test_rate_is_over_the_whole_window():
    assert rate(10 * 351 * 2048, 12.5) == pytest.approx(575_078.4)
    with pytest.raises(ValueError):
        rate(1, 0)


def test_p95_counts_every_request():
    lat = [1.0] * 95 + [10.0] * 5
    assert percentile(lat, 95) == 1.0
    assert percentile(lat + [10.0], 95) == 10.0
    assert percentile(list(range(1, 21)), 95) == 19
    assert percentile([3.0], 95) == 3.0


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([(0, 2), (1, 3)], 0, 10, 3),           # overlap counted once
    ([(0, 2), (2, 3)], 0, 10, 3),           # touching
    ([(0, 2), (5, 6), (5.5, 7)], 0, 10, 4),
    ([(-1, 2), (9, 12)], 0, 10, 3),         # clipped to the window
    ([(3, 3), (4, 2)], 0, 10, 0),           # empty
])
def test_busy_is_the_union_inside_the_window(intervals, lo, hi, want):
    assert busy(intervals, lo, hi) == pytest.approx(want)


def test_gaps_complement_the_union():
    iv = [(1, 2), (1.5, 3), (6, 7)]
    assert merge(iv) == [(1, 3), (6, 7)]
    g = gaps(iv, 0, 10)
    assert g == [(0, 1), (3, 6), (7, 10)]
    assert busy(iv, 0, 10) + sum(e - s for s, e in g) == pytest.approx(10)


def test_balanced_order_takes_one_of_each_quantile_a_block():
    import numpy as np

    from benchmark.drivers.serve_open import balanced_order

    for seed in (1, 2**31 + 5):
        order = balanced_order(np.random.default_rng(seed), 256)
        assert sorted(order) == list(range(256))
        for b in range(16):
            assert sorted(j // 16 for j in order[16 * b:16 * b + 16]) \
                == list(range(16))
    assert balanced_order(np.random.default_rng(1), 256) != \
        balanced_order(np.random.default_rng(2), 256)
