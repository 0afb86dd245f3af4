"""The benchmark's generator: exact counts, distinct pairs, the split, and
the same catalog for the same seed."""

import numpy as np
import pytest

from benchmark.catalog import degrees, generate

SIZE = dict(n_users=500, n_items=700, n_interactions=12_345)
SEED = 2**31 + 77


def test_counts_and_split():
    cat = generate(seed=SEED, **SIZE)
    assert len(cat.users) == 12_345
    deg = np.bincount(cat.users, minlength=500)
    assert deg.min() >= 3 and deg.sum() == 12_345
    assert cat.items.min() >= 0 and cat.items.max() < 700
    assert len(np.unique(cat.users * 700 + cat.items)) == 12_345
    for u in (0, 17, 499):
        n = deg[u]
        sp = cat.split[cat.users == u]
        assert (sp == 0).sum() == max(1, int(n * 0.7))
        assert (sp == 2).sum() == int(n * 0.2)
        assert list(sp) == sorted(sp)  # train, then val, then test
    train = cat.lists(0)
    assert len(train) == 500 and sum(map(len, train)) == (cat.split == 0).sum()


def test_same_seed_same_catalog():
    a, b = generate(seed=SEED, **SIZE), generate(seed=SEED, **SIZE)
    c = generate(seed=SEED + 1, **SIZE)
    for x in ("users", "items", "split"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
    assert not np.array_equal(a.items, c.items)


def test_popular_items_are_drawn_more():
    cat = generate(seed=SEED, **SIZE)
    counts = np.sort(np.bincount(cat.items, minlength=700))[::-1]
    assert counts[:70].sum() > 3 * counts[-70:].sum()


def test_degrees_share_the_mass_exactly():
    import torch

    d = degrees(4, 20, torch.tensor([1.0, 1.0, 2.0, 4.0]), 3)
    assert d.sum() == 20 and d.min() >= 3
    with pytest.raises(ValueError):
        degrees(10, 20, torch.ones(10), 3)
