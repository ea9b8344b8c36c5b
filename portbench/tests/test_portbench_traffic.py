"""The inputs the benchmark makes: the same seed makes the same inputs,
another seed others, whatever the seed's size."""

import numpy as np
import pytest

from portbench import surface, weights
from portbench.drivers import eval as eval_driver
from portbench.tests import tiny

BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_pool_is_made_from_the_seed(seed):
    a = surface.pool(seed, 3, 500)
    b = surface.pool(seed, 3, 500)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.shape == (500, 3) and x.dtype == np.float32 for x in a)
    assert not np.array_equal(a[0], a[1])
    c = surface.pool(seed + 1, 3, 500)
    assert not np.array_equal(a[0], c[0])


def test_training_file_samples_one_surface_per_shape():
    d = surface.training_file(BIG, 2, [200, 800])
    assert sorted(d) == ["poisson_200", "poisson_800"]
    assert d["poisson_800"].shape == (2, 800, 3)
    again = surface.training_file(BIG, 2, [200, 800])
    assert np.array_equal(d["poisson_800"], again["poisson_800"])
    # both resolutions of a shape lie on its surface: same radius range
    r_lo = np.linalg.norm(d["poisson_200"][0], axis=-1)
    r_hi = np.linalg.norm(d["poisson_800"][0], axis=-1)
    assert abs(r_lo.mean() - r_hi.mean()) < 0.05


def kept(seed, k, n):
    res, slots = surface.Reservoir(seed, 2, k), [None] * k
    for i in range(n):
        slot = res.offer()
        if slot is not None:
            slots[slot] = i
    return sorted(slots)


def test_checked_items_are_drawn_from_the_seed_over_the_whole_window():
    assert kept(BIG, 2, 126) == kept(BIG, 2, 126)
    assert len(set(kept(BIG, 2, 126))) == 2
    # every item of a window of 40 is kept about as often, the last ones too
    counts = np.zeros(40)
    for seed in range(4000):
        counts[kept(BIG + seed, 2, 40)] += 1
    assert counts.min() > 0.7 * 200 and counts.max() < 1.3 * 200
    assert counts[30:].sum() > 0.7 * 2000
    job = dict(seed=BIG, traffic=dict(tiny.EVAL))
    assert eval_driver.control_shapes(job) == eval_driver.control_shapes(job)


def test_seeded_weights_follow_the_seed():
    a = weights.seeded(tiny.NET, BIG, "cpu")
    b = weights.seeded(tiny.NET, BIG, "cpu")
    assert all(bool((a[k] == b[k]).all()) for k in a)
    c = weights.seeded(tiny.NET, BIG + 1, "cpu")
    k = "level_1/layer0/conv/kernel"
    assert not bool((a[k] == c[k]).all())
    bound = (6.0 / (3 + 24)) ** 0.5
    assert float(a[k].abs().max()) <= bound
