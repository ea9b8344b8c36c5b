"""The port's reference-style ops (``threepu_torch.ops``: ``ball_query``,
``group_knn``, ``furthest_point_sample``, ``fps_indices``,
``gather_points``, ``normalize_point_batch``, ``nndistance``) held
against the JAX package's functions of the same names on the CPU, on the
same seeded numpy inputs, in the reference's NCHW layout and
channels-last.  Each tolerance is stated where it is used."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import ball_query_oracle
import threepu.ops as jops
import threepu_torch.ops as tops


def t(a):
    return torch.from_numpy(np.array(a))


def test_export_lists_name_the_jax_packages():
    """Every name of ``threepu.ops.__all__`` is in the port's, and
    resolves."""
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert getattr(tops, name) is not None


def _grid_cloud(rng, b, n):
    """Points on a 0.25 grid (exact squared distances, many ties)."""
    return (rng.integers(-6, 7, (b, n, 3)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("case", ["hits", "overflow", "no-hit", "mask",
                                  "exact-radius"])
def test_ball_query_matches_jax(case):
    """Indices exactly JAX's (and the sequential oracle's where no mask):
    index order, slots after the hits hold the first hit, no hit gives
    zeros, masked points never match, ``d < r**2`` strictly (on the grid,
    ``exact-radius`` puts many points at exactly the radius)."""
    rng = np.random.default_rng(["hits", "overflow", "no-hit", "mask",
                                 "exact-radius"].index(case))
    radius, nsample, mask = 0.7, 6, None
    pts = rng.standard_normal((2, 80, 3)).astype(np.float32)
    q = rng.standard_normal((2, 12, 3)).astype(np.float32)
    if case == "overflow":
        radius, nsample = 2.0, 4
    elif case == "no-hit":
        q = q + 50.0
        q[:, 0] = pts[:, 3]                     # one query with hits
    elif case == "mask":
        mask = rng.random((2, 80)) > 0.5
    elif case == "exact-radius":
        pts, q = _grid_cloud(rng, 2, 80), _grid_cloud(rng, 2, 12)
        radius = 0.5
    want = np.asarray(jops.ball_query(radius, nsample, jnp.asarray(pts),
                                      jnp.asarray(q),
                                      None if mask is None
                                      else jnp.asarray(mask)))
    got = tops.ball_query(radius, nsample, t(pts), t(q),
                          None if mask is None else t(mask))
    assert got.dtype == torch.int32 and got.shape == (2, 12, nsample)
    np.testing.assert_array_equal(got.numpy(), want)
    if mask is None:
        for b in range(2):
            np.testing.assert_array_equal(
                got[b].numpy(), ball_query_oracle(radius, nsample, pts[b], q[b]))
    if case == "no-hit":
        assert (got[:, 1:] == 0).all() and (got[:, 0] != 0).any()
    if case == "overflow":
        assert (got == got[..., :1]).float().mean() < 0.5


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "cl"])
@pytest.mark.parametrize("unique", [True, False], ids=["unique", "all"])
def test_group_knn_matches_jax(rng, nchw, unique):
    """Neighbours, indices and distances exactly JAX's on tie-free data
    with duplicate rows (both rank in the matmul form, float32)."""
    q = rng.standard_normal((2, 10, 3)).astype(np.float32)
    p = rng.standard_normal((2, 40, 3)).astype(np.float32)
    p[:, 7] = p[:, 2]
    if nchw:
        q, p = q.transpose(0, 2, 1), p.transpose(0, 2, 1)
    want = jops.group_knn(5, jnp.asarray(q), jnp.asarray(p), unique=unique,
                          NCHW=nchw)
    got = tops.group_knn(5, t(q), t(p), unique=unique, NCHW=nchw)
    assert got[0].shape == want[0].shape == ((2, 3, 10, 5) if nchw
                                             else (2, 10, 5, 3))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "cl"])
def test_furthest_point_sample_matches_jax(rng, nchw):
    """Picks exactly JAX's, with and without a mask; the sampled points in
    the input's layout; a 2-D input or 2 channels raise as in JAX."""
    pts = rng.standard_normal((3, 200, 3)).astype(np.float32)
    mask = rng.random((3, 200)) > 0.3
    x = pts.transpose(0, 2, 1) if nchw else pts
    for m in (None, mask):
        want = jops.furthest_point_sample(
            jnp.asarray(x), 24, NCHW=nchw,
            valid_mask=None if m is None else jnp.asarray(m))
        got = tops.furthest_point_sample(t(x), 24, NCHW=nchw,
                                         valid_mask=None if m is None else t(m))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    with pytest.raises(ValueError, match="3D tensor"):
        tops.furthest_point_sample(t(pts[0]), 4)
    with pytest.raises(ValueError, match="3D points"):
        tops.furthest_point_sample(t(pts[..., :2]), 4, NCHW=False)


@pytest.mark.parametrize("kind", ["plain", "mask", "nonfinite", "float64"])
def test_fps_indices_matches_jax(rng, kind):
    """``fps_indices`` picks exactly JAX's: from index 0, from the first
    valid index under a mask, never a non-finite point, any float
    input."""
    pts = rng.standard_normal((2, 150, 3)).astype(np.float32)
    mask = None
    if kind == "mask":
        mask = rng.random((2, 150)) > 0.5
        mask[:, :3] = False
    elif kind == "nonfinite":
        pts[:, 5::17] = np.nan
    want = np.asarray(jops.fps_indices(
        jnp.asarray(pts), 20, None if mask is None else jnp.asarray(mask)))
    x = t(pts).double() if kind == "float64" else t(pts)
    got = tops.fps_indices(x, 20, None if mask is None else t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_points_and_its_gradient_match_jax(rng):
    """Forward exactly; the gradient (a scatter-add over repeated indices)
    to 1e-6 of ``jax.vjp``'s."""
    f = rng.standard_normal((2, 5, 30)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 50)).astype(np.int32)
    cot = rng.standard_normal((2, 5, 50)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jops.gather_points(a, jnp.asarray(idx)),
                        jnp.asarray(f))
    x = t(f).requires_grad_()
    got = tops.gather_points(x, t(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(t(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "cl"])
def test_normalize_point_batch_matches_jax(rng, nchw):
    """Normalized points, centroid and radius to 1e-6 (the mean sums in
    another order), in the input's layout."""
    pc = (rng.standard_normal((3, 70, 3)) * 4 + 1).astype(np.float32)
    x = pc.transpose(0, 2, 1) if nchw else pc
    want = jops.normalize_point_batch(jnp.asarray(x), NCHW=nchw)
    got = tops.normalize_point_batch(t(x), NCHW=nchw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_nndistance_matches_jax(rng):
    """Indices exactly JAX's on tie-free data; distances to 1e-6 absolute
    plus 1e-6 relative (JAX computes them in the matmul form on the CPU,
    whose rounding scales with the squared norms, ~3 here; the port by
    direct subtraction); the gradient of the summed distances to 1e-5."""
    a = rng.standard_normal((2, 60, 3)).astype(np.float32)
    b = rng.standard_normal((2, 45, 3)).astype(np.float32)
    want = jops.nndistance(jnp.asarray(a), jnp.asarray(b))
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    got = tops.nndistance(ta, tb)
    for i in (1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (0, 2):
        np.testing.assert_allclose(got[i].detach().numpy(),
                                   np.asarray(want[i]), rtol=1e-6, atol=1e-6)
    jg = jax.grad(lambda x, y: sum(jnp.sum(o) for o in jops.nndistance(x, y)[::2]),
                  argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    (got[0].sum() + got[2].sum()).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[1]), rtol=1e-5,
                               atol=1e-5)
