"""The port's ``SampledDenseEdgeConv`` and ``AdaptiveLevel`` held against
the JAX package's on the CPU: same seeded numpy inputs, JAX's float32
initial parameters carried over by ``state_dict_from_jax``.  Each
tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threepu.models import AdaptiveLevel as JAdaptive
from threepu.models import SampledDenseEdgeConv as JSampled

from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.models import AdaptiveLevel as TAdaptive
from threepu_torch.models import SampledDenseEdgeConv as TSampled


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


@pytest.mark.parametrize("nsample", [1, 16])
def test_sampled_dense_edge_conv_matches_jax(rng, nsample):
    """FPS queries (one: the point nearest the centroid), a unique
    feature kNN with self dropped, the dense chain and the max: the
    sampled indices and points exactly JAX's, the features to 1e-5."""
    x = rng.standard_normal((2, 60, 10)).astype(np.float32)
    x[:, 9] = x[:, 4]                                  # duplicate rows
    xyz = rng.standard_normal((2, 60, 3)).astype(np.float32)
    jm = JSampled(growth_rate=4, n=3, k=6)
    params = f32(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(x), nsample,
        jnp.asarray(xyz))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x), nsample,
                    jnp.asarray(xyz))
    tm = TSampled(10, 4, 3, 6)
    tm.load_state_dict(state_dict_from_jax(flatten_tree(params)), strict=True)
    with torch.no_grad():
        got = tm(t(x), nsample, t(xyz))
    assert got[0].shape == (2, nsample, 10 + 3 * 4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def adaptive():
    """A small AdaptiveLevel (growth 4, dense 2, knn 6) on 2 clouds of 128
    points, target 49 points, with JAX's float32 initial parameters."""
    rng = np.random.default_rng(11)
    xyz = (rng.standard_normal((2, 128, 3)) * 2 + 0.5).astype(np.float32)
    jm = JAdaptive(dense_n=2, growth_rate=4, knn=6)
    params = f32(jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(3), jnp.asarray(xyz), 49)["params"])
    tm = TAdaptive(dense_n=2, growth_rate=4, knn=6)
    tm.load_state_dict(state_dict_from_jax(flatten_tree(params)), strict=True)
    return jm, params, tm, xyz


def test_adaptive_level_forward_matches_jax(adaptive):
    """Points (7² = 49, in the input's frame) and the global feature to
    1e-5; the [-1, 1] code grid bit for bit."""
    jm, params, tm, xyz = adaptive
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a, 49))(
        params, jnp.asarray(xyz))
    with torch.no_grad():
        got = tm(t(xyz), 49)
    assert got[0].shape == (2, 49, 3) and got[1].shape == (2, 1, 24 + 4 * 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(TAdaptive.gen_grid(5), JAdaptive.gen_grid(5))


def test_adaptive_level_gradient_matches_jax(adaptive, rng):
    """The gradient of a random projection of both outputs into every
    parameter, against ``jax.grad``: per tensor within 1e-4 of its L2 norm
    (float32 sums in other orders); the interpolation weights, the
    radius and the centroid pass none, as in JAX."""
    jm, params, tm, xyz = adaptive
    c_out = rng.standard_normal((2, 49, 3)).astype(np.float32)
    c_feat = rng.standard_normal((2, 1, 152)).astype(np.float32)

    def loss(p):
        out, feat = jm.apply({"params": p}, jnp.asarray(xyz), 49)
        return jnp.sum(out * c_out) + jnp.sum(feat * c_feat)

    want = state_dict_from_jax(flatten_tree(jax.jit(jax.grad(loss))(params)))
    tm.zero_grad(set_to_none=True)
    out, feat = tm(t(xyz), 49)
    (torch.sum(out * t(c_out)) + torch.sum(feat * t(c_feat))).backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        err = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
        assert err <= 1e-4, (name, err)


def test_adaptive_level_at_the_default_knn_raises_as_jax():
    """At the reference's default knn 16, layer4's 17 neighbours among
    the 16 points layer3 leaves raise, in both packages."""
    xyz = np.random.default_rng(0).standard_normal((1, 64, 3)).astype(
        np.float32)
    with pytest.raises(ValueError, match="exceeds point count 16"):
        jax.eval_shape(lambda a: JAdaptive(knn=16).init(
            jax.random.PRNGKey(0), a, 16), jnp.asarray(xyz))
    with pytest.raises(ValueError, match="exceeds point count 16"):
        TAdaptive(knn=16)(t(xyz), 16)


def test_exponential_distance_matches_jax(rng):
    """The interlevel skip's plain weights, exported under the JAX
    package's name: distances and weights to 1e-6, no gradient."""
    from threepu.models import exponential_distance as jexp
    from threepu_torch.models import exponential_distance as texp
    pts = rng.standard_normal((2, 30, 5)).astype(np.float32)
    nbrs = rng.standard_normal((2, 30, 4, 5)).astype(np.float32)
    want = jexp(jnp.asarray(pts), jnp.asarray(nbrs))
    got = texp(t(pts).requires_grad_(), t(nbrs))
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
