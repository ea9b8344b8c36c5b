"""The PyTorch port's layers and eval cascade held against the JAX package
on the CPU: same inputs (seeded numpy), same weights (the flax params
converted by ``state_dict_from_jax``, or the trained checkpoint)."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from threepu.io import load_checkpoint
from threepu.io.checkpoint import _flatten
from threepu.models import layers as jlayers
from threepu.models import upsampler as jup
from threepu.ops import duplicate_mask as jdup
from threepu.ops import fps_indices, gather_nd, knn_group
from threepu.ops.normalize import normalize_point_batch_cl

from threepu_torch.io.weights import load_jax_checkpoint, state_dict_from_jax
from threepu_torch.models import layers as tlayers
from threepu_torch.models import upsampler as tup

WEIGHTS = "artifacts/prod_clean_final.npz"
FULL = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12,
            dense_n=3, max_num_point=312, fm_knn=5)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def port_state(params):
    return state_dict_from_jax(_flatten(params))


def test_dense_edge_conv_matches(rng):
    """Feature-space kNN graph (unique, self dropped) + the fused dense
    schedule: indices exact, features to 1e-5."""
    x = rng.standard_normal((2, 40, 10)).astype(np.float32)
    x[:, 5] = x[:, 2]                                # duplicate rows
    dup = jdup(jnp.asarray(x))
    jm = jlayers.DenseEdgeConv(growth_rate=4, n=3, k=6)
    params = f32(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         dup_mask=dup)["params"])
    want, want_idx = jm.apply({"params": params}, jnp.asarray(x),
                              dup_mask=dup)
    tm = tlayers.DenseEdgeConv(10, 4, 3, 6)
    tm.load_state_dict(port_state(params), strict=True)
    with torch.no_grad():
        got, idx = tm(t(x), torch.from_numpy(np.asarray(dup)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("activation,ndim", [(None, 2), ("relu", 1)])
def test_dense_conv_matches(rng, activation, ndim):
    x = rng.standard_normal((2, 7, 9)).astype(np.float32)
    jm = jlayers.DenseConv(5, activation)
    params = f32(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    tm = tlayers.DenseConv(9, 5, activation, ndim=ndim)
    state = {"conv.weight": t(np.asarray(params["conv"]["kernel"]).T.reshape(
        5, 9, *([1] * ndim))), "conv.bias": t(params["conv"]["bias"])}
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tm(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("prev_group", [1, 3], ids=["group1", "grouped"])
def test_level_matches(rng, prev_group):
    """One Level with the interlevel skip: grouped (shared previous set,
    phantom rows in prev_dup) and ungrouped (prev_dup computed)."""
    kw = dict(dense_n=2, growth_rate=4, knn=8, fm_knn=3, step_ratio=2)
    p, n, m = 2, 24, 30
    b = p * prev_group
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    norm = np.asarray(normalize_point_batch_cl(jnp.asarray(xyz))[0])
    pm = m if prev_group > 1 else n
    prev = rng.standard_normal((b // prev_group, pm, 3)).astype(np.float32)
    prev[:, 4] = prev[:, 1]
    jm = jup.Level(**kw)
    params = f32(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(xyz),
                                  jnp.asarray(norm), None)["params"])
    feat_c = 24 + 4 * (24 + kw["dense_n"] * kw["growth_rate"])
    prev_feat = rng.standard_normal((b // prev_group, pm, feat_c)
                                    ).astype(np.float32)
    jargs, targs = {}, {}
    if prev_group > 1:
        dup = np.array(jdup(jnp.asarray(prev)))
        dup[:, -5:] = True                           # phantom rows
        jargs = dict(prev_group=prev_group, prev_dup=jnp.asarray(dup))
        targs = dict(prev_group=prev_group, prev_dup=torch.from_numpy(dup))
    apply = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **jargs))
    want_xyz, want_f = apply(params, jnp.asarray(xyz), jnp.asarray(norm),
                             (jnp.asarray(prev), jnp.asarray(prev_feat)))
    tm = tup.Level(**kw, span_name="level1")
    tm.load_state_dict(port_state(params), strict=True)
    with torch.no_grad():
        got_xyz, got_f = tm(t(xyz), t(norm), (t(prev), t(prev_feat)), **targs)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz),
                               atol=1e-5, rtol=1e-5)


def test_full_net_loads_trained_weights_strictly():
    net = tup.Net(**FULL)
    state = load_jax_checkpoint(WEIGHTS)
    net.load_state_dict(state, strict=True)
    assert net.levels["level_4"].up_layer.up_layer1.conv.weight.shape == (
        128, 265, 1, 1)
    assert net.levels["level_1"].layer2_prep.conv.weight.shape == (24, 84, 1)


@pytest.fixture(scope="module")
def trained_patches():
    """Two 312-point patches of held-out shape 0, normalized, plus both
    trained nets."""
    with h5py.File("artifacts/held.hdf5", "r") as f:
        shape = f["poisson_5000"][0].astype(np.float32)
    shape = shape - shape.mean(0)
    shape /= np.linalg.norm(shape, axis=1).max()
    s = jnp.asarray(shape[None])
    seeds = gather_nd(s, fps_indices(s, 2))
    patches = knn_group(seeds, s, 312).neighbors[0]
    norm = np.asarray(normalize_point_batch_cl(patches)[0], np.float32)
    params = f32(load_checkpoint(WEIGHTS)[0]["params"])
    tnet = tup.Net(**FULL)
    tnet.load_state_dict(load_jax_checkpoint(WEIGHTS), strict=True)
    return norm, jup.Net(**FULL), params, tnet


def _jax_upsample(jnet, params, norm, ratio):
    """The JAX eval cascade as one jit program (how the JAX pipeline
    runs it)."""
    fn = jax.jit(lambda p, x: jnet.apply({"params": p}, x, ratio,
                                         train=False))
    return np.asarray(fn(params, jnp.asarray(norm)))


def test_trained_cascade_level1_matches(trained_patches):
    """Ratio 2 (level 1 only): elementwise to 1e-4."""
    norm, jnet, params, tnet = trained_patches
    want = _jax_upsample(jnet, params, norm, 2)
    got = tnet.upsample(torch.from_numpy(norm), 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_trained_cascade_ratio8_matches(trained_patches):
    """Ratio 8 at full width with the trained weights: levels 2 and 3
    sub-patch (10 and 20 sub-patches) with the grouped interlevel skip
    and re-stitch by FPS.

    Rows are compared to 1e-4 first.  They are NOT equal all through: the
    port's features differ from XLA's by float32 rounding (~1e-6, the two
    libraries sum matmuls in different orders), and that flips a near-tie
    of a merge FPS re-stitch, so the row order of everything re-stitched
    after it differs (first differing output row, when measured: patch 0,
    row 54; the test prints it).  The check then falls back to
    the point SETS: the Chamfer distance between the two outputs must be
    below 5% of the output's mean squared NN spacing, and most points
    must coincide (measured: 1.8% and 0.01% of the spacing; 85% and 99%
    of the points)."""
    norm, jnet, params, tnet = trained_patches
    want = _jax_upsample(jnet, params, norm, 8)
    got = tnet.upsample(torch.from_numpy(norm), 8).numpy()
    assert got.shape == want.shape == (2, 312 * 8, 3)
    assert np.isfinite(got).all()
    rows_equal = np.abs(got - want).max(-1) <= 1e-4
    if rows_equal.all():
        return
    first = np.argwhere(~rows_equal)[0]
    print(f"ratio 8: first differing row (patch, row) = {tuple(first)}; "
          "comparing point sets")
    for i in range(got.shape[0]):
        d_gw = cKDTree(want[i]).query(got[i])[0] ** 2
        d_wg = cKDTree(got[i]).query(want[i])[0] ** 2
        spacing = (cKDTree(want[i]).query(want[i], k=2)[0][:, 1] ** 2).mean()
        print(f"patch {i}: chamfer {d_gw.mean() + d_wg.mean():.3e}, "
              f"{(d_gw.mean() + d_wg.mean()) / spacing:.4f} of the spacing; "
              f"coinciding {(d_gw < 1e-10).mean():.3f}")
        assert d_gw.mean() + d_wg.mean() < 0.05 * spacing, i
        assert (d_gw < 1e-10).mean() > 0.5, i
