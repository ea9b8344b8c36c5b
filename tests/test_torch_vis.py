"""The port's visualization phase and compatibility helpers held against
the JAX package on the CPU: ``vis.collect_intermediates`` (keys, shapes,
per-patch index offsets and values), ``Painter`` headless (matplotlib's
Agg backend), ``cli --phase vis`` against ``threepu.cli`` with the plots
recorded, and ``compat.pc_prediction`` / ``get_stage_progress``.  The
nets carry JAX's float32 initial parameters; each tolerance is stated
where it is used."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import types
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threepu.vis as jvis
from threepu import cli as jcli
from threepu import compat as jcompat
from threepu.io import save_checkpoint
from threepu.models import Net as JNet

import threepu_torch.vis as tvis
from threepu_torch import cli as tcli
from threepu_torch import compat as tcompat
from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.models import Net as TNet

NET = dict(max_up_ratio=8, step_ratio=2, knn=4, growth_rate=4, dense_n=2,
           max_num_point=16)
VIS = ["--num_point", "16", "--up_ratio", "8", "--knn", "4", "--growth_rate",
       "4", "--dense_n", "2"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's small net (3 levels of 2x, 16-point patches: levels 2 and 3
    cut 10 and 20 sub-patches) with float32 initial parameters, the port's
    net on them, a checkpoint file, 4 normalized patches and a 96-point
    shape file."""
    root = tmp_path_factory.mktemp("vis")
    rng = np.random.default_rng(8)
    jnet = JNet(**NET)
    params = jax.jit(lambda a, b: jnet.init(
        {"params": jax.random.PRNGKey(0), "patch": jax.random.PRNGKey(1)},
        a, 8, b, train=True))(
            jnp.asarray(rng.standard_normal((1, 16, 3)), jnp.float32),
            jnp.asarray(rng.standard_normal((1, 128, 3)), jnp.float32))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    tnet = TNet(**NET).eval()
    tnet.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                         strict=True)
    ckpt = str(root / "net.npz")
    save_checkpoint(ckpt, {"params": params}, step=0)
    patches = rng.standard_normal((4, 16, 3)).astype(np.float32)
    patches /= np.linalg.norm(patches, axis=-1).max(-1)[:, None, None]
    (root / "shapes").mkdir()
    np.savetxt(str(root / "shapes" / "shape.xyz"),
               rng.standard_normal((96, 3)).astype(np.float32))
    return dict(jnet=jnet, params=params, tnet=tnet, ckpt=ckpt,
                patches=patches, pattern=str(root / "shapes" / "*.xyz"))


def jitted(jnet, ratio):
    """``jnet`` with its eval ``apply`` compiled (the JAX package's
    ``collect_intermediates`` calls it eagerly, op by op)."""
    fn = jax.jit(lambda v, x: jnet.apply(v, x, ratio, train=False,
                                         mutable=["intermediates"]))
    return types.SimpleNamespace(apply=lambda v, x, r, **kw: fn(v, x))


def test_collect_intermediates_matches_jax(tiny):
    """The same keys as JAX's (per level: ``xyz_in``, ``layer_0`` ...
    ``layer_4``, ``nnIdx_layer_0`` ... ``nnIdx_layer_3``; and
    ``__output__``), the same shapes, the batch merged with kNN indices
    offset by ``b * n``: indices exactly JAX's, features and points to
    1e-5 (no selection of this input flips between the matmul forms)."""
    want = jvis.collect_intermediates(jitted(tiny["jnet"], 8), tiny["params"],
                                      jnp.asarray(tiny["patches"]), 8)
    got = tvis.collect_intermediates(tiny["tnet"], tiny["patches"], 8)
    assert sorted(got) == sorted(want)
    assert len(got) == 3 * 10 + 1
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if "nnIdx" in name:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    # level 2 runs 4 x 10 sub-patches of 16: row r of sub-patch b points
    # into [16 b, 16 b + 16)
    idx = got["level_2.nnIdx_layer_0"][0]
    assert idx.shape == (4 * 10 * 16, 4)
    owner = np.arange(idx.shape[0])[:, None] // 16
    assert (idx // 16 == owner).all()
    assert got["level_2.xyz_in"].shape == (1, 640, 3)
    assert got["__output__"].shape == (4, 128, 3)


def test_capture_adds_nothing_when_off(tiny):
    """``Net.upsample`` without a capture gives the captured run's output
    bit for bit, and the capture holds tensors of the run itself."""
    x = torch.from_numpy(tiny["patches"])
    cap = {}
    with torch.no_grad():
        plain = tiny["tnet"].upsample(x, 8)
        captured = tiny["tnet"].upsample(x, 8, capture=cap)
    assert torch.equal(plain, captured)
    assert torch.equal(cap["level_1.xyz_in"], x)
    assert cap["level_3.layer_4"].shape[-1] == 24 + 4 * (24 + 2 * 4)


def test_painter_headless_matches_jax(tiny):
    """``Painter`` on the Agg backend: the same title, one scatter of the
    points, and a click on point 3 highlights its kNN rows, as JAX's."""
    xyz = tiny["patches"][0]
    nn_idx = np.argsort(((xyz[:, None] - xyz[None]) ** 2).sum(-1), 1)[:, :4]
    out = []
    for painter in (tvis.Painter("NN Feature"), jvis.Painter("NN Feature")):
        painter.nnIdx = nn_idx
        fig, ax = painter.interactive_3D_plot(xyz, "level_1", show=False)
        mark = painter.highlight(ax, xyz, 3)
        out.append((ax.get_title(), np.asarray(mark._offsets3d).T))
        fig.canvas.draw()
    assert out[0][0] == out[1][0] == "NN Feature level_1"
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][1], xyz[nn_idx[3]])


def _recorded(painter_cls, calls):
    def record(self, xyz, name="", show=True):
        calls.append((name, np.array(self.nnIdx), np.array(xyz), show))
    return mock.patch.object(painter_cls, "interactive_3D_plot", record)


def test_cli_vis_phase_matches_jax(tiny):
    """``--phase vis`` on the 96-point file (18 patches of 16) against
    ``threepu.cli``'s with the plots recorded: the same 12 graphs (3
    levels x 4 edge convs) in the same order, each with its own level's
    input cloud (to 1e-5) and indices in range.  Indices: level 1 exactly
    JAX's; deeper, at least 99.9% of the rows equal.  There the feature
    kNN meets near-ties that the XLA and the PyTorch matmul round apart
    (measured: 2 of 23,040 indices of ``level_3.nnIdx_layer_0`` differ,
    the rest equal)."""
    argv = ["--phase", "vis", "--ckpt", tiny["ckpt"], "--test_data",
            tiny["pattern"]] + VIS
    got, want = [], []
    with _recorded(tvis.Painter, got):
        tcli.main(argv, device="cpu")
    orig = jvis.collect_intermediates

    def compiled(net, params, patches, ratio):
        return orig(jitted(net, ratio), params, patches, ratio)

    with _recorded(jvis.Painter, want), \
            mock.patch.object(jvis, "collect_intermediates", compiled):
        jcli.main(argv)
    assert [c[0] for c in got] == [c[0] for c in want]
    assert len(got) == 12
    for (name, idx, xyz, show), (_, jidx, jxyz, jshow) in zip(got, want):
        assert show is jshow is False                # no DISPLAY here
        assert idx.shape == jidx.shape
        rows = (idx == jidx).all(-1).mean()
        print(f"{name}: {rows:.5f} of the rows equal JAX's")
        if name.startswith("level_1."):
            np.testing.assert_array_equal(idx, jidx, err_msg=name)
        assert rows >= 0.999, name
        assert idx.max() < xyz.shape[0] == idx.shape[0]
        np.testing.assert_allclose(xyz, jxyz, atol=1e-5, err_msg=name)
    level3 = [c for c in got if c[0].startswith("level_3.")]
    assert level3[0][2].shape == (18 * 20 * 16, 3)


def test_cli_vis_runs_on_the_card_by_default(tiny, monkeypatch):
    """Without a device named, ``--phase vis`` asks for the card and
    raises where none is visible; it needs ``--ckpt`` and
    ``--test_data``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--phase", "vis", "--ckpt", tiny["ckpt"], "--test_data",
                   tiny["pattern"]] + VIS)
    with pytest.raises(SystemExit, match="--test_data"):
        tcli.main(["--phase", "vis", "--ckpt", tiny["ckpt"]] + VIS,
                  device="cpu")


def test_pc_prediction_matches_jax(tiny):
    """``pc_prediction`` on a (1, 3, 96) shape: 18 patches in chunks of 8
    (the last short), each input patch ``(1, 3, 16)`` and output ``(1, 3,
    128)`` to 1e-5 of JAX's."""
    shape = np.loadtxt(tiny["pattern"].replace("*", "shape")).astype(
        np.float32).T[None]
    want = jax.jit(lambda p, x: jcompat.pc_prediction(
        tiny["jnet"], p, x, 8, num_point=16))(tiny["params"],
                                              jnp.asarray(shape))
    got = tcompat.pc_prediction(tiny["tnet"], torch.from_numpy(shape), 8,
                                num_point=16)
    assert len(got[0]) == len(want[0]) == 18
    for g_list, w_list, n in ((got[0], want[0], 16), (got[1], want[1], 128)):
        for g, w in zip(g_list, w_list):
            assert tuple(g.shape) == (1, 3, n)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("step,stage_steps", [(0, 10), (14, 10), (25, 10),
                                              (99, 7)])
def test_get_stage_progress_matches_jax(step, stage_steps):
    assert tcompat.get_stage_progress(step, stage_steps) == \
        jcompat.get_stage_progress(step, stage_steps)
