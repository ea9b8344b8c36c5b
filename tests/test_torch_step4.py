"""The port's 2-D code grid (``step_ratio`` 4: 2 levels of 4x up to 16x)
held against the JAX package on the CPU: the code grid, one ``Level``,
``Net(16, step_ratio=4)`` eval (re-patching with phantom sub-patches) and
train (ratio 4 and 16, re-patch seeds pinned: loss and every gradient),
the loop's re-patch sizes and the curriculum, the checkpoints both ways,
and ``cli --phase test/train --step_ratio 4`` against ``threepu.cli``.

Inputs come from seeded numpy generators; both nets carry JAX's float32
initial parameters, carried over by ``state_dict_from_jax``.  Each
tolerance is stated where it is used.
"""

import contextlib
import math
import unittest.mock as mock

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threepu.train.loop as jloop
from threepu import cli as jcli
from threepu.data import curriculum as jcur
from threepu.io import checkpoint as jck
from threepu.io import read_ply as jread_ply
from threepu.losses import chamfer_loss as jchamfer_loss
from threepu.models import Net as JNet
from threepu.models import upsampler as jup
from threepu.train import model as jmodel

import threepu_torch.train.loop as tloop
from threepu_torch import cli as tcli
from threepu_torch.data import curriculum as tcur
from threepu_torch.io import checkpoint as tck
from threepu_torch.io import read_ply
from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.models import Net as TNet
from threepu_torch.models import upsampler as tup
from threepu_torch.train import make_optimizer, train_loss, train_step

SMALL = dict(max_up_ratio=16, step_ratio=4, knn=4, growth_rate=4, dense_n=2,
             max_num_point=16, fm_knn=3)
B, K = 3, 16


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@contextlib.contextmanager
def pinned_randint(seeds):
    """``jax.random.randint`` returns ``seeds``' arrays in call order (the
    re-patch seeds of ``Net._extract_patch_train``)."""
    it = iter(seeds)

    def fake(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(next(it), dtype).reshape(shape)

    with mock.patch.object(jax.random, "randint", fake):
        yield


@pytest.fixture(scope="module")
def small():
    """JAX's step-4 net at small width with float32 initial parameters,
    the port's net on them, and a batch: input (B, K, 3), gt (B, 16K, 3).
    With this seed the level-1 output of patch 2 holds an outlier, so
    level 2 of the eval cascade has a phantom sub-patch."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, K, 3)).astype(np.float32)
    gt = rng.standard_normal((B, 16 * K, 3)).astype(np.float32)
    net = JNet(**SMALL)
    params = jax.jit(lambda a, b: net.init(
        {"params": jax.random.PRNGKey(0), "patch": jax.random.PRNGKey(1)},
        a, 16, b, train=True))(jnp.asarray(x), jnp.asarray(gt))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    tnet = TNet(**SMALL)
    tnet.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                         strict=True)
    return net, params, tnet, x, gt


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_gen_grid_matches_jax(size):
    """The (size², 2) grid in [-0.2, 0.2], bit for bit."""
    got = tup.gen_grid(size)
    assert got.dtype == np.float32 and got.shape == (size * size, 2)
    np.testing.assert_array_equal(got, jup.gen_grid(size))


@pytest.mark.parametrize("step_ratio", [2, 3, 4, 8, 9])
def test_level_code_matches_jax(step_ratio):
    """A Level's code points, bit for bit: the 1-D column below 4, else
    the grid of round(sqrt(r))² points (JAX's fix: 4 points at r = 4)."""
    got = tup.Level(step_ratio=step_ratio).code.numpy()
    np.testing.assert_array_equal(got, jup.Level(step_ratio=step_ratio).code)
    if step_ratio == 4:
        assert got.shape == (4, 2)


@pytest.mark.parametrize("grouped", [False, True], ids=["level1", "grouped"])
def test_level_step4_matches_jax(rng, grouped):
    """One step-4 Level: ``up_layer1`` takes C + 2 channels; output (B,
    4N, 3) and features to 1e-5, with the interlevel skip (grouped, a
    phantom row in prev_dup) or without it."""
    kw = dict(dense_n=2, growth_rate=4, knn=6, fm_knn=3, step_ratio=4)
    p, n, m, group = 2, 20, 24, 3
    b = p * group if grouped else p
    xyz = rng.standard_normal((b, n, 3)).astype(np.float32)
    norm = (xyz / 3.0).astype(np.float32)
    jm = jup.Level(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(xyz),
                              jnp.asarray(norm), None)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    tm = tup.Level(**kw)
    tm.load_state_dict(state_dict_from_jax(flatten_tree(params)), strict=True)
    feat_c = 24 + 4 * (24 + kw["dense_n"] * kw["growth_rate"])
    assert tm.up_layer.up_layer1.conv.weight.shape[1] == feat_c + 2
    jargs, targs, prev = {}, {}, None
    if grouped:
        prev_xyz = rng.standard_normal((p, m, 3)).astype(np.float32)
        prev_feat = rng.standard_normal((p, m, feat_c)).astype(np.float32)
        dup = np.zeros((p, m), bool)
        dup[:, -2:] = True
        prev = (prev_xyz, prev_feat)
        jargs = dict(prev_group=group, prev_dup=jnp.asarray(dup))
        targs = dict(prev_group=group, prev_dup=torch.from_numpy(dup))
    want = jax.jit(lambda pr, *a: jm.apply({"params": pr}, *a, **jargs))(
        params, jnp.asarray(xyz), jnp.asarray(norm),
        None if prev is None else tuple(map(jnp.asarray, prev)))
    with torch.no_grad():
        got = tm(t(xyz), t(norm), None if prev is None else tuple(map(t, prev)),
                 **targs)
    assert got[0].shape == (b, 4 * n, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_net_step4_eval_matches_jax(small):
    """``Net.upsample`` at 16x: level 1 turns 16 into 64 points, level 2
    cuts 20 sub-patches of 16 (patch 2's outlier leaves 19 real ones and a
    phantom), merges 20 x 64 and re-stitches 256 by FPS.  Rows to 1e-5
    (no selection of this input flips between the matmul forms)."""
    net, params, tnet, x, _ = small
    with torch.no_grad():
        level1 = tnet.upsample(t(x), 4)
        _, true_sub = tnet._extract_patch_eval(level1, K, 20)
        got = tnet.upsample(t(x), 16).numpy()
    assert true_sub.tolist() == [20, 20, 19]        # a phantom sub-patch
    want = np.asarray(jax.jit(lambda p, a: net.apply(
        {"params": p}, a, 16, train=False))(params, jnp.asarray(x)))
    assert got.shape == want.shape == (B, 16 * K, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(level1.numpy(), np.asarray(jax.jit(
        lambda p, a: net.apply({"params": p}, a, 4, train=False))(
            params, jnp.asarray(x))), atol=1e-5)


def jax_loss_and_grads(net, params, x, gt, ratio, seeds):
    weight = jmodel.loss_weight(ratio, net.max_up_ratio, net.step_ratio)

    def loss_fn(p):
        pred, gt_out = net.apply({"params": p}, jnp.asarray(x), ratio,
                                 jnp.asarray(gt), train=True,
                                 rngs={"patch": jax.random.PRNGKey(0)})
        return jchamfer_loss(pred, gt_out) * weight

    with pinned_randint(seeds):
        return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("ratio", [4, 16])
def test_train_step4_loss_and_gradients_match(small, ratio):
    """The train cascade at ratio 4 (level 1 only) and 16 (level 2
    re-patches 64 -> 16 points, gt 256 -> 64, its seed pinned on both
    sides): the weighted loss to 1e-5 relative, every parameter's
    gradient within 1e-4 of its L2 norm (float32 sums in other orders),
    and exactly zero for level 2 at ratio 4."""
    net, params, _, x, gt = small
    seeds = ([] if ratio == 4 else
             [np.random.default_rng(ratio).integers(0, 4 * K, (B, 1))
              .astype(np.int32)])
    gt_r = gt[:, :ratio * K]
    val, grads = jax_loss_and_grads(net, params, x, gt_r, ratio, seeds)
    want = state_dict_from_jax(flatten_tree(grads))
    tnet = TNet(**SMALL)
    tnet.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                         strict=True)
    weighted, _, pred, gt_out = train_loss(
        tnet, t(x), t(gt_r), ratio,
        seed_idx=[torch.from_numpy(s) for s in seeds])
    assert pred.shape == gt_out.shape == (B, 4 * K, 3)
    weighted.backward()
    np.testing.assert_allclose(weighted.item(), float(val), rtol=1e-5)
    got = dict(tnet.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        if not w.any():
            assert g is None or not g.any(), name
            continue
        err = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
        assert err <= 1e-4, (name, err)
    if ratio == 4:
        assert all(got[n].grad is None for n in got if "level_2" in n)


def test_train_step4_step_matches_jax(small):
    """Two clipped-Adam steps at ratio 16 with pinned seeds against
    ``threepu.train.model.train_step``: losses to 1e-5 relative, every
    parameter after them to 1e-5."""
    net, params, _, x, gt = small
    seeds = [np.random.default_rng(5).integers(0, 4 * K, (B, 1))
             .astype(np.int32)]
    tx = jmodel.make_optimizer(5e-4)
    tnet = TNet(**SMALL)
    tnet.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                         strict=True)
    jparams = jax.tree.map(jnp.copy, params)
    state = jmodel.TrainState(jparams, tx.init(jparams), jnp.asarray(0))
    opt = make_optimizer(tnet.parameters(), 5e-4)
    for _ in range(2):
        with pinned_randint(seeds):
            state, cd = jmodel.train_step(net, tx, state,
                                          jax.random.PRNGKey(0),
                                          jnp.asarray(x), jnp.asarray(gt), 16)
        got = train_step(tnet, opt, t(x), t(gt), 16,
                         seed_idx=[torch.from_numpy(s) for s in seeds])
        np.testing.assert_allclose(got.item(), float(cd), rtol=1e-5)
    want = state_dict_from_jax(flatten_tree(state.params))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("num_point,ratio,max_np,want", [
    (16, 4, 16, []), (16, 16, 16, [64]), (312, 16, 312, [1248]),
    (10, 16, 16, [40])], ids=["x4", "x16", "full-x16", "patch-below-max"])
def test_repatch_sizes_follow_the_jax_net(num_point, ratio, max_np, want):
    """The loop's re-patch sizes at step 4 are the ``maxval`` of every
    ``jax.random.randint`` JAX's train Net draws (traced at its
    initialization, which runs the train cascade), and the port's Net
    draws the same."""
    assert tloop.repatch_sizes(num_point, ratio, 4, max_np) == want
    if num_point > 64:
        return
    cfg = dict(max_up_ratio=ratio, step_ratio=4, knn=4, growth_rate=4,
               dense_n=2, max_num_point=max_np)
    x = np.zeros((1, num_point, 3), np.float32) + np.arange(
        num_point, dtype=np.float32)[None, :, None] / num_point
    gt = np.repeat(x, ratio, axis=1)
    drawn = []

    def spy(key, shape, minval, maxval, dtype=jnp.int32):
        drawn.append(int(maxval))
        return jnp.zeros(shape, dtype)

    net = JNet(**cfg)
    with mock.patch.object(jax.random, "randint", spy):
        jax.eval_shape(lambda a, b: net.init(
            {"params": jax.random.PRNGKey(0), "patch": jax.random.PRNGKey(1)},
            a, ratio, b, train=True), jnp.asarray(x), jnp.asarray(gt))
    assert drawn == want
    port_drawn = []
    real = torch.randint

    def port_spy(low, high, size, **kw):
        port_drawn.append(high)
        return real(low, high, size, **kw)

    with mock.patch.object(torch, "randint", port_spy):
        TNet(**cfg)(t(x), ratio, t(gt))
    assert port_drawn == want


@pytest.mark.parametrize("step", [0, 3, 5, 8, 11, 13, 17, 30])
def test_curriculum_step4_matches_jax(step):
    """Stage, progress, active ratios (4, then 4 and 16), the combined
    draw and the threshold at step ratio 4, equal to JAX's."""
    want = jcur.curriculum_state(step, 4, 16, step_ratio=4, cd_threshold=2.0)
    got = tcur.curriculum_state(step, 4, 16, step_ratio=4, cd_threshold=2.0)
    assert tuple(got) == tuple(want)
    assert set(got.scales) <= {4, 16}
    assert got.max_ratio == want.max_ratio


def test_checkpoints_carry_a_step4_net_both_ways(small, tmp_path):
    """JAX's step-4 tree -> ``state_dict_from_jax`` -> the port's ``.npz``
    (JAX reads it back bit for bit), ``.pth`` (the port's ``save_pth``,
    read by JAX's ``import_pth`` and by the port's) and full-state file
    with the Adam state (JAX's ``load_opt_state`` reads it): each loads
    strictly into the step-4 net."""
    net, params, tnet, _, _ = small
    path = str(tmp_path / "s4.npz")
    tck.save_checkpoint(path, tnet, step=9)
    tree, step = jck.load_checkpoint(path)
    assert step == 9
    for k, v in flatten_tree(params).items():
        assert np.array_equal(flatten_tree(tree["params"])[k], v), k
    state, _ = tck.load_checkpoint(path)
    TNet(**SMALL).load_state_dict(state, strict=True)

    pth = tck.save_pth(str(tmp_path / "s4.pth"), tnet, step=9)
    jtree, jstep = jck.import_pth(pth, {"params": params})
    for k, v in flatten_tree(params).items():
        assert np.array_equal(flatten_tree(jtree["params"])[k], v), k
    tstate, _ = tck.import_pth(pth, TNet(**SMALL))
    TNet(**SMALL).load_state_dict(tstate, strict=True)

    opt = make_optimizer(tnet.parameters(), 5e-4)
    full = str(tmp_path / "s4_full.npz")
    tck.save_train_checkpoint(full, tnet, opt, step=4)
    tx = jmodel.make_optimizer(5e-4)
    restored = jck.load_opt_state(full, tx.init(params))
    assert restored is not None and int(restored[1][0].count) == 0
    fresh = TNet(**SMALL)
    fresh.load_state_dict(tck.load_checkpoint(full)[0], strict=True)
    for (n, a), (_, b) in zip(fresh.state_dict().items(),
                              tnet.state_dict().items()):
        assert torch.equal(a, b), n


# ------------------------------------------------------------ the command line
CLI4 = ["--step_ratio", "4", "--num_shape_point", "64", "--num_point", "16",
        "--up_ratio", "16", "--knn", "4", "--growth_rate", "4", "--dense_n",
        "2", "--chunk", "4"]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A JAX step-4 checkpoint, a 64-point ``.xyz`` file, and a training
    file of 2 shapes at 64, 256 and 1024 points as ``.hdf5`` (JAX) and
    ``.npz`` (the port)."""
    root = tmp_path_factory.mktemp("cli4")
    rng = np.random.default_rng(4)
    net = JNet(max_up_ratio=16, step_ratio=4, knn=4, growth_rate=4,
               dense_n=2)
    params = jax.jit(lambda a, b: net.init(
        {"params": jax.random.PRNGKey(0), "patch": jax.random.PRNGKey(1)},
        a, 16, b, train=True))(
            jnp.asarray(rng.standard_normal((1, 16, 3)), jnp.float32),
            jnp.asarray(rng.standard_normal((1, 256, 3)), jnp.float32))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    ckpt = str(root / "s4.npz")
    jck.save_checkpoint(ckpt, {"params": params}, step=0)
    (root / "shapes").mkdir()
    np.savetxt(str(root / "shapes" / "shape.xyz"),
               rng.standard_normal((64, 3)).astype(np.float32))
    name = "train_poisson_64_poisson_256_poisson_1024"
    sets = {}
    for res in (64, 256, 1024):
        pts = rng.standard_normal((2, res, 3)).astype(np.float32)
        sets[f"poisson_{res}"] = pts / np.linalg.norm(pts, axis=-1,
                                                      keepdims=True)
    with h5py.File(root / f"{name}.hdf5", "w") as f:
        for k, v in sets.items():
            f.create_dataset(k, data=v)
    np.savez(root / f"{name}.npz", **sets)
    return dict(root=root, ckpt=ckpt, params=params,
                pattern=str(root / "shapes" / "*.xyz"),
                hdf5=str(root / f"{name}.hdf5"), npz=str(root / f"{name}.npz"))


def test_cli_test_phase_step4_matches_jax(cli_files):
    """``--phase test --step_ratio 4`` against ``threepu.cli.run_test``: 64
    -> 1024 points through 2 levels of 4x; the inputs to 1e-6, the
    outputs as point sets (Chamfer distance below 1e-9: float32 rounding
    of the same rows; no selection of this run flips on the CPU)."""
    root = cli_files["root"]
    argv = ["--phase", "test", "--ckpt", cli_files["ckpt"], "--test_data",
            cli_files["pattern"]] + CLI4
    tcli.main(argv + ["--result_dir", str(root / "t_out")], device="cpu")
    jflags = jcli.build_parser().parse_args(
        argv + ["--result_dir", str(root / "j_out")])
    jcli.run_test(jflags, jcli.result_path_for(jflags))
    got = read_ply(str(root / "t_out" / "shapes" / "shape.ply"))
    want = jread_ply(str(root / "j_out" / "shapes" / "shape.ply"))
    assert got.shape == want.shape == (1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(
        read_ply(str(root / "t_out" / "shapes" / "shape_input.ply")),
        jread_ply(str(root / "j_out" / "shapes" / "shape_input.ply")),
        atol=1e-6)
    d = np.sum((got[:, None].astype(np.float64) - want[None]) ** 2, -1)
    assert d.min(1).mean() + d.min(0).mean() < 1e-9


def test_cli_train_phase_step4_follows_jax(cli_files, tmp_path):
    """``--phase train --step_ratio 4``, one epoch of 300 steps of batch 1
    over stages 0-4 (``--stage_steps 40``), in both command lines with the
    train step replaced by a recorder: the same ratio (4, then 4 and 16),
    threshold and batch shapes at every step; each writes ``model_1.npz``
    at step 300, and the port's holds a tree JAX restores into its own
    step-4 net.  Then the port's real run of the same epoch: every
    ratio-16 step re-patches, the losses are finite, and the file serves
    ``--phase test``."""
    seen = {"jax": [], "port": []}

    def fake_jax(net, tx, state, key, inp, gt, ratio, threshold=None,
                 with_pred=False, **kw):
        seen["jax"].append((ratio, threshold, inp.shape, gt.shape))
        out = (state._replace(step=state.step + 1), jnp.asarray(0.5))
        return (*out, (inp, gt)) if with_pred else out

    def fake_port(net, opt, inp, gt, ratio, threshold=None, with_pred=False,
                  **kw):
        seen["port"].append((ratio, threshold, tuple(inp.shape),
                             tuple(gt.shape)))
        return (torch.tensor(0.5), (inp, gt)) if with_pred else torch.tensor(0.5)

    base = ["--phase", "train", "--batch_size", "1", "--max_epoch", "1",
            "--stage_steps", "40", "--id", "s4"] + CLI4
    with mock.patch.object(jloop, "train_step", fake_jax):
        jcli.main(base + ["--h5_data", cli_files["hdf5"], "--log_dir",
                          str(tmp_path / "jax")])
    with mock.patch.object(tloop, "train_step", fake_port):
        tcli.main(base + ["--h5_data", cli_files["npz"], "--log_dir",
                          str(tmp_path / "port")], device="cpu")
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 300
    assert {r for r, _, _, _ in seen["port"]} == {4, 16}
    for side in ("jax", "port"):
        _, step = jck.load_checkpoint(str(tmp_path / side / "s4"
                                          / "model_1.npz"))
        assert step == 300
    tree, _ = jck.load_checkpoint(str(tmp_path / "port" / "s4" / "model_1.npz"),
                                  {"params": cli_files["params"]})
    for k, v in flatten_tree(cli_files["params"]).items():
        assert flatten_tree(tree["params"])[k].shape == v.shape, k

    losses = []
    real_step = tloop.train_step

    def recording(*a, **kw):
        out = real_step(*a, **kw)
        losses.append((a[4], float(out[0] if kw.get("with_pred") else out)))
        return out

    with mock.patch.object(tloop, "train_step", recording):
        tcli.main(base + ["--h5_data", cli_files["npz"], "--log_dir",
                          str(tmp_path / "real")], device="cpu")
    assert len(losses) == 300 and {r for r, _ in losses} == {4, 16}
    assert all(math.isfinite(v) for _, v in losses)
    tcli.main(["--phase", "test", "--ckpt",
               str(tmp_path / "real" / "s4" / "model_1.npz"), "--test_data",
               cli_files["pattern"], "--result_dir", str(tmp_path / "out")]
              + CLI4, device="cpu")
    out = read_ply(str(tmp_path / "out" / "shapes" / "shape.ply"))
    assert out.shape == (1024, 3) and np.isfinite(out).all()


# ------------------------------------------- the full-width fixture, on the CPU
def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def surface():
    smoke = _chip_smoke()
    return smoke, np.load(smoke.SURFACE_FIXTURE), np.load(smoke.FIXTURE)


def test_surface_fixture_is_consistent(surface):
    """tests/fixtures/torch_surface_ref.npz: the step-4 and AdaptiveLevel
    parameters load strictly at full width, and the arrays have the
    shapes phase 7 reads."""
    smoke, sfx, _ = surface
    net = smoke.step4_net(sfx, device="cpu")
    assert net.levels["level_1"].up_layer.up_layer1.conv.weight.shape == (
        128, 266, 1, 1)
    assert len(net.levels) == 2
    from threepu_torch.models import AdaptiveLevel
    AdaptiveLevel(**smoke.ADAPTIVE).load_state_dict(
        smoke.surface_state(sfx, "adaptive_params/"), strict=True)
    assert sfx["step4_cascade_sub_2"].shape == (20, 312, 3)
    assert sfx["step4_cascade_out_2"].shape == (20, 1248, 3)
    assert sfx["input_4"].shape == (16, 312, 3)
    assert sfx["gt_4"].shape == (16, 1248, 3)
    assert sfx["patches"].shape == (48, 312, 3)
    assert sfx["adaptive_out"].shape == (48, 1225, 3)
    assert sfx["vis_layer_4"].shape == (1, 8 * 312, 264)
    assert 0 < float(sfx["step4_jax_cd_gt"]) < 1
    assert abs(float(sfx["step4_jax_pert_cd_gt"])
               - float(sfx["step4_jax_cd_gt"])) < 0.01 * float(
                   sfx["step4_jax_cd_gt"])


@pytest.mark.parametrize("chain", [False, True], ids=["decomposed", "chain"])
def test_step4_cascade_replay_matches_fixture(surface, chain):
    """chip_smoke.py's phase 7a on the CPU: the full-width step-4 cascade
    of one patch on JAX's initial parameters, each level fed JAX's input,
    within the bands the card is held to (>= 99% of the rows within 1e-4
    of JAX's, the sub-patches JAX's)."""
    smoke, sfx, fx = surface
    net = smoke.step4_net(sfx, device="cpu").eval()
    view = {"cascade_in": fx["cascade_in"],
            **{k[len("step4_"):]: sfx[k] for k in sfx.files
               if k.startswith("step4_cascade_")}}
    stats = smoke.replay_cascade(net, view, torch.device("cpu"), chain)
    print(stats)
    assert [st["level"] for st in stats] == [1, 2]
    smoke.check_replay(stats)
    assert stats[1]["sub_points"] == 1.0


def test_step4_ratio4_gradients_match_fixture(surface):
    """chip_smoke.py's phase 7c's first half on the CPU: the full-width
    step-4 train step at ratio 4 on JAX's batch, loss within 1e-5
    (relative) of JAX's and every gradient tensor within 0.1 relative L2
    (the card's bands; measured here far inside them)."""
    smoke, sfx, _ = surface
    net = smoke.step4_net(sfx, device="cpu").train()
    loss, grads = smoke.step_grads(net, torch.from_numpy(sfx["input_4"]),
                                   torch.from_numpy(sfx["gt_4"]), 4, [])
    want = state_dict_from_jax({k[len("grad_4/"):]: sfx[k]
                                for k in sfx.files if k.startswith("grad_4/")})
    st = smoke.compare_grads(loss, grads, float(sfx["loss_4"]), want)
    print(st)
    assert st["loss_err"] <= smoke.R4_LOSS_BAND
    assert st["worst_err"] <= smoke.R4_TENSOR_BAND
    assert st["grad_err"] <= 1e-3


def test_adaptive_level_full_width_matches_fixture(surface):
    """chip_smoke.py's phase 7d on the CPU: AdaptiveLevel at full width on
    JAX's 48 patches, 1225 points each: output and global features within
    1e-4 of JAX's on >= 99% of the rows."""
    smoke, sfx, _ = surface
    from threepu_torch.models import AdaptiveLevel
    net = AdaptiveLevel(**smoke.ADAPTIVE).eval()
    net.load_state_dict(smoke.surface_state(sfx, "adaptive_params/"),
                        strict=True)
    with torch.no_grad():
        out, gfeat = net(torch.from_numpy(sfx["patches"]),
                         smoke.ADAPTIVE_TARGET)
    assert out.shape == (48, 1225, 3)
    assert smoke.row_share(out, sfx["adaptive_out"]) >= smoke.ROWS_BAND
    assert smoke.row_share(gfeat, sfx["adaptive_gfeat"]) >= smoke.ROWS_BAND
