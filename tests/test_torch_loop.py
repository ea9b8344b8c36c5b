"""The port's training loop (``threepu_torch.train.loop``) held against
the JAX package's (``threepu.train.loop``) on the CPU, and the training
monitor.

The file is ``tests/test_train.py``'s (3 shapes at 32, 64, 128 points) as
``.hdf5`` for JAX and ``.npz`` for the port; the net is its tiny one (knn
4, growth 4, dense 2, 12-point patches, up to ratio 4).  Both loops start
from one JAX-written full-state checkpoint; JAX's batches are recorded
and fed to the port.
"""

import dataclasses
import sys
import types
import unittest.mock as mock

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threepu.train.loop as jloop
from threepu.io import checkpoint as jck
from threepu.models import Net as JNet
from threepu.train import model as jmodel

import threepu_torch.data.h5_dataset as th5
import threepu_torch.train.loop as tloop
from threepu_torch.io import checkpoint as tck
from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.models import Net as TNet
from threepu_torch.vis import VisdomMonitor

NET = dict(up_ratio=4, step_ratio=2, knn=4, growth_rate=4, dense_n=2,
           max_num_point=12)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The training file as .hdf5 and .npz, and a JAX full-state
    checkpoint at step 2: the tiny net's float32 parameters and an Adam
    state with count 2 and moments on every leaf."""
    root = tmp_path_factory.mktemp("loop")
    name = "train_poisson_32_poisson_64_poisson_128"
    rng = np.random.default_rng(0)
    sets = {}
    for res in (32, 64, 128):
        pts = rng.standard_normal((3, res, 3)).astype(np.float32)
        sets[f"poisson_{res}"] = pts / np.linalg.norm(pts, axis=-1,
                                                      keepdims=True)
    with h5py.File(root / f"{name}.hdf5", "w") as f:
        for k, v in sets.items():
            f.create_dataset(k, data=v)
    np.savez(root / f"{name}.npz", **sets)

    net = JNet(max_up_ratio=4, step_ratio=2, knn=4, growth_rate=4,
               dense_n=2, max_num_point=12)
    x = jnp.asarray(rng.standard_normal((2, 12, 3)).astype(np.float32))
    gt = jnp.asarray(rng.standard_normal((2, 48, 3)).astype(np.float32))
    params = net.init({"params": jax.random.PRNGKey(0),
                       "patch": jax.random.PRNGKey(1)}, x, 4, gt,
                      train=True)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    opt = jmodel.make_optimizer(1e-3).init(params)
    adam = opt[1][0]
    mu = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * 1e-3, jnp.float32), adam.mu)
    nu = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(1e-8, 1e-6, a.shape), jnp.float32), adam.nu)
    opt = (opt[0], (adam._replace(count=jnp.asarray(2, jnp.int32), mu=mu,
                                  nu=nu), opt[1][1]))
    ckpt = str(root / "start.npz")
    jck.save_train_checkpoint(ckpt, {"params": params}, opt, step=2)
    return dict(hdf5=str(root / f"{name}.hdf5"),
                npz=str(root / f"{name}.npz"), ckpt=ckpt, params=params,
                opt=opt, root=root)


def configs(files, tmp_path, **kw):
    """The JAX and the port ``TrainConfig`` of one run."""
    base = dict(num_shape_point=32, num_point=12, batch_size=2,
                lr_init=1e-3, max_epoch=100, model_dir=str(tmp_path), **NET)
    base.update(kw)
    return (jloop.TrainConfig(h5_data=files["hdf5"], **base),
            tloop.TrainConfig(h5_data=files["npz"], **base))


def test_train_config_fields_match_jax():
    """Every field of JAX's TrainConfig but ``mesh``, in order, with its
    default; ``patch_point`` alike."""
    want = [(f.name, f.default) for f in dataclasses.fields(jloop.TrainConfig)
            if f.name != "mesh"]
    got = [(f.name, f.default) for f in dataclasses.fields(tloop.TrainConfig)]
    assert got == want
    for kw in (dict(num_point=12), dict(drop_out=0.5)):
        assert tloop.TrainConfig("x", 32, **kw).patch_point == \
            jloop.TrainConfig("x", 32, **kw).patch_point


def test_ratio_and_threshold_sequence_matches_jax(files, tmp_path):
    """Steps 0..40 with ``stage_steps=4`` (stages 0-4, ratios 2 and 4,
    threshold on past 0.6 of a stage): each step's ratio and threshold
    equal JAX's, and so does the running-mean error log of a constant
    loss; the train steps are replaced by a recorder."""
    jcfg, tcfg = configs(files, tmp_path, stage_steps=4, log_steps=5)
    seen = {"jax": [], "port": []}

    def fake_jax(net, tx, state, key, inp, gt, ratio, threshold=None,
                 **kw):
        seen["jax"].append((ratio, threshold, inp.shape, gt.shape))
        return state, jnp.asarray(0.25, jnp.float32)

    def fake_port(net, opt, inp, gt, ratio, threshold=None, **kw):
        seen["port"].append((ratio, threshold, tuple(inp.shape),
                             tuple(gt.shape)))
        return torch.tensor(0.25)

    with mock.patch.object(jloop, "train_step", fake_jax):
        _, jlog = jloop.train_loop(jcfg, max_steps=41)
    with mock.patch.object(tloop, "train_step", fake_port):
        state, tlog = tloop.train_loop(tcfg, max_steps=41, device="cpu")
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == 41 and state.step == 41
    assert {r for r, _, _, _ in seen["port"]} == {2, 4}
    assert {t for _, t, _, _ in seen["port"]} == {None, 2.0}
    assert dict(tlog) == dict(jlog)


@pytest.fixture(scope="module")
def ratio2_runs(files, tmp_path_factory):
    """Three ratio-2 steps of JAX's loop from the step-2 checkpoint
    (stages of 100 steps: ratio 2, no threshold), its batches and losses
    recorded; then the port's loop from the same file fed those
    batches."""
    tmp = tmp_path_factory.mktemp("r2")
    jcfg, tcfg = configs(files, tmp, stage_steps=100, ckpt=files["ckpt"])
    batches, jlosses, tlosses = {}, [], []
    step_fn = jloop.train_step

    def record(net, tx, state, key, inp, gt, ratio, **kw):
        batches[len(batches) + 2] = (np.asarray(inp), np.asarray(gt))
        state, cd = step_fn(net, tx, state, key, inp, gt, ratio, **kw)
        jlosses.append(float(cd))
        return state, cd

    with mock.patch.object(jloop, "train_step", record):
        jstate, jlog = jloop.train_loop(jcfg, max_steps=5)

    def fed(self, step, ratio, generator=None, **draws):
        # the prefetcher also issues the batch after the last step
        return tuple(torch.from_numpy(np.array(a))
                     for a in batches.get(step, batches[2]))

    tstep = tloop.train_step

    def record_port(*args, **kw):
        cd = tstep(*args, **kw)
        tlosses.append(float(cd))
        return cd

    with mock.patch.object(th5.DeviceDataset, "sample", fed), \
            mock.patch.object(tloop, "train_step", record_port):
        tstate, tlog = tloop.train_loop(tcfg, max_steps=5, device="cpu")
    return dict(jstate=jstate, jlog=jlog, jlosses=jlosses, tstate=tstate,
                tlog=tlog, tlosses=tlosses)


def test_three_ratio2_steps_match_jax(files, ratio2_runs):
    """Per-step loss to 1e-5 relative, every parameter after the steps to
    1e-5 absolute (Adam's momentum moves the levels the ratio does not
    reach, in both), ``error_log`` to 1e-6."""
    r = ratio2_runs
    assert len(r["tlosses"]) == len(r["jlosses"]) == 3
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=1e-5)
    assert r["tstate"].step == int(r["jstate"].step) == 5
    want = state_dict_from_jax(flatten_tree(r["jstate"].params))
    start = state_dict_from_jax(flatten_tree(files["params"]))
    moved = 0
    for name, p in r["tstate"].net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
        if name.startswith("levels.level_2."):
            moved += not torch.equal(p.detach(), start[name])
    assert moved > 0
    assert r["tlog"].keys() == r["jlog"].keys() == {"cd_loss_x2"}
    for k in r["jlog"]:
        np.testing.assert_allclose(r["tlog"][k], r["jlog"][k], atol=1e-6)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_epoch_checkpoint_files_match_jax(files, tmp_path, fmt):
    """``save_epoch_checkpoint`` of the same weights and Adam state: the
    same file name and contents as JAX's (``model_7.npz`` with the
    optimizer leaves and fingerprint, or ``model_7.pth``)."""
    jcfg, tcfg = configs(files, tmp_path, ckpt_format=fmt)
    jcfg.model_dir, tcfg.model_dir = (str(tmp_path / d) for d in ("j", "t"))
    jstate = jmodel.TrainState(files["params"], files["opt"],
                               jnp.asarray(9))
    net = TNet(max_up_ratio=4, step_ratio=2, knn=4, growth_rate=4,
               dense_n=2, max_num_point=12)
    state, _ = tck.load_checkpoint(files["ckpt"], net)
    net.load_state_dict(state, strict=True)
    opt = tloop.make_optimizer(net.parameters(), 1e-3)
    assert tck.load_opt_state(files["ckpt"], net, opt) is opt
    want = jloop.save_epoch_checkpoint(jcfg, jstate, 9, 7)
    got = tloop.save_epoch_checkpoint(tcfg, tloop.TrainState(net, opt, 9),
                                      9, 7)
    assert got.endswith(f"model_7.{fmt}") and want.endswith(f"model_7.{fmt}")
    if fmt == "npz":
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k],
                                                                   w[k]), k
    else:
        g, w = (torch.load(p, weights_only=False) for p in (got, want))
        assert g["step"] == w["step"] == "9"
        assert sorted(g["states"]) == sorted(w["states"])
        assert all(torch.equal(g["states"][k], w["states"][k])
                   for k in w["states"])


def test_log_fn_receives_pred_and_running_mean(files, tmp_path):
    """Log steps (every ``log_steps``) pass the training forward's
    prediction and re-patched gt and the ratio's running mean, as JAX's
    loop does (``tests/test_train.py``'s check); other steps none."""
    calls = []

    def log_fn(step, ratio, loss, state, batch, pred=None, gt_out=None,
               error=None):
        calls.append((step, ratio, loss, pred, gt_out, error, state.step))

    _, tcfg = configs(files, tmp_path, stage_steps=100, log_steps=2)
    _, error_log = tloop.train_loop(tcfg, max_steps=4, log_fn=log_fn,
                                    device="cpu")
    assert [c[0] for c in calls] == [2, 4]
    for step, ratio, loss, pred, gt_out, error, at in calls:
        assert at == step and ratio == 2
        assert pred is not None and pred.shape == (2, 24, 3)
        assert gt_out is not None and gt_out.shape == (2, 24, 3)
        assert isinstance(loss, float) and np.isfinite(loss)
        assert np.isfinite(error)
    assert calls[-1][5] == error_log["cd_loss_x2"] != calls[0][5]


@pytest.mark.parametrize("steps", [7, 10])
def test_deferred_flush_gives_the_same_error_log(files, tmp_path, steps):
    """Reading the losses every 5 steps (and at the end) gives the error
    log of reading them every step, bit for bit."""
    logs = []
    for cadence in (1, 5):
        _, tcfg = configs(files, tmp_path, stage_steps=4, log_steps=cadence)
        logs.append(dict(tloop.train_loop(tcfg, max_steps=steps,
                                          device="cpu")[1]))
    assert logs[0] == logs[1] and len(logs[0]) == 2


def test_exact_resume_matches_uninterrupted(files, tmp_path):
    """On the CPU, 3 steps + a full-state checkpoint + 3 more from it give
    the parameters and Adam state of 6 straight steps bit for bit (the
    draws of each step come from the step alone)."""
    _, cfg = configs(files, tmp_path, stage_steps=4)
    straight, _ = tloop.train_loop(cfg, max_steps=6, device="cpu")
    half, _ = tloop.train_loop(cfg, max_steps=3, device="cpu")
    path = str(tmp_path / "full.npz")
    tck.save_train_checkpoint(path, half.net, half.opt, step=half.step)
    resumed, _ = tloop.train_loop(dataclasses.replace(cfg, ckpt=path),
                                  max_steps=6, device="cpu")
    assert resumed.step == straight.step == 6
    a = dict(straight.net.named_parameters())
    for name, p in resumed.net.named_parameters():
        assert torch.equal(p, a[name]), name
        sa, sb = straight.opt.state[a[name]], resumed.opt.state[p]
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name


def test_resume_from_pth_restores_parameters_and_step(files, tmp_path):
    """A ``.pth`` restores the parameters and the step; the optimizer
    starts fresh, as JAX's loop does."""
    _, cfg = configs(files, tmp_path, stage_steps=4)
    first, _ = tloop.train_loop(cfg, max_steps=2, device="cpu")
    path = tck.save_pth(str(tmp_path / "x.pth"), first.net, step=2)
    state, _ = tloop.train_loop(dataclasses.replace(cfg, ckpt=path),
                                max_steps=2, device="cpu")
    assert state.step == 2 and not state.opt.state
    a = dict(first.net.named_parameters())
    assert all(torch.equal(p, a[n]) for n, p in state.net.named_parameters())


def test_fresh_runs_start_alike(files, tmp_path):
    """A fresh net is initialized from ``cfg.seed`` alone, without touching
    the global generator; another seed gives other weights."""
    _, cfg = configs(files, tmp_path)
    torch.manual_seed(123)
    before = torch.rand(1)
    torch.manual_seed(123)
    a, _ = tloop.train_loop(cfg, max_steps=0, device="cpu")
    assert torch.equal(torch.rand(1), before)
    b, _ = tloop.train_loop(cfg, max_steps=0, device="cpu")
    c, _ = tloop.train_loop(dataclasses.replace(cfg, seed=1), max_steps=0,
                            device="cpu")
    pb, pc = (dict(s.net.named_parameters()) for s in (b, c))
    same = [torch.equal(p, pb[n]) for n, p in a.net.named_parameters()]
    assert all(same)
    assert not all(torch.equal(p, pc[n]) for n, p in a.net.named_parameters()
                   if n.endswith(".weight"))


def test_train_loop_runs_on_the_card_by_default(files, tmp_path,
                                                monkeypatch):
    _, cfg = configs(files, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.train_loop(cfg, max_steps=1, device=device)


@pytest.mark.parametrize("num_point,ratio,max_np,want", [
    (12, 4, 12, [24]), (12, 16, 12, [24, 24, 24]), (12, 2, 12, []),
    (312, 16, 312, [624, 624, 624]), (10, 8, 16, [20, 20])],
    ids=["tiny-x4", "tiny-x16", "x2", "full-x16", "patch-below-max"])
def test_repatch_sizes_follow_the_net(num_point, ratio, max_np, want):
    """The re-patch draws the loop makes are those the train ``Net`` makes
    itself: one a re-patching level, over the level's point count."""
    assert tloop.repatch_sizes(num_point, ratio, 2, max_np) == want
    if num_point > 64:
        return
    net = TNet(max_up_ratio=ratio, step_ratio=2, knn=4, growth_rate=4,
               dense_n=2, max_num_point=max_np)
    drawn = []
    real = torch.randint

    def spy(low, high, size, **kw):
        drawn.append(high)
        return real(low, high, size, **kw)

    with mock.patch.object(torch, "randint", spy):
        net(torch.randn(1, num_point, 3), ratio,
            torch.randn(1, num_point * ratio, 3))
    assert drawn == want


# ---------------------------------------------------------------- monitor
def test_visdom_monitor_without_visdom_is_a_no_op(capsys):
    with mock.patch.dict(sys.modules, {"visdom": None}):
        monitor = VisdomMonitor(env="x")
    assert "visdom unavailable" in capsys.readouterr().out
    monitor.log_train_step(1, 2, 0.5, None, (torch.zeros(1, 3, 3),) * 2)


def test_visdom_monitor_plots_a_log_step():
    """With visdom: input, output and gt windows of the first patch (host
    arrays), and the running mean appended to the ratio's curve."""
    calls = []

    class Visdom:
        def __init__(self, env):
            calls.append(("env", env))

        def scatter(self, x, win, opts):
            calls.append(("scatter", win, type(x), x.shape))

        def line(self, y, x, update, win, opts):
            calls.append(("line", win, float(y[0]), int(x[0]), update))

    with mock.patch.dict(sys.modules,
                         {"visdom": types.SimpleNamespace(Visdom=Visdom)}):
        monitor = VisdomMonitor(env="run")
    inp, gt = torch.zeros(2, 12, 3), torch.ones(2, 24, 3)
    monitor.log_train_step(50, 2, 0.5, None, (inp, gt),
                           pred=torch.zeros(2, 24, 3), gt_out=gt,
                           error=0.25)
    assert calls == [("env", "run"),
                     ("scatter", "x2_input", np.ndarray, (12, 3)),
                     ("scatter", "x2_output", np.ndarray, (24, 3)),
                     ("scatter", "x2_gt", np.ndarray, (24, 3)),
                     ("line", "x2_loss", 0.25, 50, "append")]
