"""The PyTorch port's training path held against the JAX package on the
CPU: the Chamfer loss, the train-mode ``Net`` forward with its re-patch
seeds pinned, ``train_step``'s loss, gradients and clipped Adam update,
the curriculum, batch sampling and augmentation.

Inputs come from a seeded numpy generator and go to both packages;
random draws (re-patch seeds, sampling seeds, rotation angles, noise)
are drawn with numpy and fed to both, JAX's by patching ``jax.random``
for the call.  Both nets carry the same float32 weights (the flax params
converted by ``state_dict_from_jax``).  Each tolerance is stated where
it is used.
"""

import contextlib
import importlib.util
import math
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from threepu.data import augment as jaug
from threepu.data import curriculum as jcur
from threepu.data.h5_dataset import _sample_impl
from threepu.losses import chamfer_loss as jchamfer_loss
from threepu.models import Net as JNet
from threepu.models.upsampler import Level as JLevel
from threepu.train import model as jmodel

from threepu_torch.data import augment as taug
from threepu_torch.data import curriculum as tcur
from threepu_torch.data.sampler import sample_batch
from threepu_torch.io.weights import (flatten_tree, load_jax_checkpoint,
                                      state_dict_from_jax)
from threepu_torch.losses import ChamferLoss, chamfer_loss
from threepu_torch.models import Net as TNet
from threepu_torch.models import load_net
from threepu_torch.models.upsampler import Level as TLevel
from threepu_torch.train import (Model, loss_weight, make_optimizer,
                                 train_loss, train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_up_ratio=8, step_ratio=2, knn=8, growth_rate=12, dense_n=3,
             max_num_point=32, fm_knn=5)
B, K = 3, 32


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@contextlib.contextmanager
def pinned_randint(seeds):
    """``jax.random.randint`` returns the arrays of ``seeds`` in call
    order (the re-patch seeds of ``Net._extract_patch_train``, the seed
    points of ``_sample_impl``)."""
    it = iter(seeds)

    def fake(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(next(it), dtype).reshape(shape)

    with mock.patch.object(jax.random, "randint", fake):
        yield


def repatch_seeds(rng, ratio, n_levels_in=K):
    """One ``(B, 1)`` seed array per re-patching level of the small net
    at ``ratio``: every level past the first re-patches (its input,
    ``2K`` points, exceeds ``max_num_point = K``)."""
    levels = int(math.log2(ratio))
    return [rng.integers(0, 2 * n_levels_in, (B, 1)).astype(np.int32)
            for _ in range(levels - 1)]


@pytest.fixture(scope="module")
def small():
    """The small JAX net with float32 params, the port's net on the same
    weights, and one batch: input (B, K, 3), gt (B, 8K, 3)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, K, 3)).astype(np.float32)
    gt = rng.standard_normal((B, 8 * K, 3)).astype(np.float32)
    net = JNet(**SMALL)
    with pinned_randint([np.zeros((B, 1))] * 2):
        params = net.init({"params": jax.random.PRNGKey(3),
                           "patch": jax.random.PRNGKey(4)},
                          jnp.asarray(x), 8, jnp.asarray(gt),
                          train=True)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    return net, params, x, gt


def port_net(params):
    net = TNet(**SMALL)
    net.load_state_dict(state_dict_from_jax(flatten_tree(params)), strict=True)
    return net


def jax_forward(net, params, x, gt, ratio, seeds):
    with pinned_randint(seeds):
        return net.apply({"params": params}, jnp.asarray(x), ratio,
                         jnp.asarray(gt), train=True,
                         rngs={"patch": jax.random.PRNGKey(0)})


def jax_loss_and_grads(net, params, x, gt, ratio, seeds, threshold=None):
    """``jax.value_and_grad`` of the loss of threepu.train.model.train_step:
    ``chamfer_loss(pred, gt_out, threshold) * loss_weight``."""
    weight = jmodel.loss_weight(ratio, net.max_up_ratio, net.step_ratio)

    def loss_fn(p):
        pred, gt_out = net.apply({"params": p}, jnp.asarray(x), ratio,
                                 jnp.asarray(gt), train=True,
                                 rngs={"patch": jax.random.PRNGKey(0)})
        return jchamfer_loss(pred, gt_out, threshold=threshold) * weight

    with pinned_randint(seeds):
        return jax.value_and_grad(loss_fn)(params)


# ---------------------------------------------------------- chamfer loss
@pytest.mark.parametrize("threshold", [None, 2.0], ids=["none", "thr2"])
def test_chamfer_loss_matches(rng, threshold):
    """Value to 1e-6 relative and gradients to 1e-5 relative against
    threepu.losses.chamfer_loss (JAX ranks in matmul form on the CPU,
    the port by direct subtraction: tie-free data).  With threshold 2.0
    some distances are zeroed in each direction; the pred comes in the
    reference's (B, 3, N) layout."""
    pred = rng.standard_normal((2, 50, 3)).astype(np.float32)
    gt = rng.standard_normal((2, 70, 3)).astype(np.float32)
    pred[0, :3] *= 4.0                                 # outliers
    val, grads = jax.value_and_grad(
        lambda p, g: jchamfer_loss(p, g, threshold=threshold),
        argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(gt))
    p = t(pred.transpose(0, 2, 1)).requires_grad_()
    g = t(gt).requires_grad_()
    got = ChamferLoss(threshold)(p, g)
    got.backward()
    np.testing.assert_allclose(got.item(), float(val), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 1),
                               np.asarray(grads[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(grads[1]),
                               rtol=1e-5, atol=1e-7)
    if threshold is not None:
        assert np.any(np.asarray(grads[0]) == 0)       # zeroed outliers
    assert chamfer_loss(t(pred), t(gt), forward_weight=0.5).item() < \
        chamfer_loss(t(pred), t(gt)).item()


def test_chamfer_loss_rejects_bad_layouts():
    with pytest.raises(ValueError, match="3D tensor"):
        chamfer_loss(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="3D points"):
        chamfer_loss(torch.zeros(1, 4, 5), torch.zeros(1, 4, 5))
    loss = ChamferLoss()
    loss.set_threshold(2.0)
    assert loss.threshold == 2.0
    loss.unset_threshold()
    assert loss.threshold is None


# ------------------------------------------------------- train forward
def test_level_gradient_reaches_prev_feat_only(rng):
    """A Level with the interlevel skip, its outputs' cotangents pulled
    back by jax.vjp and by autograd: the unnormalized xyz (read only by
    the skip's weights) and prev_xyz get no gradient, prev_feat and the
    normalized xyz get JAX's, to 1e-5."""
    kw = dict(dense_n=2, growth_rate=4, knn=8, fm_knn=3, step_ratio=2)
    n = 24
    xyz = rng.standard_normal((2, n, 3)).astype(np.float32)
    norm = (xyz / 3.0).astype(np.float32)
    prev = rng.standard_normal((2, n, 3)).astype(np.float32)
    feat_c = 24 + 4 * (24 + kw["dense_n"] * kw["growth_rate"])
    prev_feat = rng.standard_normal((2, n, feat_c)).astype(np.float32)
    jm = JLevel(**kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(xyz),
                     jnp.asarray(norm), None)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    cot = (rng.standard_normal((2, 2 * n, 3)).astype(np.float32),
           rng.standard_normal((2, n, feat_c)).astype(np.float32))
    _, vjp = jax.vjp(lambda *a: jm.apply({"params": params}, a[0], a[1],
                                         (a[2], a[3])),
                     *map(jnp.asarray, (xyz, norm, prev, prev_feat)))
    want = vjp(tuple(map(jnp.asarray, cot)))
    tm = TLevel(**kw)
    tm.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                       strict=True)
    args = [t(a).requires_grad_() for a in (xyz, norm, prev, prev_feat)]
    out = tm(args[0], args[1], (args[2], args[3]))
    torch.autograd.backward(out, [t(c) for c in cot])
    for i in (0, 2):
        assert not np.asarray(want[i]).any()
        assert args[i].grad is None
    for i in (1, 3):
        np.testing.assert_allclose(args[i].grad.numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ratio", [2, 8])
def test_train_forward_matches(small, ratio):
    """Net.forward(train=True) at ratio 2 (level 1 only) and at the top
    ratio 8 (two re-patching levels, seeds pinned on both sides): pred
    and the gt patch to 1e-5."""
    net, params, x, gt = small
    seeds = repatch_seeds(np.random.default_rng(ratio), ratio)
    gt_r = gt[:, :ratio * K]
    want_pred, want_gt = jax_forward(net, params, x, gt_r, ratio, seeds)
    tnet = port_net(params)
    pred, gt_out = tnet(t(x), ratio, t(gt_r),
                        seed_idx=[torch.from_numpy(s) for s in seeds])
    assert pred.shape == want_pred.shape and gt_out.shape == want_gt.shape
    np.testing.assert_allclose(gt_out.numpy(), np.asarray(want_gt),
                               atol=1e-5)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred),
                               atol=1e-5)


def test_train_forward_seed_handling(small):
    """Seeds from a generator are reproducible; seed_idx must hold one
    tensor per re-patching level; train=False is the eval cascade."""
    _, params, x, gt = small
    tnet = port_net(params)
    runs = [tnet(t(x), 8, t(gt), generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    one = [torch.zeros((B, 1), dtype=torch.long)]
    with pytest.raises(ValueError, match="fewer"):
        tnet(t(x), 8, t(gt), seed_idx=one)
    with pytest.raises(ValueError, match="more"):
        tnet(t(x), 4, t(gt[:, :4 * K]), seed_idx=one * 2)
    with pytest.raises(ValueError, match="needs gt"):
        tnet(t(x), 8)
    assert torch.equal(tnet(t(x), 4, train=False), tnet.upsample(t(x), 4))


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("ratio,threshold", [(2, None), (8, None), (8, 2.0)],
                         ids=["r2", "r8", "r8-thr2"])
def test_train_loss_and_gradients_match(small, ratio, threshold):
    """train_loss's weighted loss to 1e-5 relative and EVERY parameter's
    gradient (weights mapped by state_dict_from_jax) against
    jax.value_and_grad of the train step's loss: per tensor, the
    gradient's L2 error at most 1e-4 of its L2 norm (float32 sums in
    other orders through three levels; measured ~1e-6), and levels the
    ratio does not reach get exactly zero."""
    net, params, x, gt = small
    seeds = repatch_seeds(np.random.default_rng(10 + ratio), ratio)
    gt_r = gt[:, :ratio * K]
    val, grads = jax_loss_and_grads(net, params, x, gt_r, ratio, seeds,
                                    threshold)
    want = state_dict_from_jax(flatten_tree(grads))
    tnet = port_net(params)
    weighted, cd, _, _ = train_loss(
        tnet, t(x), t(gt_r), ratio, threshold,
        seed_idx=[torch.from_numpy(s) for s in seeds])
    weighted.backward()
    np.testing.assert_allclose(weighted.item(), float(val), rtol=1e-5)
    assert weighted.item() == pytest.approx(
        cd.item() * loss_weight(ratio, 8, 2))
    got = dict(tnet.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        if not w.any():
            assert g is None or not g.any(), name
            continue
        err = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
        assert err <= 1e-4, (name, err)


def test_optimizer_matches_optax():
    """make_optimizer (Adam + element clip at 1.0 before each step)
    against threepu.train.model.make_optimizer (optax) over 3 steps fed
    identical gradients, half of them beyond the clip: parameters to
    1e-6 relative (Adam's update formula rounds differently)."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = jmodel.make_optimizer(5e-4)
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = make_optimizer(tp.values(), 5e-4)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = t(g[k])
        opt.step()
        for k, v in tp.items():
            assert v.grad.abs().max() <= 1.0        # clipped in place
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert any((np.abs(g["a"]) > 1).any() for g in grads)


def test_train_step_matches_jax_train_step(small):
    """Two full steps (forward, loss, backward, clip, Adam) at the top
    ratio against threepu.train.model.train_step itself, the same
    re-patch seeds pinned in both steps: the returned losses to 1e-5
    relative, every parameter after the steps to 1e-5 absolute.  An Adam
    step moves a parameter by about lr = 5e-4 whatever its gradient's
    size; where a gradient element is near Adam's eps (1e-8), float32
    rounding of the gradient moves its update by up to a few percent of
    lr (measured: 2.1e-6 on one element of 3456)."""
    net, params, x, gt = small
    seeds = repatch_seeds(np.random.default_rng(7), 8)
    tx = jmodel.make_optimizer(5e-4)
    tnet = port_net(params)
    params = jax.tree.map(jnp.copy, params)       # train_step donates them
    state = jmodel.TrainState(params, tx.init(params), jnp.asarray(0))
    opt = make_optimizer(tnet.parameters(), 5e-4)
    for _ in range(2):
        with pinned_randint(seeds):
            state, cd = jmodel.train_step(net, tx, state,
                                          jax.random.PRNGKey(0),
                                          jnp.asarray(x), jnp.asarray(gt), 8)
        got = train_step(tnet, opt, t(x), t(gt), 8,
                         seed_idx=[torch.from_numpy(s) for s in seeds])
        np.testing.assert_allclose(got.item(), float(cd), rtol=1e-5)
    want = state_dict_from_jax(flatten_tree(state.params))
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["floored", "reference"])
def test_loss_weight_matches(mode):
    for r in (2, 4, 8, 16):
        assert loss_weight(r, 16, 2, mode) == jmodel.loss_weight(r, 16, 2,
                                                                 mode)
    with pytest.raises(ValueError):
        loss_weight(2, 16, 2, "nope")


def test_model_wrapper_on_cpu(small):
    """Model on device="cpu": (B, 3, N) input accepted, the running mean
    of the weighted loss as the JAX Model keeps it, the eval forward, and
    the curriculum threshold reaching the loss."""
    _, params, x, gt = small
    m = Model(port_net(params), device="cpu", seed=1)
    losses = []
    for ratio in (2, 4):
        m.set_input(x.transpose(0, 2, 1), ratio,
                    gt[:, :ratio * K].transpose(0, 2, 1))
        losses.append(m.optimize())
    assert m.step == 2
    assert m.error_log["cd_loss_x2"] == pytest.approx(losses[0])
    assert m.error_log["cd_loss_x4"] == pytest.approx(losses[1] / 2)
    assert m.forward().shape == (B, 4 * K, 3)
    assert m.chamfer_threshold is None
    m.set_input(x, 2, gt[:, :2 * K])
    m.chamfer_threshold = 0.5            # zeroes every distance above half
    thresholded = m.optimize()           # the mean: the loss must drop
    m.chamfer_threshold = None
    assert thresholded < m.optimize()


def test_model_and_load_net_default_to_the_card(monkeypatch):
    """Without a GPU, Model and load_net raise unless device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_net(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(TNet(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_net(device="cuda", **SMALL)
    net = load_net("artifacts/prod_clean_final.npz", device="cpu",
                   max_up_ratio=16, knn=32)
    assert next(net.parameters()).device.type == "cpu"
    want = load_jax_checkpoint("artifacts/prod_clean_final.npz")
    got = net.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("step", [0, 14999, 15000, 15001, 24000, 24001,
                                  44999, 45000, 75000, 105000, 200000])
def test_curriculum_matches(step):
    """Stage edges (S = 15000: stage k starts at (2k-1)S) and the
    combined (progress > 0.5) and threshold (> 0.6) edges."""
    for up in (4, 16):
        assert tcur.curriculum_state(step, 15000, up) == \
            tuple(jcur.curriculum_state(step, 15000, up))
    assert tcur.stage_progress(step, 15000) == jcur.stage_progress(step,
                                                                   15000)
    state = tcur.curriculum_state(step, 15000, 16)
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert state.choose_ratio(rng_a) == jcur.curriculum_state(
        step, 15000, 16).choose_ratio(rng_b)
    assert state.max_ratio == state.scales[-1]


@pytest.mark.parametrize("jitter,is_2d,drop_out",
                         [(False, False, 1.0), (True, False, 0.75),
                          (True, True, 1.0)],
                         ids=["rotate", "jitter+drop", "2d"])
def test_sample_batch_matches(rng, jitter, is_2d, drop_out):
    """sample_batch against _sample_impl (run unjitted, its draws
    replaced by numpy's: seed points, angles, noise, drop-out order) on
    one shape: patches to 1e-6 (the kNN ranks in matmul form on both
    sides, so the same points in the same order), then augment."""
    n, ratio, k, bsz = 400, 4, 24, 5
    shape = rng.standard_normal((1, n, 3)).astype(np.float32)
    label = rng.standard_normal((1, n * ratio, 3)).astype(np.float32)
    if is_2d:
        shape[..., 2] = 0
        label[..., 2] = 0
    seeds = rng.integers(0, n, (bsz,))
    angles = rng.uniform(0, 2 * np.pi, (bsz, 3)).astype(np.float32)
    noise = rng.standard_normal((bsz, k, 3)).astype(np.float32)
    perm = rng.permutation(k)
    patches = {"uniform": lambda *a, **kw: jnp.asarray(angles),
               "normal": lambda *a, **kw: jnp.asarray(noise),
               "permutation": lambda *a, **kw: jnp.asarray(perm)}
    with pinned_randint([seeds]), \
            mock.patch.multiple(jax.random, **patches):
        want = _sample_impl.__wrapped__(
            jnp.asarray(shape), jnp.asarray(label), jax.random.PRNGKey(0),
            jnp.asarray(0), ratio=ratio, batch_size=bsz, num_patch_point=k,
            phase="train", jitter=jitter, jitter_sigma=0.01, jitter_max=0.02,
            drop_out=drop_out, is_2d=is_2d)
    got = sample_batch(t(shape[0]), t(label[0]), ratio, bsz, k,
                       jitter=jitter, jitter_sigma=0.01, jitter_max=0.02,
                       drop_out=drop_out, is_2d=is_2d,
                       seed_idx=torch.from_numpy(seeds), angles=t(angles),
                       noise=t(noise), perm=torch.from_numpy(perm))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_sample_batch_draws_from_its_generator(rng):
    shape = t(rng.standard_normal((100, 3)))
    label = t(rng.standard_normal((200, 3)))
    runs = [sample_batch(shape, label, 2, 4, 10, drop_out=0.5,
                         generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].shape == (4, 5, 3) and runs[0][1].shape == (4, 20, 3)
    inp, lab = sample_batch(shape, label, 2, 4, 10, phase="test",
                            seed_idx=torch.arange(4))
    assert torch.allclose(lab.norm(dim=-1).amax(-1), torch.ones(4))


def test_rotations_match(rng):
    angles = rng.uniform(0, 2 * np.pi, (6, 3)).astype(np.float32)
    with mock.patch.object(jax.random, "uniform",
                           lambda *a, **kw: jnp.asarray(angles)):
        want = jaug.random_rotations(jax.random.PRNGKey(0), 6)
    got = taug.rotations(t(angles))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    eye = got @ got.transpose(1, 2)
    torch.testing.assert_close(eye, torch.eye(3).expand(6, 3, 3), atol=1e-6,
                               rtol=0)
    assert taug.random_angles(4, torch.Generator().manual_seed(0)).max() < \
        2 * math.pi


# --------------------------------------------- the GPU check's fixture
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def train_ref():
    smoke = _chip_smoke()
    return smoke, np.load(smoke.FIXTURE), np.load(smoke.TRAIN_FIXTURE)


@pytest.mark.parametrize("ratio", [2, 16])
def test_sample_batch_reproduces_fixture(train_ref, ratio):
    """chip_smoke.py's phase-5 batches on the CPU: sample_batch with the
    fixture's seed points and angles, on shape 0 normalized as the JAX
    data loader does, gives JAX's batches: the same points in the same
    order, to 1e-6."""
    smoke, fx, tfx = train_ref
    shape, lab2, lab16 = smoke.normalize_by_input(
        fx["input"][None], tfx["label_2"][None], fx["gt"][None])
    x, gt = sample_batch(
        t(shape[0]), t((lab2, lab16)[ratio == 16][0]), ratio, 16, 312,
        seed_idx=torch.from_numpy(tfx[f"sample_seed_{ratio}"]),
        angles=t(tfx[f"angles_{ratio}"]))
    np.testing.assert_allclose(x.numpy(), tfx[f"input_{ratio}"], atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), tfx[f"gt_{ratio}"], atol=1e-6)
    assert smoke.coincide(x, t(tfx[f"input_{ratio}"])) == 1.0


def test_ratio2_step_matches_fixture(train_ref):
    """chip_smoke.py's phase 5a at ratio 2 on the CPU, full width with the
    trained weights: within the bands the GPU run is held to (loss 1e-5
    relative, each gradient tensor 0.1 relative L2, all gradients
    together within the float-noise control)."""
    smoke, _, tfx = train_ref
    net = load_net(smoke.WEIGHTS, device="cpu", **smoke.NET)
    st = smoke.grad_errors(net, tfx, 2, torch.device("cpu"))
    print(st)
    assert st["loss_err"] <= smoke.R2_LOSS_BAND
    assert st["worst_err"] <= smoke.R2_TENSOR_BAND
    assert st["grad_err"] <= float(np.max(tfx["control_grad_2"]))


def test_train_fixture_is_consistent(train_ref):
    """tests/fixtures/torch_train_ref.npz: shapes, seeds in range, a
    gradient for every parameter at both ratios (zero beyond level 1 at
    ratio 2), and a float-noise control above zero."""
    smoke, fx, tfx = train_ref
    names = set(dict(TNet(**smoke.NET).named_parameters()))
    assert tfx["label_2"].shape == (10000, 3)
    for ratio, levels in ((2, 0), (16, 3)):
        assert tfx[f"input_{ratio}"].shape == (16, 312, 3)
        assert tfx[f"gt_{ratio}"].shape == (16, 312 * ratio, 3)
        assert tfx[f"repatch_{ratio}"].shape == (levels, 16, 1)
        assert (tfx[f"repatch_{ratio}"] < 624).all()
        prefix = f"grad_{ratio}/"
        grads = state_dict_from_jax({k[len(prefix):]: tfx[k]
                                     for k in tfx.files
                                     if k.startswith(prefix)})
        assert set(grads) == names
        deep = [g.abs().max() for k, g in grads.items()
                if not k.startswith("levels.level_1.")]
        assert (max(deep) == 0) == (ratio == 2)
        assert (tfx[f"control_grad_{ratio}"] > 0).all()
    assert tfx["adam_repatch"].shape == (5, 3, 16, 1)
    assert np.isfinite(tfx["adam_loss"]).all()
    assert (tfx["sample_seed_16"] < fx["input"].shape[0]).all()


def test_profile_step_helpers(train_ref):
    """chip_smoke.py's profile of a train step (phase 5c, --profile):
    device intervals merged into busy time, kernels sorted into kinds."""
    smoke = train_ref[0]
    assert smoke.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert smoke.union_us([]) == 0
    assert smoke.kind_of("void (anonymous namespace)::nn_kernel(") == \
        "chamfer kernel"
    assert smoke.kind_of("sm90_xmma_gemm_f32f32") == "cuBLAS GEMM"
    assert smoke.kind_of("Memcpy DtoD") == "memcpy, memset"
    assert smoke.kind_of("vectorized_elementwise_kernel") == \
        "other elementwise"


def test_replayed_decisions_reproduce_the_step(small, train_ref):
    """chip_smoke.py's ratio-16 check with every decision pinned, on the
    small net at its top ratio: the decisions of one step (selections,
    interlevel picks, Chamfer argmins), recorded and replayed into a step
    drawn with other re-patch seeds, give the first step's loss and
    gradients exactly, and count the decisions the second step would
    have made otherwise; decisions that do not fit, or too many, are
    refused; the bands reject an off-band reading."""
    smoke = train_ref[0]
    _, params, x, gt = small
    seeds = [[torch.from_numpy(a) for a in repatch_seeds(
        np.random.default_rng(s), 8)] for s in (1, 2)]

    def step(s):
        return smoke.step_grads(port_net(params), t(x), t(gt), 8, s)

    with smoke.recorded_decisions() as rec:
        want = step(seeds[0])
    # per step: 4 edge convs x 3 levels, 2 re-patches with a gt patch each
    assert [len(rec[k]) for k in ("select", "interlevel", "chamfer")] == \
        [16, 2, 2]
    assert step(seeds[1])[0] != want[0]            # the seeds matter
    with smoke.replayed_decisions(rec) as agree:
        got = step(seeds[1])
    st = smoke.compare_grads(*got, *want)
    assert st["loss_err"] == 0 and st["grad_err"] == 0
    assert agree["chamfer"][1] == 2 * B * 2 * K
    assert 0 < agree["select"][0] < agree["select"][1]
    with smoke.replayed_decisions(rec) as agree:
        step(seeds[0])
    assert all(eq == n for eq, n in agree.values())
    smoke.check_pinned(dict(st, agree={k: 1.0 for k in agree}))
    shuffled = dict(rec, select=rec["select"][::-1])
    with pytest.raises(ValueError, match="select decisions do not fit"):
        with smoke.replayed_decisions(shuffled):
            step(seeds[0])
    with pytest.raises(ValueError, match="fewer"):
        with smoke.replayed_decisions({k: v * 2 for k, v in rec.items()}):
            step(seeds[0])
    for key in ("loss_err", "grad_err", "worst_err"):
        with pytest.raises(AssertionError, match=key):
            smoke.check_pinned(dict(st, agree={}, **{key: 1.0}))
    with pytest.raises(AssertionError, match="interlevel"):
        smoke.check_pinned(dict(st, agree={"interlevel": 0.9}))
