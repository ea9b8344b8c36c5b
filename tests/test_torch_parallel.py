"""The port's patch-parallel paths (``threepu_torch.parallel``) held
against the port's serial paths and against :mod:`threepu.parallel` on
the CPU.

The port's ranks are processes of a ``gloo`` group started by
``threepu_torch.parallel.launch.spawn``; their functions live in
``tests/torch_parallel_workers.py``, which imports no JAX.  One spawn a
world size (2 and 4) runs every case, while this process runs JAX on the
suite's 8-device virtual CPU mesh (``tests/conftest.py``) and the port's
serial paths.  The inputs are ``tests/test_inference.py``'s (its tiny
net, 128-point unit-sphere shape and 8 x 16 -> 64 train batch) and the
loop is ``tests/test_train.py``'s, made from numpy seeds; the nets carry
the same float32 weights through ``io.weights``.  Each tolerance is
stated where it is used.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import concurrent.futures
import contextlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threepu.parallel as jpar
from threepu.inference import plan_patches as jplan_patches
from threepu.inference import upsample_shape as jupsample_shape
from threepu.models import Net as JNet
from threepu.train.model import create_train_state
from threepu.train.model import make_optimizer as jmake_optimizer

import torch_parallel_workers as workers
from threepu_torch import inference as tinf
from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.parallel import make_mesh
from threepu_torch.parallel.launch import spawn
from threepu_torch.train import (TrainConfig, make_optimizer, train_loop,
                                 train_step)

WORLDS = (2, 4)
#: tests/test_inference.py's tiny net, in both packages' argument names;
#: on 16-point inputs at ratio 4 its second level re-patches (32 points
#: over min(16, max_num_point)), so a train step draws one (B, 1) seed
NET = dict(max_up_ratio=4, step_ratio=2, knn=4, growth_rate=4, dense_n=2,
           max_num_point=64, fm_knn=3)
LR = 1e-3
GENERATOR_SEED = 11
#: tests/test_train.py's loop under a mesh (test_loop_under_mesh_matches_
#: serial) and its steps
LOOP = dict(num_shape_point=32, num_point=12, batch_size=2, up_ratio=4,
            step_ratio=2, knn=4, growth_rate=4, dense_n=2, max_num_point=12,
            stage_steps=4, max_epoch=1, lr_init=1e-3, ckpt_epochs=100)
LOOP_STEPS = 6
CASES = ("ratio2", "repatch", "bucketed")


def f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def port_weights(params) -> dict:
    return {k: v.numpy() for k, v in
            state_dict_from_jax(flatten_tree(params)).items()}


def upsample_cases() -> dict:
    """tests/test_inference.py's three sharded cases, as the workers take
    them: 2x at 16-point patches with 24 patches asked for, the 4x
    re-patch cascade at 64-point patches, and ``upsample_shape`` of 100
    points bucketed to 128."""
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((128, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    return {
        "ratio2": dict(kind="cloud", points=pts, ratio=2, num_point=16,
                       num_patches=24, num_out=256),
        "repatch": dict(kind="cloud", points=pts, ratio=4, num_point=64,
                        num_patches=None, num_out=512),
        "bucketed": dict(kind="shape", points=pts[:100], ratio=2,
                         num_point=16, chunk=4, bucket=64)}


def write_loop_data(root) -> str:
    """tests/test_train.py's training file (3 shapes at 32, 64 and 128
    points) as ``.npz``."""
    rng = np.random.default_rng(0)
    sets = {}
    for res in (32, 64, 128):
        pts = rng.standard_normal((3, res, 3)).astype(np.float32)
        sets[f"poisson_{res}"] = pts / np.linalg.norm(pts, axis=-1,
                                                      keepdims=True)
    path = root / "train_poisson_32_poisson_64_poisson_128.npz"
    np.savez(path, **sets)
    return str(path)


@contextlib.contextmanager
def pinned_randint(seeds):
    """``jax.random.randint`` returns the arrays of ``seeds`` in call order
    (the train cascade's re-patch seeds), as tests/test_torch_train.py
    pins them."""
    it = iter(seeds)

    def fake(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(next(it), dtype).reshape(shape)

    with mock.patch.object(jax.random, "randint", fake):
        yield


def jax_sharded(jnet, params, jstate, train, cases, w) -> dict:
    """``threepu.parallel`` on a mesh of ``w`` virtual devices: each
    upsampler case and one sharded train step."""
    mesh = jpar.make_mesh(w)
    out = {}
    for name, c in cases.items():
        if c["kind"] == "shape":
            out[name] = jupsample_shape(jnet, params, c["points"], c["ratio"],
                                        num_point=c["num_point"],
                                        chunk=c["chunk"], bucket=c["bucket"],
                                        mesh=mesh)[1]
        else:
            fn = jpar.make_sharded_upsampler(jnet, mesh, c["ratio"],
                                             c["num_point"], c["num_patches"],
                                             c["num_out"])
            out[name] = np.asarray(fn(params, jnp.asarray(c["points"])))
    tx = jmake_optimizer(LR)
    step = jpar.make_sharded_train_step(jnet, tx, mesh)
    state = jax.tree.map(lambda x: x.copy(), jstate)
    with pinned_randint(train["seeds"]):        # traced on this first call
        state, cd = step(jnet, tx, state, jax.random.PRNGKey(5),
                         jnp.asarray(train["input"]),
                         jnp.asarray(train["gt"]), 4)
    out["train"] = dict(loss=float(cd), params=port_weights(state.params))
    return out


def port_serial(weights, cases, train, loop_cfg) -> dict:
    """The port's serial paths on the same inputs: each upsampler case at
    the chunk the ranks of each world size take, the train steps and the
    loop."""
    out = {}
    net = workers.port_net(NET, weights, "cpu").eval()
    for w in WORLDS:
        for name, c in cases.items():
            if c["kind"] == "shape":
                got = tinf.upsample_shape(net, c["points"], c["ratio"],
                                          num_point=c["num_point"],
                                          chunk=c["chunk"],
                                          bucket=c["bucket"])[1]
            else:
                n = c["points"].shape[0]
                pnr = (c["num_patches"] * c["num_point"] / n + 1e-9
                       if c["num_patches"] else 3.0)
                chunk = tinf.plan_patches(n, c["num_point"], pnr, None, w)[2]
                got = tinf.upsample_point_cloud(
                    net, torch.from_numpy(c["points"]), c["ratio"],
                    c["num_point"], c["num_out"], patch_num_ratio=pnr,
                    chunk=chunk).numpy()
            out[(w, name)] = got

    net = workers.port_net(NET, train["weights"], "cpu").train()
    opt = make_optimizer(net.parameters(), LR)
    inp, gt = torch.from_numpy(train["input"]), torch.from_numpy(train["gt"])
    seeds = [torch.from_numpy(s) for s in train["seeds"]]
    out["loss"] = float(train_step(net, opt, inp, gt, 4, seed_idx=seeds))
    out["params"] = workers.params_of(net)
    loss2, (pred, gt_out) = train_step(net, opt, inp, gt, 4, seed_idx=seeds,
                                       with_pred=True)
    out.update(loss2=float(loss2), pred=pred.numpy(), gt_out=gt_out.numpy(),
               params2=workers.params_of(net))

    net = workers.port_net(NET, train["weights"], "cpu").train()
    opt = make_optimizer(net.parameters(), LR)
    gen = torch.Generator().manual_seed(GENERATOR_SEED)
    out["gen_loss"] = float(train_step(net, opt, inp, gt, 4, generator=gen))
    out["gen_params"] = workers.params_of(net)

    state, error_log = train_loop(TrainConfig(**loop_cfg),
                                  max_steps=LOOP_STEPS, device="cpu")
    out["loop"] = dict(error_log=dict(error_log),
                       params=workers.params_of(state.net))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results at world sizes 2 and 4 (one spawn each, run
    while this process computes), JAX's sharded results at the same
    sizes, and the port's serial results."""
    root = tmp_path_factory.mktemp("parallel")
    jnet = JNet(**NET)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, 16, 3)).astype(np.float32))
    g = jnp.asarray(rng.standard_normal((1, 64, 3)).astype(np.float32))
    params = f32(jnet.init({"params": jax.random.PRNGKey(0),
                            "patch": jax.random.PRNGKey(1)},
                           x, 4, g, train=True)["params"])
    rng = np.random.default_rng(0)
    inp = rng.standard_normal((8, 16, 3)).astype(np.float32)
    gt = rng.standard_normal((8, 64, 3)).astype(np.float32)
    state = create_train_state(jnet, jax.random.PRNGKey(0), jnp.asarray(inp),
                               jnp.asarray(gt), 4, tx=jmake_optimizer(LR))
    tparams = f32(state.params)
    state = state._replace(params=tparams,
                           opt_state=jmake_optimizer(LR).init(tparams))
    weights = port_weights(params)
    train = dict(net=NET, weights=port_weights(tparams), lr=LR, ratio=4,
                 input=inp, gt=gt,
                 seeds=[rng.integers(0, 32, (8, 1)).astype(np.int32)])
    loop_cfg = dict(LOOP, h5_data=write_loop_data(root),
                    model_dir=str(root / "serial"))
    cases = upsample_cases()
    payloads = {w: dict(rows=np.arange(8 * 3, dtype=np.float32)
                        .reshape(8, 3), net=NET,
                        weights=weights, upsample=cases,
                        train=train, generator_seed=GENERATOR_SEED)
                for w in WORLDS}
    payloads[2].update(loop=dict(loop_cfg, model_dir=str(root / "mesh")),
                       loop_steps=LOOP_STEPS, ckpt_root=str(root / "ckpt"))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(spawn, workers.parallel_cases, w,
                                  payloads[w], device="cpu")
                   for w in WORLDS}
        jax_out = {w: jax_sharded(jnet, params, state, train, cases, w)
                   for w in WORLDS}
        serial = port_serial(weights, cases, train, loop_cfg)
        port = {w: f.result() for w, f in futures.items()}
    return dict(port=port, jax=jax_out, serial=serial, payloads=payloads)


# ----------------------------------------------------------- no spawn
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_plan_patches_matches_jax(n_dev):
    """(num_patches, padded, chunk) equal JAX's over shape sizes, patch
    sizes, patch ratios and chunks, the headline's 48 patches among
    them (64 at 4 ranks: 16 padding patches)."""
    for n, num_point, pnr in [(5000, 312, 3.0), (128, 16, 3.0),
                              (128, 64, 3.0), (100, 16, 3.0),
                              (6000, 312, 3.0), (120, 16, 1.2),
                              (5000, 312, 96 * 312 / 5000 + 1e-9)]:
        for chunk in (None, 1, 4, 8, 10, 24):
            assert tinf.plan_patches(n, num_point, pnr, chunk, n_dev) == \
                jplan_patches(n, num_point, pnr, chunk, n_dev), (
                    n, num_point, pnr, chunk)
    headline = {1: (48, 48, 8), 2: (48, 48, 8), 4: (48, 64, 8),
                8: (48, 48, 6)}
    assert tinf.plan_patches(5000, 312, 3.0, 8, n_dev) == headline[n_dev]


def test_make_mesh_needs_a_gpu_unless_cpu():
    """Without ``device="cpu"`` the mesh takes the card, and raises where
    none is visible, before it touches a process group."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------- meshes
@pytest.mark.parametrize("w", WORLDS)
def test_mesh_ranks_and_n_devices(runs, w):
    """Ranks 0..w-1 of a group of w; ``n_devices`` other than the world
    size raises."""
    ranks = runs["port"][w]
    assert [r["rank"] for r in ranks] == list(range(w))
    assert all(r["size"] == w and r["n_devices_raises"] for r in ranks)


@pytest.mark.parametrize("w", WORLDS)
def test_batch_sharded_rows_match_jax(runs, w):
    """Each rank's rows are the shard of JAX's ``batch_sharded`` that the
    w-device mesh puts on its w-th device."""
    x = runs["payloads"][w]["rows"]
    mesh = jpar.make_mesh(w)
    arr = jax.device_put(jnp.asarray(x), jpar.batch_sharded(mesh))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    want = [shards[d] for d in mesh.devices.flat]
    got = [r["rows"] for r in runs["port"][w]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", WORLDS)
def test_replicated_is_rank_0s(runs, w):
    """Each rank passes its own rank; every rank gets rank 0's array, by
    one broadcast."""
    for r in runs["port"][w]:
        got, counts = r["replicated"]
        np.testing.assert_array_equal(got, np.zeros((2, 3), np.float32))
        assert counts == {"broadcast": 1}


# ------------------------------------------------------------ inference
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_sharded_upsampler_equals_serial(runs, w, case):
    """Every rank returns the port's serial output bit for bit: the serial
    run takes the ranks' chunk, so each chunk holds the same patches, and
    the padding patches at 4 ranks are masked out of the final FPS."""
    want = runs["serial"][(w, case)]
    for rank in runs["port"][w]:
        got, _ = rank["upsample"][case]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_sharded_upsampler_matches_jax(runs, w, case):
    """Within JAX's own tolerance for its sharded pipeline against its
    serial one (atol 1e-4, tests/test_inference.py)."""
    got, _ = runs["port"][w][0]["upsample"][case]
    np.testing.assert_allclose(got, runs["jax"][w][case], atol=1e-4)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", WORLDS)
def test_one_all_gather_a_shape(runs, w, case):
    """A shape runs exactly one collective on each rank, the merge's
    all-gather: none in an FPS pick loop or a cascade."""
    for rank in runs["port"][w]:
        assert rank["upsample"][case][1] == {"all_gather": 1}


# ------------------------------------------------------------- training
def assert_params_close(got: dict, want: dict, **tol) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_train_step_matches_serial(runs, w):
    """The step on the 8 x 16 -> 64 batch at ratio 4, its re-patch seeds
    pinned: loss within 1e-5 and
    parameters within atol 1e-5 of the port's serial step (JAX's
    tolerances for its sharded step), twice; the second step's gathered
    prediction within 1e-5 of the serial one's; every rank alike."""
    ser = runs["serial"]
    ranks = runs["port"][w]
    for r in ranks:
        t = r["train"]
        assert abs(t["loss"] - ser["loss"]) <= 1e-5
        assert abs(t["loss2"] - ser["loss2"]) <= 1e-5
        assert_params_close(t["params"], ser["params"], atol=1e-5)
        assert_params_close(t["params2"], ser["params2"], atol=1e-5)
        np.testing.assert_allclose(t["pred"], ser["pred"], atol=1e-5)
        np.testing.assert_allclose(t["gt_out"], ser["gt_out"], atol=1e-5)
    for r in ranks[1:]:
        assert r["train"]["loss"] == ranks[0]["train"]["loss"]
        for k, v in ranks[0]["train"]["params2"].items():
            np.testing.assert_array_equal(r["train"]["params2"][k], v)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_train_step_matches_jax(runs, w):
    """Loss within 1e-5 and parameters within atol 1e-5 of
    ``threepu.parallel.make_sharded_train_step`` on a w-device mesh."""
    want = runs["jax"][w]["train"]
    got = runs["port"][w][0]["train"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert_params_close(got["params"], want["params"], atol=1e-5)


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_train_step_collectives(runs, w):
    """One all-reduce a step that does not return the prediction (the
    gradients and the loss in one buffer), and one all-gather more on a
    step that does."""
    for r in runs["port"][w]:
        assert r["train"]["counts"] == {"all_reduce": 1}
        assert r["train"]["pred_counts"] == {"all_reduce": 1,
                                             "all_gather": 1}


@pytest.mark.parametrize("w", WORLDS)
def test_sharded_step_draws_the_serial_repatch_seeds(runs, w):
    """The re-patch seeds drawn by the step from a generator seeded alike
    on every rank: the serial step's global (B, 1) draw, so the loss
    within 1e-5 and the parameters within atol 1e-5 of the serial step
    with that generator."""
    ser = runs["serial"]
    for r in runs["port"][w]:
        g = r["generator_step"]
        assert abs(g["loss"] - ser["gen_loss"]) <= 1e-5
        assert_params_close(g["params"], ser["gen_params"], atol=1e-5)


def test_loop_with_mesh_matches_serial(runs):
    """``train_loop`` with ``TrainConfig(mesh=...)`` at 2 ranks against the
    serial loop, 6 steps over stages of 4 (ratios 2 and 4): the error log
    within rtol 1e-5 and the parameters within rtol 2e-4, atol 2e-5 (JAX's
    tolerances, tests/test_train.py), on both ranks."""
    ser = runs["serial"]["loop"]
    for r in runs["port"][2]:
        loop = r["loop"]
        assert loop["step"] == LOOP_STEPS
        assert loop["error_log"].keys() == ser["error_log"].keys()
        for k, v in ser["error_log"].items():
            assert np.isclose(loop["error_log"][k], v, rtol=1e-5), k
        assert_params_close(loop["params"], ser["params"], rtol=2e-4,
                            atol=2e-5)


def test_loop_with_mesh_checkpoints_on_rank_0_only(runs):
    """A whole epoch (600 steps of batch 2) at 2 ranks, each rank given a
    directory of its own: only rank 0's holds ``model_1.npz``, and it
    reads back as rank 0's parameters and step."""
    r0, r1 = (r["checkpoint"] for r in runs["port"][2])
    assert r0["files"] == ["model_1.npz"] and r0["read_back"] is True
    assert r1["files"] == []
    assert r0["step"] == r1["step"] == 600


def test_loop_with_mesh_rejects_an_indivisible_batch(runs):
    assert all(r["indivisible_raises"] for r in runs["port"][2])


def test_loop_with_mesh_rejects_another_device(runs):
    """The mesh decides the loop's device: naming the card for a CPU
    mesh raises (before any CUDA call, so it raises on the CPU too)."""
    assert all(r["other_device_raises"] for r in runs["port"][2])
