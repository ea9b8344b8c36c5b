"""The port's checkpoints (``threepu_torch.io.checkpoint``) held against
the JAX package's (``threepu.io.checkpoint``) on the CPU: each package
reads the other's ``.npz`` parameter files, full-state files with the
Adam state, and reference ``.pth`` files, bit for bit.

The net is ``tests/test_train.py``'s tiny one (knn 4, growth 4, dense 2,
12 points, up to ratio 4); the full net only for the shipped checkpoint
``artifacts/prod_clean_final.npz``'s 321 Adam leaves and fingerprint.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import contextlib
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threepu.io import checkpoint as jck
from threepu.models import Net as JNet
from threepu.train import model as jmodel

from threepu_torch.io import checkpoint as tck
from threepu_torch.io.weights import flatten_tree, state_dict_from_jax
from threepu_torch.models import Net as TNet
from threepu_torch.train import make_optimizer, train_step

PROD = "artifacts/prod_clean_final.npz"
TINY = dict(max_up_ratio=4, step_ratio=2, knn=4, growth_rate=4, dense_n=2,
            max_num_point=12)
FULL = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12, dense_n=3,
            max_num_point=312, fm_knn=5)
B, K = 2, 12


@contextlib.contextmanager
def pinned_randint(seeds):
    """``jax.random.randint`` returns ``seeds``' arrays in call order."""
    it = iter(seeds)

    def fake(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(next(it), dtype).reshape(shape)

    with mock.patch.object(jax.random, "randint", fake):
        yield


@functools.partial(jax.jit, static_argnums=(0, 1))
def jax_step(net, tx, state, x, gt, seed):
    """JAX's train step at ratio 4 with its re-patch seed ``seed``, an
    argument of the compiled step (a seed pinned as a constant would stay
    in the cached trace)."""
    with pinned_randint([seed]):
        return jmodel.train_step.__wrapped__(net, tx, state,
                                             jax.random.PRNGKey(0), x, gt, 4)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX net, float32 params, a batch at ratio 4 and the
    re-patch seeds of its 2 steps, and the JAX train state after them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, K, 3)).astype(np.float32)
    gt = rng.standard_normal((B, 4 * K, 3)).astype(np.float32)
    seeds = [rng.integers(0, 2 * K, (B, 1)).astype(np.int32)
             for _ in range(3)]
    net = JNet(**TINY)
    with pinned_randint([seeds[0]]):
        params = net.init({"params": jax.random.PRNGKey(0),
                           "patch": jax.random.PRNGKey(1)},
                          jnp.asarray(x), 4, jnp.asarray(gt),
                          train=True)["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    tx = jmodel.make_optimizer(5e-4)
    state = jmodel.TrainState(jax.tree.map(jnp.copy, params),
                              tx.init(params), jnp.asarray(0))
    for s in seeds[:2]:
        state, _ = jax_step(net, tx, state, jnp.asarray(x), jnp.asarray(gt),
                            jnp.asarray(s))
    return dict(net=net, tx=tx, params=params, state=state, x=x, gt=gt,
                seeds=seeds)


def port_net(params):
    net = TNet(**TINY)
    net.load_state_dict(state_dict_from_jax(flatten_tree(params)),
                        strict=True)
    return net


def assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


def assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def npz_contents(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ----------------------------------------------------------------- .npz
def test_npz_jax_tree_through_the_port(tiny, tmp_path):
    """JAX tree -> the port's save_checkpoint -> JAX's load_checkpoint:
    the same tree and step; the file equals JAX's own, array for
    array."""
    path, jpath = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    tck.save_checkpoint(path, port_net(tiny["params"]), step=7)
    jck.save_checkpoint(jpath, {"params": tiny["params"]}, step=7)
    restored, step = jck.load_checkpoint(path)
    assert step == 7
    assert_trees_equal(restored["params"], tiny["params"])
    got, want = npz_contents(path), npz_contents(jpath)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])


def test_npz_port_net_through_jax(tiny, tmp_path):
    """The port's weights -> JAX's save_checkpoint of their tree -> the
    port's load_checkpoint: the same state dict, loaded strictly."""
    net = TNet(**TINY)                       # torch's own initialization
    path = str(tmp_path / "j.npz")
    tree, _ = jck.load_checkpoint(_port_file(net, tmp_path))
    jck.save_checkpoint(path, tree, step=3)
    state, step = tck.load_checkpoint(path)
    assert step == 3
    assert_states_equal(state, net.state_dict())
    TNet(**TINY).load_state_dict(state, strict=True)


def _port_file(net, tmp_path):
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, net)
    return path


def test_partial_restore_follows_jax(tiny, tmp_path):
    """A file with an unknown leaf, a leaf missing and one changed:
    unknown dropped, missing keeps the target's value, as JAX's
    load_checkpoint with a target."""
    flat = flatten_tree(tiny["params"])
    missing, changed = sorted(flat)[0], sorted(flat)[5]
    saved = {k: v for k, v in flat.items() if k != missing}
    saved[changed] = saved[changed] + 1.0
    saved["extra_head/conv/kernel"] = np.ones((2, 2), np.float32)
    path = str(tmp_path / "partial.npz")
    np.savez(path, step=np.asarray(5, np.int64),
             **{"params/" + k: v for k, v in saved.items()})
    want, wstep = jck.load_checkpoint(path, {"params": tiny["params"]})
    got, step = tck.load_checkpoint(path, port_net(tiny["params"]))
    assert step == wstep == 5
    assert_states_equal(got, state_dict_from_jax(flatten_tree(
        want["params"])))


# ------------------------------------------------------ optimizer state
def test_fingerprint_matches_jax(tiny):
    """The fingerprint the port writes equals JAX's ``_opt_fingerprint``
    for the tiny net, and the shipped checkpoint's for the full net."""
    want = jck._opt_fingerprint(tiny["tx"].init(tiny["params"]))
    assert tck.opt_fingerprint(port_net(tiny["params"])) == want
    with np.load(PROD) as f:
        assert tck.opt_fingerprint(TNet(**FULL)) == str(f["opt_treedef"])


def test_shipped_adam_state_loads_bit_for_bit(tmp_path):
    """``prod_clean_final.npz``: step 120000, 321 Adam leaves ``opt/00000``
    to ``opt/00320``; restored into the port's optimizer and written
    back, the file comes back array for array."""
    net = TNet(**FULL)
    state, step = tck.load_checkpoint(PROD, net)
    net.load_state_dict(state, strict=True)
    opt = make_optimizer(net.parameters())
    assert tck.load_opt_state(PROD, net, opt) is opt
    assert step == 120000
    path = str(tmp_path / "back.npz")
    tck.save_train_checkpoint(path, net, opt, step=step)
    got, want = npz_contents(path), npz_contents(PROD)
    assert sorted(got) == sorted(want)
    assert sum(k.startswith("opt/") for k in want) == 321
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    counts = {float(s["step"]) for s in opt.state.values()}
    assert counts == {float(want["opt/00000"])}


def test_jax_adam_state_loads_and_steps_alike(tiny, tmp_path):
    """A JAX full-state file after 2 Adam steps: the port's optimizer
    holds JAX's moments bit for bit; one more step on both, with the same
    re-patch seed, gives the loss to 1e-5 relative and the parameters to
    1e-5 absolute (``test_train_step_matches_jax_train_step``'s
    tolerances)."""
    state = tiny["state"]
    path = str(tmp_path / "full.npz")
    jck.save_train_checkpoint(path, {"params": state.params},
                              state.opt_state, step=2)
    net = TNet(**TINY)
    restored, step = tck.load_checkpoint(path, net)
    net.load_state_dict(restored, strict=True)
    opt = make_optimizer(net.parameters(), 5e-4)
    assert step == 2 and tck.load_opt_state(path, net, opt) is opt
    adam = state.opt_state[1][0]
    mu = state_dict_from_jax(flatten_tree(adam.mu))
    nu = state_dict_from_jax(flatten_tree(adam.nu))
    for name, p in net.named_parameters():
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name])
        assert torch.equal(st["exp_avg_sq"], nu[name])
        assert float(st["step"]) == int(adam.count) == 2
    seed = tiny["seeds"][2]
    state = jmodel.TrainState(jax.tree.map(jnp.copy, state.params),
                              state.opt_state, state.step)
    state, cd = jax_step(tiny["net"], tiny["tx"], state,
                         jnp.asarray(tiny["x"]), jnp.asarray(tiny["gt"]),
                         jnp.asarray(seed))
    got = train_step(net, opt, torch.from_numpy(tiny["x"]),
                     torch.from_numpy(tiny["gt"]), 4,
                     seed_idx=[torch.from_numpy(seed)])
    np.testing.assert_allclose(got.item(), float(cd), rtol=1e-5)
    want = state_dict_from_jax(flatten_tree(state.params))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_port_train_checkpoint_restores_in_jax(tiny, tmp_path):
    """A port-written full-state file after 2 port steps: JAX's
    load_opt_state restores it (not None) with the port's moments and
    count, and JAX's load_checkpoint its parameters."""
    net = port_net(tiny["params"])
    opt = make_optimizer(net.parameters(), 5e-4)
    for s in tiny["seeds"][:2]:
        train_step(net, opt, torch.from_numpy(tiny["x"]),
                   torch.from_numpy(tiny["gt"]), 4,
                   seed_idx=[torch.from_numpy(s)])
    path = str(tmp_path / "port_full.npz")
    tck.save_train_checkpoint(path, net, opt, step=2)
    restored = jck.load_opt_state(path, tiny["tx"].init(tiny["params"]))
    assert restored is not None
    adam = restored[1][0]
    assert int(adam.count) == 2 and adam.count.dtype == jnp.int32
    mu = state_dict_from_jax(flatten_tree(adam.mu))
    nu = state_dict_from_jax(flatten_tree(adam.nu))
    for name, p in net.named_parameters():
        assert torch.equal(mu[name], opt.state[p]["exp_avg"]), name
        assert torch.equal(nu[name], opt.state[p]["exp_avg_sq"]), name
    params, step = jck.load_checkpoint(path)
    assert step == 2
    assert_states_equal(state_dict_from_jax(flatten_tree(params["params"])),
                        net.state_dict())


def test_fresh_optimizer_state_is_optax_init(tiny, tmp_path):
    """Before any step the port writes optax's initial state: count 0 and
    zero moments, which JAX restores as equal to ``tx.init``."""
    net = port_net(tiny["params"])
    path = str(tmp_path / "fresh.npz")
    tck.save_train_checkpoint(path, net, make_optimizer(net.parameters()))
    init = tiny["tx"].init(tiny["params"])
    got = jck.load_opt_state(path, init)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(init)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["no-opt", "other-net", "leaf-shape",
                                  "leaf-count"])
def test_load_opt_state_mismatch(tiny, tmp_path, case, capsys):
    """Returns None and leaves the optimizer fresh: silently without
    optimizer state, with a warning where the fingerprint, a leaf's shape
    or the leaf count does not fit (JAX returns None for the same
    files)."""
    net = port_net(tiny["params"])
    opt = make_optimizer(net.parameters())
    path = str(tmp_path / f"{case}.npz")
    if case == "no-opt":
        tck.save_checkpoint(path, net)
    elif case == "other-net":
        other = TNet(**dict(TINY, dense_n=3))
        tck.save_train_checkpoint(path, other,
                                  make_optimizer(other.parameters()))
    else:
        tck.save_train_checkpoint(path, net, opt)
        arrays = npz_contents(path)
        if case == "leaf-shape":
            arrays["opt/00001"] = np.zeros((7,), np.float32)
        else:
            del arrays[sorted(k for k in arrays if k.startswith("opt/"))[-1]]
        np.savez(path, **arrays)
    assert tck.load_opt_state(path, net, opt) is None
    assert not opt.state
    warned = "FRESH" in capsys.readouterr().out
    assert warned == (case != "no-opt")
    if case in ("no-opt", "other-net"):
        assert jck.load_opt_state(path, tiny["tx"].init(
            tiny["params"])) is None


def test_make_optimizer_updates_every_parameter_as_optax():
    """A parameter the loss did not reach (gradient None) still takes
    optax's step with a zero gradient: its moments decay, its count
    advances and its momentum moves it (1e-6 relative)."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = jmodel.make_optimizer(5e-4)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(tp.values(), 5e-4)
    for step in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        if step == 2:
            g["b"] = np.zeros_like(g["b"])         # "b" not reached
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        opt.zero_grad(set_to_none=True)
        tp["a"].grad = torch.from_numpy(g["a"])
        if step < 2:
            tp["b"].grad = torch.from_numpy(g["b"])
        opt.step()
        for k, v in tp.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert float(opt.state[tp["b"]]["step"]) == 3


# ----------------------------------------------------------------- .pth
@pytest.mark.parametrize("prefix", ["", "module."])
def test_pth_from_jax(tiny, tmp_path, prefix):
    """JAX's save_pth (a ``module.`` prefix added to every key, as
    DataParallel saves) -> the port's import_pth: JAX's weights and step
    bit for bit, with and without a target; the same file through JAX's
    import_pth agrees."""
    path = jck.save_pth(str(tmp_path / "j.pth"), {"params": tiny["params"]},
                        step=12)
    if prefix:
        blob = torch.load(path, weights_only=False)
        blob["states"] = {prefix + k: v for k, v in blob["states"].items()}
        torch.save(blob, path)
    want = state_dict_from_jax(flatten_tree(tiny["params"]))
    for target in (None, port_net(jax.tree.map(jnp.zeros_like,
                                               tiny["params"]))):
        got, step = tck.import_pth(path, target)
        assert step == 12
        assert_states_equal(got, want)
    jtree, _ = jck.import_pth(path, {"params": tiny["params"]})
    assert_trees_equal(jtree["params"], tiny["params"])


def test_pth_to_jax(tiny, tmp_path):
    """The port's save_pth -> JAX's import_pth: the port's weights bit for
    bit; ``{label}_{epoch}.pth`` naming and the exported state as JAX's."""
    net = TNet(**TINY)
    path = tck.save_pth(str(tmp_path), net, step=31, label="model", epoch=4)
    jpath = jck.save_pth(str(tmp_path / "jax"), {"params": jax.tree.map(
        jnp.asarray, _tree(net))}, step=31, label="model", epoch=4)
    assert path.endswith("model_4.pth") and jpath.endswith("model_4.pth")
    restored, step = jck.import_pth(path)
    assert step == 31
    assert_states_equal(state_dict_from_jax(flatten_tree(
        restored["params"])), net.state_dict())
    got = tck.export_reference_state(net, step=31)
    want = jck.export_reference_state({"params": _tree(net)}, step=31)
    assert got["step"] == want["step"] == "31"
    assert sorted(got["states"]) == sorted(want["states"])
    for k, v in want["states"].items():
        assert got["states"][k].shape == v.shape
        assert np.array_equal(got["states"][k], v), k
    a = torch.load(path, weights_only=False)
    b = torch.load(jpath, weights_only=False)
    assert a["step"] == b["step"]
    assert_states_equal(a["states"], b["states"])


def _tree(net):
    """The JAX parameter tree of the port's ``net`` (numpy leaves)."""
    tree = {}
    for key, value in tck.flat_params(net).items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def test_pth_shape_mismatch_raises(tiny, tmp_path):
    """A weight whose shape does not fit the target raises ValueError in
    both packages; a conv weight without its trailing axes of 1 fits."""
    state = {k: v for k, v in port_net(tiny["params"]).state_dict().items()}
    name = "levels.level_1.layer0.conv.weight"
    squeezed = dict(state, **{name: state[name][..., 0, 0]})
    path = str(tmp_path / "squeezed.pth")
    torch.save({"states": squeezed, "step": "1"}, path)
    got, _ = tck.import_pth(path, TNet(**TINY))
    assert torch.equal(got[name], state[name])
    bad = dict(state, **{name: torch.zeros(state[name].shape[0] + 1,
                                           *state[name].shape[1:])})
    torch.save({"states": bad, "step": "1"}, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.import_pth(path, TNet(**TINY))
    with pytest.raises(ValueError, match="shape mismatch"):
        jck.import_pth(path, {"params": tiny["params"]})
