"""The port's fused edge-conv chain held against the JAX package on the
CPU: the plain version against ``edge_conv_chain_pallas`` in interpret
mode, ``DenseEdgeConv`` with the chain flag against JAX's ``pallas=True``,
and the eval cascade routed to the kernel against JAX's with the kernel
forced.  On CPU tensors the wrapper runs its plain version; the CUDA
kernel itself is held to it in ``tests/test_torch_kernels_cuda.py``.
"""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import threepu.ops.edgeconv_pallas as ecp
from threepu.io.checkpoint import _flatten
from threepu.models import Net as JNet
from threepu.models.layers import DenseEdgeConv as JDenseEdgeConv

import threepu_torch.ops.edgeconv as tec
from threepu_torch.io.weights import state_dict_from_jax
from threepu_torch.models import DenseEdgeConv, Net

#: JAX's kernel gathers through a bf16 hi/lo split of z, which carries
#: about 2^-16 relative error; the port's gather is exact
ATOL, RTOL = 5e-5, 1e-5

#: what the route sees of a CUDA tensor
CUDA_LIKE = type("T", (), {"is_cuda": True})()


@pytest.fixture(autouse=True)
def small_segments(monkeypatch):
    # JAX's fixed batch segments, cheap under the interpreter
    monkeypatch.setattr(ecp, "_SEG", 4)


def f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def chain_inputs(seed, b, num_n, k, n, g):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, num_n, g)).astype(np.float32)
    idx = rng.integers(0, num_n, (b, num_n, k)).astype(np.int32)
    pts = [rng.standard_normal((b, num_n, g)).astype(np.float32)
           for _ in range(n)]
    chain_w = [(0.3 * rng.standard_normal((g, g))).astype(np.float32)
               for _ in range(n * (n - 1) // 2)]
    return z, idx, pts, chain_w


@pytest.mark.parametrize("b,num_n,k,n,g", [(1, 24, 5, 1, 12),
                                           (1, 24, 5, 2, 12),
                                           (2, 40, 8, 3, 12),
                                           (6, 16, 4, 3, 12),
                                           (2, 20, 6, 2, 4)],
                         ids=["n1", "n2", "n3", "batch-over-segment", "g4"])
def test_chain_plain_matches_pallas_interpret(b, num_n, k, n, g):
    """Same z, idx, pts and chain blocks through JAX's Pallas kernel
    (interpret mode) and the port's plain version: atol 5e-5, rtol 1e-5."""
    z, idx, pts, chain_w = chain_inputs(b + n, b, num_n, k, n, g)
    want = np.asarray(ecp.edge_conv_chain_pallas(
        jnp.asarray(z), jnp.asarray(idx), [jnp.asarray(p) for p in pts],
        [jnp.asarray(w) for w in chain_w], n, g))
    before = tec.KERNEL.launches
    got = tec.edge_conv_chain(
        torch.from_numpy(z), torch.from_numpy(idx),
        [torch.from_numpy(p) for p in pts],
        [torch.from_numpy(w) for w in chain_w], n, g)
    assert tec.KERNEL.launches == before          # a CPU tensor: plain version
    assert got.shape == (b, num_n, n * g)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # one stacked tensor each is the same call
    stacked = tec.edge_conv_chain_plain(
        torch.from_numpy(z), torch.from_numpy(idx).long(),
        torch.from_numpy(np.stack(pts, 1)),
        torch.from_numpy(np.stack(chain_w)) if chain_w
        else torch.zeros(0, g, g), n, g)
    assert torch.equal(stacked, got)


@pytest.mark.parametrize("n,g,idx_dtype", [(1, 12, torch.int64),
                                            (2, 4, torch.int32),
                                            (3, 12, torch.int64),
                                            (3, 5, torch.int32),
                                            (4, 8, torch.int64)])
def test_chain_takes_the_layers_views(n, g, idx_dtype):
    """Views that the kernel reads through their strides: the ``[..., 1:]``
    slice of a k + 1 selection and the chain blocks as row blocks of
    transposed weights, as ``DenseEdgeConv`` passes them, and ``z`` and
    the stages' terms as slices of one ``(B, N, (n + 1) G)`` product: the
    same result, bit for bit, as the same values passed as separate
    contiguous tensors."""
    rng = np.random.default_rng(n + g)
    b, num_n, k = 2, 30, 6
    prod = torch.from_numpy(
        rng.standard_normal((b, num_n, (n + 1) * g)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, num_n, (b, num_n, k + 1))).to(
        idx_dtype)[..., 1:]
    w = [torch.from_numpy((0.3 * rng.standard_normal((g, g * i + 3))).astype(
        np.float32)).t() for i in range(1, n)]
    chain_w = [w[i - 1][g * j:g * (j + 1)] for i in range(1, n)
               for j in range(i)]
    z, pts = prod[..., :g], list(prod[..., g:].split(g, dim=-1))
    assert not (idx.is_contiguous() or z.is_contiguous()
                or any(t.is_contiguous() for t in pts))
    got = tec.edge_conv_chain(z, idx, pts, chain_w, n, g)
    want = tec.edge_conv_chain_plain(
        z.contiguous(), idx.contiguous().long(),
        [t.contiguous() for t in pts],
        [t.contiguous() for t in chain_w], n, g)
    assert got.shape == (b, num_n, n * g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,g,k", [(1, 12, 5), (2, 4, 4), (3, 12, 8)])
def test_dense_edge_conv_chain_flag_matches_jax(rng, n, g, k):
    """The port's DenseEdgeConv with the chain flag against JAX's
    ``pallas=True`` on the same weights: indices equal, values to atol
    5e-5 / rtol 1e-5; and flag on against flag off inside the port:
    1e-5."""
    x = rng.standard_normal((5, 32, 24)).astype(np.float32)
    jm = JDenseEdgeConv(growth_rate=g, n=n, k=k, fused=True)
    params = f32(jm.init({"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x))["params"])
    # biases are zero at init: draw them, so the point terms carry them
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32)
        if path[-1].key == "bias" else a, params)
    want, want_idx = jm.apply({"params": params}, jnp.asarray(x), pallas=True)
    tm = DenseEdgeConv(24, g, n, k)
    tm.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    with torch.no_grad():
        got, idx = tm(torch.from_numpy(x), chain_kernel=True)
        off, off_idx = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert torch.equal(idx, off_idx)
    np.testing.assert_allclose(got.numpy(), off.numpy(), atol=1e-5, rtol=1e-5)


def test_upsample_with_toggle_matches_jax_forced(rng, monkeypatch):
    """``Net.upsample`` at ratio 4 routed to the port's kernel against
    JAX's cascade with its kernel enabled and forced (interpret mode).  JAX's
    hi/lo gather rounding can flip kNN and FPS near-ties, so JAX's own
    criterion holds (tests/test_edgeconv_pallas.py): over 98% of the rows
    within 5e-4, and every patch within a Chamfer distance of 1e-5."""
    xyz = rng.standard_normal((2, 48, 3)).astype(np.float32)
    cfg = dict(max_up_ratio=4, knn=6, max_num_point=48)
    jnet = JNet(**cfg)
    params = f32(jnet.init(
        {"params": jax.random.PRNGKey(0), "patch": jax.random.PRNGKey(1)},
        jnp.asarray(xyz), 4, gt=jnp.zeros((2, 192, 3), jnp.float32),
        train=True)["params"])
    monkeypatch.setattr(ecp, "ENABLED", True)
    monkeypatch.setattr(ecp, "FORCE", True)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(xyz), 4,
                                 train=False))

    tnet = Net(**cfg).eval()
    tnet.load_state_dict(state_dict_from_jax(_flatten(params)), strict=True)
    calls = []
    chain = tec.edge_conv_chain

    def counted(*args):
        calls.append(args[0].shape[0])
        return chain(*args)

    # a CPU tensor takes the plain chain
    monkeypatch.setattr("threepu_torch.models.layers.edge_conv_chain", counted)
    assert not tec.takes_kernel(torch.from_numpy(xyz), tnet.dense_n,
                                tnet.growth_rate)
    base = tnet.upsample(torch.from_numpy(xyz), 4).numpy()
    assert not calls
    # so say that this device takes it: the wrapper runs its plain version
    monkeypatch.setattr(tec, "takes_kernel", lambda x, n, g: True)
    got = tnet.upsample(torch.from_numpy(xyz), 4).numpy()
    assert len(calls) == 8 and calls[0] == 2 and calls[-1] > 2
    np.testing.assert_allclose(got, base, atol=1e-5)

    assert got.shape == want.shape == (2, 192, 3)
    assert np.all(np.abs(got - want) < 5e-4, axis=-1).mean() > 0.98
    for b in range(2):
        d = np.sum((got[b][:, None] - want[b][None]) ** 2, -1)
        assert d.min(1).mean() + d.min(0).mean() < 1e-5


def test_train_cascade_never_takes_the_chain_kernel(rng, monkeypatch):
    """``Net.forward``'s train cascade keeps the decomposed path, whatever
    the route says: the kernel has no backward."""
    def refuse(*args):
        raise AssertionError("the train cascade called edge_conv_chain")

    monkeypatch.setattr(tec, "takes_kernel", lambda x, n, g: True)
    monkeypatch.setattr("threepu_torch.models.layers.edge_conv_chain", refuse)
    net = Net(max_up_ratio=4, knn=6, max_num_point=48, growth_rate=4,
              dense_n=2)
    x = torch.from_numpy(rng.standard_normal((2, 48, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((2, 192, 3)).astype(np.float32))
    pred, _ = net(x, 4, gt, seed_idx=[torch.zeros(2, 1, dtype=torch.long)])
    pred.sum().backward()
    assert net.levels["level_1"].layer1.mlps[0].weight.grad is not None


def test_train_cascade_under_no_grad_never_takes_the_chain_kernel(
        rng, monkeypatch):
    """The route is the cascade's, not the grad mode's: ``Net.forward``'s
    train cascade in eval mode under ``no_grad``, where the kernel could
    take the call, still keeps the decomposed path."""
    def refuse(*args):
        raise AssertionError("the train cascade called edge_conv_chain")

    monkeypatch.setattr(tec, "takes_kernel", lambda x, n, g: True)
    monkeypatch.setattr("threepu_torch.models.layers.edge_conv_chain", refuse)
    net = Net(max_up_ratio=4, knn=6, max_num_point=48, growth_rate=4,
              dense_n=2).eval()
    x = torch.from_numpy(rng.standard_normal((2, 48, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((2, 192, 3)).astype(np.float32))
    with torch.no_grad():
        pred, _ = net(x, 4, gt, seed_idx=[torch.zeros(2, 1, dtype=torch.long)])
    assert pred.shape == (2, 96, 3)


@pytest.mark.parametrize("cuda,n,g,routed", [
    (False, 3, 12, False), (True, 3, 12, True), (True, 4, 32, True),
    (True, 5, 4, False), (True, 2, 33, False)],
    ids=["cpu", "cuda", "cuda-widest", "cuda-n5", "cuda-g33"])
def test_the_kernel_takes_a_cuda_tensor_of_the_widths_it_is_built_for(
        cuda, n, g, routed):
    """A CUDA tensor takes the kernel where ``n <= 4`` and ``g <= 32``; a
    CPU tensor never does."""
    x = CUDA_LIKE if cuda else torch.zeros(1)
    assert tec.takes_kernel(x, n, g) is routed


@pytest.mark.parametrize("dense_n,growth_rate,routed",
                         [(5, 4, False), (2, 33, False), (4, 32, True)],
                         ids=["n5", "g33", "widest"])
def test_upsample_routes_by_the_nets_widths(rng, monkeypatch, dense_n,
                                            growth_rate, routed):
    """On a card, ``Net.upsample`` takes the kernel only for nets it is
    instantiated for (``dense_n <= 4``, ``growth_rate <= 32``); a wider
    net runs on the plain chain and does not raise (the wrapper refuses
    ``n = 5`` and ``g = 33``).  Either way the output is
    the plain route's."""
    calls = []
    chain = tec.edge_conv_chain

    def counted(*args):
        calls.append(args[-2:])
        return chain(*args)

    monkeypatch.setattr("threepu_torch.models.layers.edge_conv_chain", counted)
    torch.manual_seed(0)
    net = Net(max_up_ratio=4, knn=6, max_num_point=48,
              growth_rate=growth_rate, dense_n=dense_n).eval()
    x = torch.from_numpy(rng.standard_normal((2, 48, 3)).astype(np.float32))
    want = net.upsample(x, 4)
    assert not calls
    # say that this device is a card: the route still asks the widths
    route = tec.takes_kernel
    monkeypatch.setattr(tec, "takes_kernel",
                        lambda x, n, g: route(CUDA_LIKE, n, g))
    got = net.upsample(x, 4)
    assert calls == ([(dense_n, growth_rate)] * 8 if routed else [])
    assert got.shape == (2, 192, 3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _torch_inputs(n=2, g=4, **kw):
    z, idx, pts, chain_w = chain_inputs(0, 2, 10, 3, n, g)
    return dict(z=torch.from_numpy(z), idx=torch.from_numpy(idx),
                pts=[torch.from_numpy(p) for p in pts],
                chain_w=[torch.from_numpy(w) for w in chain_w], n=n, g=g, **kw)


def test_chain_refuses_a_gradient():
    """Forward-only: an input that requires a gradient raises while
    gradients are enabled, and passes under ``no_grad``."""
    args = _torch_inputs()
    args["z"].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        tec.edge_conv_chain(**args)
    args = _torch_inputs()
    args["chain_w"][0].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        tec.edge_conv_chain(**args)
    with torch.no_grad():
        assert tec.edge_conv_chain(**args).shape == (2, 10, 8)


@pytest.mark.parametrize("change,match", [
    (dict(n=5), "n=5"), (dict(n=0), "n=0"), (dict(g=33), "g=33"),
    (dict(g=0), "g=0"), (dict(g=5), "need z"),
    (dict(idx=torch.zeros(2, 9, 3, dtype=torch.int32)), "need z"),
    (dict(idx=torch.zeros(2, 10, 0, dtype=torch.int32)), "need z"),
    (dict(idx=torch.zeros(2, 10, 3)), "int32 or int64"),
    (dict(pts=torch.zeros(2, 10, 2, 4)), "need z"),
    (dict(chain_w=torch.zeros(2, 4, 4)), "need z")],
    ids=["n5", "n0", "g33", "g0", "g-differs", "idx-rows", "k0", "idx-float",
         "pts-layout", "blocks"])
def test_chain_rejects_what_the_kernel_does_not_take(change, match):
    """The argument check runs before the device branch, so the CPU shows
    what a CUDA call would raise."""
    with pytest.raises(ValueError, match=match):
        tec.edge_conv_chain(**{**_torch_inputs(), **change})
