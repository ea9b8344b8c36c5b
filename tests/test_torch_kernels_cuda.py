"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and nvcc (the kernels are built at
first use); without a visible GPU each one skips.  Run them on a GPU
machine with ``python -m pytest tests/test_torch_kernels_cuda.py -q
--noconftest`` (the suite's conftest imports JAX; this file needs none).
``chip_smoke.py`` repeats the comparisons at the pipeline's full shapes.
"""

import numpy as np
import pytest
import torch

import threepu_torch.ops.chamfer as tcham
import threepu_torch.ops.fps as tfps
import threepu_torch.ops.interlevel as til
import threepu_torch.ops.select as tsel
from threepu_torch.ops.distances import duplicate_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from threepu_torch import require_cuda
    return require_cuda()


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.parametrize("b,m,n,k", [(4, 37, 312, 33), (3, 8, 200, 5),
                                     (2, 9, 2000, 64), (1, 1, 1, 1)],
                         ids=["conv", "ragged", "unstaged-long-rows", "one"])
def test_select_kernel_matches_plain(dev, gen, b, m, n, k):
    """Bit for bit: values and indices, ties, 1e30 penalty columns and
    rows with fewer than k unpenalized columns."""
    d = torch.randint(0, 9, (b, m, n), generator=gen, device=dev).float()
    d[..., torch.randperm(n, generator=gen, device=dev)[:n // 5]] = 1e30
    d[0, 0, : max(n - 3, 0)] = 1e30
    before = tsel.KERNEL.launches
    v, i = tsel.select(d, k)
    pv, pi = tsel.select_plain(d, k)
    assert tsel.KERNEL.launches == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_select_kernel_rejects_what_it_does_not_take(dev):
    d = torch.zeros(2, 8, 100, device=dev)
    with pytest.raises(ValueError):
        tsel.select(d, 65)
    with pytest.raises(ValueError):
        tsel.select(d.double(), 5)


@pytest.mark.parametrize("b,n,m", [(2, 700, 150), (3, 5000, 64),
                                   (1, 3000, 3000)],
                         ids=["small", "wide", "all-points"])
def test_fps_kernel_matches_plain(dev, gen, b, n, m):
    pts = torch.randn((b, n, 3), generator=gen, device=dev)
    valid = torch.rand((b, n), generator=gen, device=dev) > 0.1
    valid[0, :17] = False                            # seed moves off 0
    pts[:, 5] = float("nan")
    pts[-1, 9] = float("inf")
    before = tfps.KERNEL.launches
    got = tfps.fps(pts, m, valid)
    assert tfps.KERNEL.launches == before + 1
    assert torch.equal(got, tfps.fps_plain(pts, m, valid))
    assert torch.equal(tfps.fps(pts, m), tfps.fps_plain(pts, m))


def test_fps_kernel_no_valid_point(dev, gen):
    pts = torch.randn((2, 50, 3), generator=gen, device=dev)
    valid = torch.zeros((2, 50), dtype=torch.bool, device=dev)
    valid[1, [4, 30]] = True
    assert torch.equal(tfps.fps(pts, 6, valid), tfps.fps_plain(pts, 6, valid))


def test_fps_hierarchical_on_gpu_matches_cpu(dev, gen):
    pts = torch.randn((2, 3000, 3), generator=gen, device=dev)
    valid = torch.rand((2, 3000), generator=gen, device=dev) > 0.3
    got = tfps.fps_hierarchical(pts, 500, valid, group_max=800)
    want = tfps.fps_hierarchical(pts.cpu(), 500, valid.cpu(), group_max=800)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("p,group,n,m,c,k", [(2, 3, 40, 300, 24, 5),
                                             (3, 1, 312, 312, 264, 5),
                                             (1, 2, 1024, 5000, 8, 8),
                                             (2, 2, 7, 6, 5, 1)],
                         ids=["grouped", "group1", "max-n", "tiny"])
def test_interlevel_kernel_matches_plain(dev, gen, p, group, n, m, c, k):
    """Picks exact; values to 1e-5 (sums over C and over the queries run
    in another order than PyTorch's)."""
    prev = torch.randn((p, m, 3), generator=gen, device=dev) * 0.3
    prev[:, 1::7] = prev[:, 0::7][:, :prev[:, 1::7].shape[1]]
    dup = duplicate_mask(prev)
    dup[:, -2:] = True                               # phantom rows
    q = torch.randn((p * group, n, 3), generator=gen, device=dev) * 0.3
    xq = torch.randn((p * group, n, c), generator=gen, device=dev)
    feat = torch.randn((p, m, c), generator=gen, device=dev)
    before = til.KERNEL.launches
    out, idx = til.interlevel(q, xq, prev, feat, dup, k)
    assert til.KERNEL.launches == before + 1
    pout, pidx = til.interlevel_plain(q, xq, prev, feat, dup, k)
    assert torch.equal(idx, pidx)
    torch.testing.assert_close(out, pout, atol=1e-5, rtol=1e-5)


def test_interlevel_kernel_rejects_what_it_does_not_take(dev):
    args = [torch.zeros(4, 8, 3, device=dev), torch.zeros(4, 8, 6, device=dev),
            torch.zeros(2, 10, 3, device=dev), torch.zeros(2, 10, 6, device=dev),
            torch.zeros(2, 10, dtype=torch.bool, device=dev)]
    with pytest.raises(ValueError):
        til.interlevel(*args, 9)                     # k above 8
    with pytest.raises(ValueError):
        til.interlevel(args[0][:3], *args[1:], 3)    # P does not divide B
    with pytest.raises(ValueError):
        til.interlevel(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                       *args[1:], 3)                 # not contiguous


@pytest.mark.parametrize("p,group,n,m,c,k", [(2, 3, 40, 300, 24, 5),
                                             (16, 1, 312, 312, 264, 5)],
                         ids=["grouped", "train"])
def test_interlevel_backward_on_gpu_matches_plain(dev, gen, p, group, n, m,
                                                  c, k):
    """The kernel's weights (its third output) equal the plain version's
    to 1e-5 and drive the same prev_feat gradient, to 1e-5 (the kernel's
    weights differ by float32 rounding; index_add_ sums with atomics on
    the card); no other input gets one.  "train" is the train step's
    shape: one sub-patch per previous set."""
    prev = torch.randn((p, m, 3), generator=gen, device=dev) * 0.3
    dup = duplicate_mask(prev)
    q = torch.randn((p * group, n, 3), generator=gen, device=dev) * 0.3
    xq = torch.randn((p * group, n, c), generator=gen, device=dev)
    feat = torch.randn((p, m, c), generator=gen, device=dev)
    cot = torch.randn((p * group, n, c), generator=gen, device=dev)
    got = til._launch(q, xq, prev, feat, dup, k, with_w=True)
    want = til._plain(q, xq, prev, feat, dup, k)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    grads = []
    for fn in (til.interlevel, til.interlevel_plain):
        args = [a.clone().requires_grad_() for a in (q, xq, prev, feat)]
        out, _ = fn(*args, dup, k)
        out.backward(cot)
        assert all(a.grad is None for a in args[:3])
        grads.append(args[3].grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)


def _nn_inputs(gen, dev, b, n, m):
    """Integer-grid points (exact distance ties), duplicate reference
    points, queries on reference points."""
    a = torch.randint(-4, 5, (b, n, 3), generator=gen, device=dev).float()
    r = torch.randint(-4, 5, (b, m, 3), generator=gen, device=dev).float()
    r[:, 1::9] = r[:, 0::9][:, :r[:, 1::9].shape[1]]
    a[:, : min(n, m)] = r[:, : min(n, m)]
    return a, r


@pytest.mark.parametrize("b,n,m", [(16, 624, 624), (2, 300, 2500),
                                   (3, 129, 1), (1, 5000, 4099)],
                         ids=["train", "ragged-tile", "one-candidate",
                              "three-tiles"])
def test_nn_kernel_matches_plain(dev, gen, b, n, m):
    """Bit for bit, values and indices: ties to the lowest index,
    duplicate points, M not a multiple of the tile, M = 1."""
    a, r = _nn_inputs(gen, dev, b, n, m)
    before = tcham.KERNEL.launches
    got = tcham.nn_one_way(a, r)
    assert tcham.KERNEL.launches == before + 1
    want = tcham.nn_one_way_plain(a, r)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    x = torch.randn((b, n, 3), generator=gen, device=dev)
    y = torch.randn((b, m, 3), generator=gen, device=dev)
    got, want = tcham.nn_one_way(x, y), tcham.nn_one_way_plain(x, y)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_nn_kernel_rejects_what_it_does_not_take(dev):
    a = torch.zeros(2, 8, 3, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcham.nn_one_way(a, torch.zeros(2, 8, 3))
    with pytest.raises(ValueError, match="float32"):
        tcham.nn_one_way(a, a.double())
    with pytest.raises(ValueError, match="contiguous"):
        tcham.nn_one_way(a, torch.zeros(2, 3, 8, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="need a"):
        tcham.nn_one_way(a, torch.zeros(3, 8, 3, device=dev))
    with pytest.raises(ValueError, match="need a"):
        tcham.nn_one_way(a, torch.zeros(2, 0, 3, device=dev))


def test_nn_distance_backward_on_gpu_matches_cpu(dev, gen):
    """The saved-argmin backward on the card (index_add with atomics)
    against the CPU's: to 1e-6 (sum order)."""
    x1 = torch.randn((4, 300, 3), generator=gen, device=dev)
    x2 = torch.randn((4, 500, 3), generator=gen, device=dev)
    grads = []
    for d in (dev, "cpu"):
        a = x1.to(d).detach().requires_grad_()
        b = x2.to(d).detach().requires_grad_()
        d1, _, d2, _ = tcham.nn_distance(a, b)
        (d1.sum() + 2.0 * d2.sum()).backward()
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for g, c in zip(*grads):
        torch.testing.assert_close(g, c, atol=1e-6, rtol=1e-6)


def test_train_step_on_gpu_matches_cpu(dev):
    """One train step of a small net (random weights from a seed) at its
    top ratio, re-patch seeds pinned: the card's loss against the CPU's
    to 1e-5 relative, and every kernel of the path launched."""
    from threepu_torch.models import Net
    from threepu_torch.train import make_optimizer, train_step
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 32, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.standard_normal((3, 256, 3)).astype(np.float32))
    seeds = [torch.from_numpy(rng.integers(0, 64, (3, 1))) for _ in range(2)]
    losses = []
    for d in ("cpu", dev):
        torch.manual_seed(0)
        net = Net(max_up_ratio=8, knn=8, growth_rate=12, dense_n=3,
                  max_num_point=32, fm_knn=5).to(d)
        opt = make_optimizer(net.parameters())
        counts = [k.launches for k in (tsel.KERNEL, til.KERNEL, tcham.KERNEL)]
        losses.append(train_step(net, opt, x.to(d), gt.to(d), 8,
                                 seed_idx=seeds).item())
        after = [k.launches for k in (tsel.KERNEL, til.KERNEL, tcham.KERNEL)]
    assert all(a > c for a, c in zip(after, counts))
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)


def test_pipeline_on_gpu_matches_cpu(dev):
    """The golden-scale pipeline (random weights from a seed) on the GPU
    against the same port on the CPU, to float32 rounding."""
    from threepu_torch.inference import upsample_point_cloud
    from threepu_torch.models import Net
    torch.manual_seed(0)
    net = Net(max_up_ratio=4, step_ratio=2, knn=8, growth_rate=4, dense_n=2,
              max_num_point=32, fm_knn=3).eval()
    pts = np.random.default_rng(1234).standard_normal((96, 3)).astype(
        np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    want = upsample_point_cloud(net, torch.from_numpy(pts), 4, 32, 384,
                                chunk=4)
    counts = [k.launches for k in (tsel.KERNEL, tfps.KERNEL, til.KERNEL)]
    got = upsample_point_cloud(net.to(dev), torch.from_numpy(pts).to(dev), 4,
                               32, 384, chunk=4)
    after = [k.launches for k in (tsel.KERNEL, tfps.KERNEL, til.KERNEL)]
    assert all(a > c for a, c in zip(after, counts))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
