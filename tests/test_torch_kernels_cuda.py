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
