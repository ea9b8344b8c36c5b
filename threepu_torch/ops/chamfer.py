"""Nearest-neighbour distances (port of ``threepu/ops/chamfer.py``):
kernel 5 of the port.

- :func:`nn_one_way_plain`: per point of ``a``, ``(min d², argmin)``
  over ``b``, by direct subtraction, ties to the lowest index; the plain
  PyTorch version of ``threepu/ops/chamfer_pallas.py``'s ``_nn_kernel``.
- :func:`nn_both_ways`: both directions, by one launch of the CUDA kernel
  ``csrc/chamfer.cu`` on CUDA tensors, :func:`nn_one_way_plain` twice on
  CPU tensors; :func:`nn_one_way` one direction, by the same kernel.
  :func:`chamfer_plan` lays the kernel out.
- :func:`nn_distance`: both directions, differentiable like the JAX
  package's custom VJP (``threepu/ops/chamfer.py:62-107``): the forward
  is one :func:`nn_both_ways` call; the backward gathers the nearest
  points from the saved argmins and scatter-adds the cross terms.  It is
  plain PyTorch (``index_add``), as JAX computes it as an XLA scatter
  outside any Pallas kernel; on CUDA the scatter sums with atomics, in an
  order that changes from run to run.
- :func:`self_nn_dist2`: the eval cascade's outlier test.

The JAX package ranks in the matmul form ``|a|² - 2ab + |b|²`` on the
CPU and by direct subtraction in its TPU kernel; the port ranks by
direct subtraction everywhere, so its values equal the TPU kernel's and
differ from the matmul form by float32 rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor, library
from threepu_torch.ops.distances import pairwise_dist2, sq_dist3
from threepu_torch.ops.gather import batched_gather

KERNEL = Kernel("threepu_nn",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6,
                source="threepu_torch/csrc/chamfer.cu",
                replaces="threepu/ops/chamfer_pallas.py:32")

#: distances per row chunk of the plain version (64 MB of float32), so
#: that 80k x 80k stays within a few hundred MB of temporaries
_PLAIN_CHUNK = 1 << 24
#: the kernel as ``csrc/chamfer.cu`` is built: candidates a thread stages
#: a tile, the largest block and the largest cluster (the portable maximum
#: on Hopper)
STAGE = 4
MAX_THREADS = 128
MAX_CLUSTER = 8
#: the fewest candidates a slice of a split candidate axis holds
MIN_SLICE = 64
_INT32_MAX = 2**31 - 1


class ChamferPlan(NamedTuple):
    """How the kernel lays out a call: a query a thread, ``threads``
    threads a block, the candidate axis over a cluster of ``cluster``
    blocks (block r scans the r-th slice of ``ceil(count / cluster)``
    candidates), staged in tiles of ``tile`` candidates."""
    threads: int
    cluster: int
    tile: int


def chamfer_slices(count: int, cluster: int) -> list:
    """The ``(start, stop)`` candidate slice of each block of a cluster of
    ``cluster`` blocks over ``count`` candidates, as the kernel cuts them
    (empty slices at the end where ``count`` is small)."""
    size = -(-count // cluster)
    return [(min(count, r * size), min(count, (r + 1) * size))
            for r in range(cluster)]


@functools.lru_cache(maxsize=64)
def chamfer_plan(b: int, n: int, m: int,
                 active: Callable[[int, int], int],
                 both_ways: bool = True) -> ChamferPlan:
    """The kernel's layout for ``a (b, n, 3)`` against ``b (b, m, 3)``
    (and back, if ``both_ways``), which the C entry point takes as given,
    on a card that holds ``active(threads, cluster)`` clusters at once.

    - The longest cloud's queries split into as few tiles as blocks of up
      to :data:`MAX_THREADS` threads hold, evenly, in whole warps.
    - The candidate axis splits over the largest cluster (up to
      :data:`MAX_CLUSTER`, no slice under :data:`MIN_SLICE` candidates) of
      which the card holds every one at once: the scan is bound by issue
      slots, so each SM needs its warps to the end, and a second, partial
      wave leaves most SMs short of them.
    - Where even clusters of 2 overflow one wave, the largest cluster that
      packs the card's SMs as fully as single blocks do (on an H100 pairs:
      clusters of 3 and more leave block slots of a GPC empty), so that
      more, shorter blocks even out the ragged last wave.
    """
    if b < 1 or not 1 <= n <= _INT32_MAX or not 1 <= m <= _INT32_MAX:
        raise ValueError(f"chamfer: no layout for B={b}, N={n}, M={m}: "
                         "need B >= 1 and 1 <= N, M < 2**31")
    cands = min(n, m) if both_ways else m
    sizes = range(2, max(1, min(MAX_CLUSTER, cands // MIN_SLICE)) + 1)
    longest = max(n, m) if both_ways else n
    tiles = -(-longest // MAX_THREADS)
    threads = -(-longest // (tiles * 32)) * 32
    clusters = b * (-(-n // threads) + (-(-m // threads) if both_ways else 0))
    one_wave = [s for s in sizes if clusters <= active(threads, s)]
    packed = [s for s in sizes
              if s * active(threads, s) >= active(threads, 1)]
    return ChamferPlan(threads, max([1] + (one_wave or packed)),
                       STAGE * threads)


def nn_one_way_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a (B, N, 3)``, ``b (B, M, 3)`` -> ``(dist (B, N), int32 idx
    (B, N))``: the squared distance to and index of each point's nearest
    point in ``b``, ties to the lowest index."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    rows = max(1, _PLAIN_CHUNK // max(1, bsz * m))
    dists, idxs = [], []
    for start in range(0, n, rows):
        d = sq_dist3(a[:, start:start + rows, None, :], b[:, None, :, :])
        v, i = torch.min(d, dim=-1)
        dists.append(v)
        idxs.append(i)
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _active_clusters(device: int, threads: int, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of ``threads`` threads CUDA
    device ``device`` holds at once."""
    fn = library().threepu_nn_max_clusters
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(threads, cluster, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"chamfer: no occupancy for clusters of {cluster} "
                           f"x {threads} threads (cudaError_t {err})")
    return out.value


@functools.lru_cache(maxsize=None)
def active_clusters(device: int) -> Callable[[int, int], int]:
    """:func:`chamfer_plan`'s ``active`` for CUDA device ``device``: the
    kernel's occupancy as the CUDA runtime reports it."""
    return functools.partial(_active_clusters, device)


def _launch(a: torch.Tensor, b: torch.Tensor, both_ways: bool,
            plan: Optional[ChamferPlan] = None) -> tuple:
    """The kernel's ``(dist1, idx1)``, and ``(dist2, idx2)`` too if
    ``both_ways``, in one launch laid out by ``plan`` (by default
    :func:`chamfer_plan`'s)."""
    check_cuda_tensor("chamfer: a", a, torch.float32, 3)
    check_cuda_tensor("chamfer: b", b, torch.float32, 3)
    bsz, n, c = a.shape
    m = b.shape[1]
    if (c != 3 or tuple(b.shape) != (bsz, m, 3) or bsz == 0 or n == 0
            or m == 0 or b.device != a.device):
        raise ValueError("chamfer: need a (B, N, 3) and b (B, M, 3) on one "
                         "device with B, N, M >= 1, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if plan is None:
        plan = chamfer_plan(bsz, n, m, active_clusters(a.device.index),
                            both_ways)
    out = [torch.empty((bsz, n), dtype=torch.float32, device=a.device),
           torch.empty((bsz, n), dtype=torch.int32, device=a.device)]
    if both_ways:
        out += [torch.empty((bsz, m), dtype=torch.float32, device=a.device),
                torch.empty((bsz, m), dtype=torch.int32, device=a.device)]
    ptrs = [t.data_ptr() for t in out] + [None, None] * (not both_ways)
    KERNEL(a.data_ptr(), b.data_ptr(), *ptrs, bsz, n, m, *plan)
    return tuple(out)


def nn_one_way(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_one_way_plain`'s result, by the CUDA kernel on CUDA
    tensors (contiguous float32, finite)."""
    if not a.is_cuda:
        return nn_one_way_plain(a, b)
    return _launch(a, b, both_ways=False)


def nn_both_ways(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """``(dist1, idx1, dist2, idx2)``: :func:`nn_one_way_plain` of ``a``
    against ``b`` and of ``b`` against ``a``, by one launch of the CUDA
    kernel on CUDA tensors (contiguous float32, finite)."""
    if not a.is_cuda:
        return (*nn_one_way_plain(a, b), *nn_one_way_plain(b, a))
    return _launch(a, b, both_ways=True)


def _scatter_add_rows(target: torch.Tensor, idx: torch.Tensor,
                      rows: torch.Tensor, alpha: float) -> torch.Tensor:
    """``target (B, N, C)`` plus ``alpha * rows (B, M, C)`` added at the
    rows ``idx (B, M)``, per batch element."""
    bsz, n, c = target.shape
    offset = torch.arange(bsz, device=idx.device)[:, None] * n
    flat = (idx.long() + offset).reshape(-1)
    return target.reshape(-1, c).index_add(
        0, flat, rows.reshape(-1, c), alpha=alpha).reshape(bsz, n, c)


class _NNDistance(torch.autograd.Function):
    """Both directions; the backward of ``threepu/ops/chamfer.py:87-104``."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, i1, d2, i2 = nn_both_ways(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, i1, d2, i2

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        xyz1, xyz2, i1, i2 = ctx.saved_tensors
        own1 = 2.0 * g1[..., None] * (xyz1 - batched_gather(xyz2, i1))
        own2 = 2.0 * g2[..., None] * (xyz2 - batched_gather(xyz1, i2))
        grad1 = _scatter_add_rows(own1, i2, own2, -1.0)
        grad2 = _scatter_add_rows(own2, i1, own1, -1.0)
        return grad1, grad2


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """``xyz1 (B, N, 3)``, ``xyz2 (B, M, 3)`` -> ``(dist1 (B, N), idx1,
    dist2 (B, M), idx2)``: squared nearest-neighbour distances both ways
    and int32 argmins.  Differentiable in the distances; the indices are
    not."""
    return _NNDistance.apply(xyz1.contiguous(), xyz2.contiguous())


def nndistance(xyz1: torch.Tensor, xyz2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The reference's name for :func:`nn_distance`."""
    return nn_distance(xyz1, xyz2)


def self_nn_dist2(points: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Squared distance from each point to its nearest OTHER point,
    ``(B, N)``: a masked min over row chunks of the distance matrix, so
    at most ``chunk x N`` distances exist at once."""
    n = points.shape[-2]
    cols = torch.arange(n, device=points.device)
    out = []
    for start in range(0, n, chunk):
        rows = points[:, start:start + chunk]
        d = pairwise_dist2(rows, points)                     # (B, rows, N)
        ids = torch.arange(start, start + rows.shape[1], device=points.device)
        d = d.masked_fill(ids[:, None] == cols[None, :], float("inf"))
        out.append(torch.amin(d, dim=-1))
    return torch.cat(out, dim=1)
