"""Nearest-neighbour distances (port of ``threepu/ops/chamfer.py``):
kernel 5 of the port.

- :func:`nn_one_way_plain`: per point of ``a``, ``(min d², argmin)``
  over ``b``, by direct subtraction, ties to the lowest index; the plain
  PyTorch version of ``threepu/ops/chamfer_pallas.py``'s ``_nn_kernel``.
- :func:`nn_one_way`: the CUDA kernel ``csrc/chamfer.cu`` on CUDA
  tensors, :func:`nn_one_way_plain` on CPU tensors.
- :func:`nn_distance`: both directions, differentiable like the JAX
  package's custom VJP (``threepu/ops/chamfer.py:62-107``): the backward
  gathers the nearest points from the saved argmins and scatter-adds the
  cross terms.  It is plain PyTorch (``index_add``), as JAX computes it
  as an XLA scatter outside any Pallas kernel; on CUDA the scatter sums
  with atomics, in an order that changes from run to run.
- :func:`self_nn_dist2`: the eval cascade's outlier test.

The JAX package ranks in the matmul form ``|a|² - 2ab + |b|²`` on the
CPU and by direct subtraction in its TPU kernel; the port ranks by
direct subtraction everywhere, so its values equal the TPU kernel's and
differ from the matmul form by float32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor
from threepu_torch.ops.distances import pairwise_dist2, sq_dist3
from threepu_torch.ops.gather import batched_gather

KERNEL = Kernel("threepu_nn_one_way",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
                source="threepu_torch/csrc/chamfer.cu",
                replaces="threepu/ops/chamfer_pallas.py:32")

#: distances per row chunk of the plain version (64 MB of float32), so
#: that 80k x 80k stays within a few hundred MB of temporaries
_PLAIN_CHUNK = 1 << 24
#: the kernel's grid puts the batch on its y axis
_MAX_BATCH = 65535


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


def nn_one_way(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_one_way_plain`'s result, by the CUDA kernel on CUDA
    tensors (contiguous float32, finite, ``B <= 65535``)."""
    if not a.is_cuda:
        return nn_one_way_plain(a, b)
    check_cuda_tensor("nn_one_way: a", a, torch.float32, 3)
    check_cuda_tensor("nn_one_way: b", b, torch.float32, 3)
    bsz, n, c = a.shape
    m = b.shape[1]
    if (c != 3 or tuple(b.shape) != (bsz, m, 3) or not 1 <= bsz <= _MAX_BATCH
            or n == 0 or m == 0):
        raise ValueError("nn_one_way: need a (B, N, 3) and b (B, M, 3) with "
                         f"1 <= B <= {_MAX_BATCH}, N >= 1, M >= 1, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    dist = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    KERNEL(a.data_ptr(), b.data_ptr(), dist.data_ptr(), idx.data_ptr(), bsz,
           n, m)
    return dist, idx


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
        d1, i1 = nn_one_way(xyz1, xyz2)
        d2, i2 = nn_one_way(xyz2, xyz1)
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
