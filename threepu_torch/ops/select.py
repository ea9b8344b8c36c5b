"""Exact k-smallest selection per row: kernel 1 of the port.

Counterpart of ``threepu/ops/select_pallas.py`` (``_make_kernel`` and
``select_pallas``).  Both return ``(dist2, idx)`` of the ``k`` smallest
values of each row of a penalized distance matrix, ordered by value and
then by index, with the values copied verbatim — what a stable
ascending sort gives.  Every 1e30 penalty column is a tie, so the order
among ties matters; ``torch.topk`` does not promise it and is never
used.

- :func:`select_plain`: the plain PyTorch version (stable sort + slice).
- :func:`select`: the CUDA kernel ``csrc/select.cu`` on a CUDA tensor,
  :func:`select_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor

#: the largest k the kernel takes (the JAX package's dispatch cap)
MAX_K = 64

KERNEL = Kernel("threepu_select",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int],
                source="threepu_torch/csrc/select.cu",
                replaces="threepu/ops/select_pallas.py:79")


def select_plain(d: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``d (..., N)`` -> ``(values, int32 indices)`` of shape ``(..., k)``:
    the k smallest per row, ascending, ties to the lowest index."""
    if k > d.shape[-1]:
        raise ValueError(f"k={k} exceeds candidate count {d.shape[-1]}")
    values, idx = torch.sort(d, dim=-1, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def select(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_plain`'s result, by the CUDA kernel on a CUDA tensor.

    The kernel takes a contiguous float32 ``d`` without NaN, and
    ``k <= 64``.
    """
    if not d.is_cuda:
        return select_plain(d, k)
    *lead, n = d.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"select: need 1 <= k <= min(N, {MAX_K}), got "
                         f"k={k}, N={n}")
    rows = d.numel() // n
    d2 = d.reshape(rows, n)
    check_cuda_tensor("select: d", d2, torch.float32, 2)
    values = torch.empty((rows, k), dtype=torch.float32, device=d.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=d.device)
    if rows:
        KERNEL(d2.data_ptr(), values.data_ptr(), idx.data_ptr(), rows, n, k)
    return values.reshape(*lead, k), idx.reshape(*lead, k)
