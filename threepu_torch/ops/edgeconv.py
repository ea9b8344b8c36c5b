"""The DenseEdgeConv activation chain, fused and forward-only: kernel 6
of the port (counterpart of ``threepu/ops/edgeconv_pallas.py``).

With the per-point terms computed outside (``z = x @ W_d``,
``pts[0] = x @ (W_c - W_d) + b_0``, ``pts[i] = x @ W_i[g*i:] + b_i``), the
chain gathers ``zn = z[idx]``, runs ``g_0 = relu(zn + pts[0])``,
``g_i = [relu](sum_j g_{i-1-j} @ W_ij + pts[i])`` (no relu on the last
stage when ``n > 1``; with ``n = 1`` the only stage keeps its relu) and
max-pools every stage over the ``k`` neighbours.

- :func:`edge_conv_chain_plain`: the plain PyTorch version, on
  ``(B, N, k, G)`` tensors.
- :func:`edge_conv_chain`: the CUDA kernel ``csrc/edgeconv.cu`` on CUDA
  tensors, :func:`edge_conv_chain_plain` on CPU tensors.  Forward only,
  as in the JAX package: it raises when a gradient is asked of it.

:data:`ENABLED` is the eval path's toggle, read once per
``Net.upsample`` call through :func:`enabled_for`.  It is off by
default, as in the JAX package; whether the kernel ran shows in
``KERNEL.launches``, not in the output.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from threepu_torch._build import Kernel, check_cuda_tensor
from threepu_torch.ops.gather import batched_gather

KERNEL = Kernel("threepu_edge_conv_chain",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
                source="threepu_torch/csrc/edgeconv.cu",
                replaces="threepu/ops/edgeconv_pallas.py:103")

#: route the eval cascade's edge convs through :func:`edge_conv_chain`
ENABLED = False

#: what the kernel is instantiated for: stages ``n`` and growth rate ``g``
MAX_N = 4
MAX_G = 32

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def enabled_for(tensor: torch.Tensor) -> bool:
    """Whether the eval cascade on ``tensor``'s device takes the kernel:
    :data:`ENABLED` and a CUDA tensor."""
    return ENABLED and tensor.is_cuda


def _checked(z: torch.Tensor, idx: torch.Tensor, pts: Tensors,
             chain_w: Tensors, n: int, g: int):
    """The arguments as tensors ``z (B, N, G)``, ``idx (B, N, K)``,
    ``pts (B, n, N, G)``, ``chain_w (n(n-1)/2, G, G)``; raises on what
    the kernel does not take."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"edge_conv_chain: n={n} stages; the kernel takes "
                         f"1 <= n <= {MAX_N}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"edge_conv_chain: growth rate g={g}; the kernel "
                         f"takes 1 <= g <= {MAX_G}")
    if not isinstance(pts, torch.Tensor):
        pts = torch.stack(list(pts), dim=1)
    if not isinstance(chain_w, torch.Tensor):
        blocks = list(chain_w)
        chain_w = torch.stack(blocks) if blocks else z.new_zeros((0, g, g))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (z, pts, chain_w)):
        raise RuntimeError("edge_conv_chain is forward-only: call it under "
                           "torch.no_grad(), or take the decomposed "
                           "DenseEdgeConv path for a gradient")
    if z.dim() != 3 or idx.dim() != 3:
        raise ValueError("edge_conv_chain: need z (B, N, G) and idx (B, N, K),"
                         f" got {tuple(z.shape)} and {tuple(idx.shape)}")
    b, num_n, _ = z.shape
    k = idx.shape[-1]
    ncw = n * (n - 1) // 2
    if (z.shape[-1] != g or tuple(idx.shape[:2]) != (b, num_n)
            or tuple(pts.shape) != (b, n, num_n, g)
            or tuple(chain_w.shape) != (ncw, g, g)
            or min(b, num_n, k) < 1 or b * num_n >= 2 ** 31):
        raise ValueError(
            f"edge_conv_chain: need z (B, N, {g}), idx (B, N, K), pts "
            f"(B, {n}, N, {g}) and chain_w ({ncw}, {g}, {g}) with B, N, K >= 1"
            f", got {tuple(z.shape)}, {tuple(idx.shape)}, {tuple(pts.shape)} "
            f"and {tuple(chain_w.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"edge_conv_chain: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    return z, idx, pts, chain_w


def _plain(z: torch.Tensor, idx: torch.Tensor, pts: torch.Tensor,
           chain_w: torch.Tensor, n: int) -> torch.Tensor:
    zn = batched_gather(z, idx)                              # (B, N, K, G)
    gs = [torch.relu(zn + pts[:, 0, :, None, :])]
    blk = 0
    for i in range(1, n):
        y = None
        for j in range(i):
            term = gs[i - 1 - j] @ chain_w[blk]
            y = term if y is None else y + term
            blk += 1
        y = y + pts[:, i, :, None, :]
        gs.append(y if i == n - 1 else torch.relu(y))
    return torch.cat([torch.amax(gi, dim=-2) for gi in reversed(gs)], dim=-1)


def edge_conv_chain_plain(z: torch.Tensor, idx: torch.Tensor, pts: Tensors,
                          chain_w: Tensors, n: int, g: int) -> torch.Tensor:
    """``z (B, N, G)`` the gather source, ``idx (B, N, K)`` neighbour
    indices in ``[0, N)``, ``pts`` the ``n`` per-point terms (a sequence
    of ``(B, N, G)`` or one ``(B, n, N, G)`` tensor), ``chain_w`` the
    ``n(n-1)/2`` blocks ``(G, G)`` ordered by stage then position (block
    ``(i, j)`` multiplies ``g_{i-1-j}``; a sequence or one stacked
    tensor) -> ``(B, N, n*G)``: the pooled stages ``[g_{n-1}, ..., g_0]``
    (the caller appends ``x``)."""
    z, idx, pts, chain_w = _checked(z, idx, pts, chain_w, n, g)
    return _plain(z, idx, pts, chain_w, n)


def edge_conv_chain(z: torch.Tensor, idx: torch.Tensor, pts: Tensors,
                    chain_w: Tensors, n: int, g: int) -> torch.Tensor:
    """:func:`edge_conv_chain_plain`'s result, by the CUDA kernel on CUDA
    tensors (float32; ``1 <= n <= 4``, ``1 <= g <= 32``).

    The kernel reads contiguous arrays and int32 indices, so the wrapper
    copies what is not: ``idx`` as the edge conv passes it is a
    ``[..., 1:]`` slice, and ``pts`` arrives as ``n`` tensors.  An index
    outside ``[0, N)`` faults the launch.
    """
    z, idx, pts, chain_w = _checked(z, idx, pts, chain_w, n, g)
    if not z.is_cuda:
        return _plain(z, idx, pts, chain_w, n)
    z, pts, chain_w = z.contiguous(), pts.contiguous(), chain_w.contiguous()
    idx = idx.to(torch.int32).contiguous()
    check_cuda_tensor("edge_conv_chain: z", z, torch.float32, 3)
    check_cuda_tensor("edge_conv_chain: idx", idx, torch.int32, 3)
    check_cuda_tensor("edge_conv_chain: pts", pts, torch.float32, 4)
    check_cuda_tensor("edge_conv_chain: chain_w", chain_w, torch.float32, 3)
    b, num_n, _ = z.shape
    out = torch.empty((b, num_n, n * g), dtype=torch.float32, device=z.device)
    KERNEL(z.data_ptr(), idx.data_ptr(), pts.data_ptr(), chain_w.data_ptr(),
           out.data_ptr(), b, num_n, idx.shape[-1], n, g)
    return out
