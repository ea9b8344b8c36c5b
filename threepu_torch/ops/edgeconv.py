"""The DenseEdgeConv activation chain, fused and forward-only: kernel 6
of the port (counterpart of ``threepu/ops/edgeconv_pallas.py``).

With the per-point terms computed outside (``z = x @ W_d``,
``pts[0] = x @ (W_c - W_d) + b_0``, ``pts[i] = x @ W_i[g*i:] + b_i``), the
chain gathers ``zn = z[idx]``, runs ``g_0 = relu(zn + pts[0])``,
``g_i = [relu](sum_j g_{i-1-j} @ W_ij + pts[i])`` (no relu on the last
stage when ``n > 1``; with ``n = 1`` the only stage keeps its relu) and
max-pools every stage over the ``k`` neighbours.

- :func:`edge_conv_chain_plain`: the plain PyTorch version, on
  ``(B, N, k, G)`` tensors, with a gradient.
- :func:`edge_conv_chain`: the CUDA kernel ``csrc/edgeconv.cu`` on CUDA
  tensors, :func:`edge_conv_chain_plain` on CPU tensors.  Forward only,
  as in the JAX package: it raises when a gradient is asked of it, and
  it takes ``n <= MAX_N`` stages of growth rate ``g <= MAX_G``.

:func:`takes_kernel` is the eval cascade's route, asked once per
``Net.upsample`` call: the kernel on a CUDA tensor wherever the net's
stages and growth rate fit it, the plain chain elsewhere.  Whether the
kernel ran shows in ``KERNEL.launches``, not in the output.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Sequence, Tuple, Union

import torch

from threepu_torch._build import Kernel
from threepu_torch.ops.gather import batched_gather

KERNEL = Kernel("threepu_edge_conv_chain", [ctypes.c_char_p],
                source="threepu_torch/csrc/edgeconv.cu",
                replaces="threepu/ops/edgeconv_pallas.py:103")

#: what the kernel is instantiated for: stages ``n`` and growth rate ``g``
MAX_N = 4
MAX_G = 32
_MAX_BLOCKS = MAX_N * (MAX_N - 1) // 2


#: ``EdgeConvArgs`` of ``csrc/edgeconv.cu``, packed: z, its two strides;
#: idx, its two strides; the stages' pointers, batch and row strides; the
#: blocks' pointers, row and column strides; out; bsz, n_pts, k, n, g,
#: idx64 (every field at its natural alignment, 320 bytes)
_ARGS = struct.Struct(f"=Qqq Qqq {MAX_N}Q{MAX_N}q{MAX_N}q "
                      f"{_MAX_BLOCKS}Q{_MAX_BLOCKS}q{_MAX_BLOCKS}q Q 6i")


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def takes_kernel(x: torch.Tensor, n: int, g: int) -> bool:
    """Whether the eval cascade's edge convs of ``n`` stages of growth
    rate ``g`` on ``x``'s device take the kernel.  A net's graphs keep
    the route they were captured on: a caller that patches this clears
    them (``net._stages.clear()``)."""
    return x.is_cuda and n <= MAX_N and g <= MAX_G


def _checked(z: torch.Tensor, idx: torch.Tensor, pts: Tensors,
             chain_w: Tensors, n: int, g: int
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ``n`` stages' ``pts (B, N, G)`` and the ``n(n-1)/2`` chain
    blocks ``(G, G)`` as lists (views of what was passed, no copy); raises
    on shapes that do not fit together."""
    if z.dim() != 3 or idx.dim() != 3:
        raise ValueError("edge_conv_chain: need z (B, N, G) and idx (B, N, K),"
                         f" got {tuple(z.shape)} and {tuple(idx.shape)}")
    # one (B, n, N, G) tensor or a sequence; a stacked (n(n-1)/2, G, G)
    # tensor of blocks iterates as its blocks
    stages = list(pts.unbind(1) if isinstance(pts, torch.Tensor) else pts)
    blocks = list(chain_w)
    b, num_n, _ = z.shape
    shape = (b, num_n, g)
    ncw = n * (n - 1) // 2
    if (z.shape[-1] != g or tuple(idx.shape[:2]) != (b, num_n)
            or len(stages) != n or len(blocks) != ncw
            or any(t.shape != shape for t in stages)
            or any(t.shape != (g, g) for t in blocks)
            or min(b, num_n, idx.shape[-1]) < 1 or b * num_n >= 2 ** 31):
        raise ValueError(
            f"edge_conv_chain: need z (B, N, {g}), idx (B, N, K), pts "
            f"(B, {n}, N, {g}) or {n} of (B, N, {g}), and "
            f"{ncw} chain blocks ({g}, {g}), with B, N, K >= 1, got "
            f"{tuple(z.shape)}, {tuple(idx.shape)}, "
            f"{[tuple(t.shape) for t in stages]} and "
            f"{[tuple(t.shape) for t in blocks]}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"edge_conv_chain: idx must be int32 or int64, got "
                         f"{idx.dtype}")
    return stages, blocks


def _plain(z: torch.Tensor, idx: torch.Tensor, pts: List[torch.Tensor],
           chain_w: List[torch.Tensor], n: int) -> torch.Tensor:
    zn = batched_gather(z, idx)                              # (B, N, K, G)
    gs = [torch.relu(zn + pts[0][:, :, None, :])]
    blk = 0
    for i in range(1, n):
        y = None
        for j in range(i):
            term = gs[i - 1 - j] @ chain_w[blk]
            y = term if y is None else y + term
            blk += 1
        y = y + pts[i][:, :, None, :]
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
    return _plain(z, idx, *_checked(z, idx, pts, chain_w, n, g), n)


def edge_conv_chain(z: torch.Tensor, idx: torch.Tensor, pts: Tensors,
                    chain_w: Tensors, n: int, g: int) -> torch.Tensor:
    """:func:`edge_conv_chain_plain`'s result, by the CUDA kernel on CUDA
    tensors (float32; ``1 <= n <= 4``, ``1 <= g <= 32``), forward only.

    The kernel reads every array through its strides and ``idx`` as
    int32 or int64, so the edge conv's ``[..., 1:]`` slice of its
    selection, the stages' terms as separate tensors or as views of one,
    and the chain blocks as views of the layer weights go in without a
    copy.  An index outside ``[0, N)`` faults the launch.
    """
    if not 1 <= n <= MAX_N:
        raise ValueError(f"edge_conv_chain: n={n} stages; the kernel takes "
                         f"1 <= n <= {MAX_N}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"edge_conv_chain: growth rate g={g}; the kernel "
                         f"takes 1 <= g <= {MAX_G}")
    stages, blocks = _checked(z, idx, pts, chain_w, n, g)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z, *stages, *blocks)):
        raise RuntimeError("edge_conv_chain is forward-only: call it under "
                           "torch.no_grad(), or take edge_conv_chain_plain "
                           "for a gradient")
    if not z.is_cuda:
        return _plain(z, idx, stages, blocks, n)
    return _launch(z, idx, stages, blocks, n, g)


def _launch(z: torch.Tensor, idx: torch.Tensor, stages: List[torch.Tensor],
            blocks: List[torch.Tensor], n: int, g: int) -> torch.Tensor:
    """The kernel's output for a CUDA call laid out by :func:`_checked`.
    Raises unless every tensor is float32 (idx int32 or int64) on z's
    device; copies only ``z``, ``idx`` or the stages where a last stride
    is not 1."""
    dev = z.device
    tensors = (z, *stages, *blocks)
    if any(t.dtype != torch.float32 or t.device != dev for t in tensors):
        got = sorted({f"{t.dtype} on {t.device}" for t in tensors})
        raise ValueError(f"edge_conv_chain: z, pts and chain_w: expected "
                         f"torch.float32 on {dev}, got {got}")
    if idx.device != dev:
        raise ValueError(f"edge_conv_chain: idx: expected a CUDA tensor on "
                         f"{dev}, got {idx.device}")
    zs, ids = z.stride(), idx.stride()
    if zs[-1] != 1:
        z = z.contiguous()
        zs = z.stride()
    if ids[-1] != 1:
        idx = idx.contiguous()
        ids = idx.stride()
    ss = [t.stride() for t in stages]
    if any(st[-1] != 1 for st in ss):
        stages = [t.contiguous() for t in stages]
        ss = [t.stride() for t in stages]
    ws = [t.stride() for t in blocks]
    b, num_n, _ = z.shape
    out = torch.empty((b, num_n, n * g), dtype=torch.float32, device=dev)
    pad_s, pad_w = [0] * (MAX_N - n), [0] * (_MAX_BLOCKS - len(blocks))
    KERNEL(_ARGS.pack(
        z.data_ptr(), zs[0], zs[1], idx.data_ptr(), ids[0], ids[1],
        *[t.data_ptr() for t in stages], *pad_s, *[st[0] for st in ss],
        *pad_s, *[st[1] for st in ss], *pad_s,
        *[t.data_ptr() for t in blocks], *pad_w, *[st[0] for st in ws],
        *pad_w, *[st[1] for st in ws], *pad_w,
        out.data_ptr(), b, num_n, idx.shape[-1], n, g,
        int(idx.dtype == torch.int64)))
    return out
