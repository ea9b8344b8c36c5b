"""The interlevel feature-propagation skip: kernel 3 of the port.

Counterpart of ``threepu/ops/interlevel_pallas.py`` — the fused kernel
(``_make_kernel``, levels 2-3) and the selection kernel with its XLA
tail (``_make_select_kernel`` + ``_interp_from_selection``, level 4) —
as ONE function.  It computes the grouped branch of
``threepu/models/upsampler.py:212-233``: for each point of each
sub-patch,

1. the ``k`` spatially nearest points of its top patch's previous set,
   ranked by the squared distance by direct subtraction, with
   ``prev_dup`` columns ranked at 1e30 (order: rank, then index);
2. their features;
3. weights ``exp(-d_s / (h_s / 2)) * exp(-d_f / (h_f / 2))`` from the
   true spatial distance ``d_s`` and the feature distance ``d_f``, where
   each ``h`` is the mean over the sub-patch's points of the min over
   the ``k`` picks, normalized as ``w / sum(w + 1e-5)``;
4. ``interp = sum_k w * feature``; the caller blends ``0.2 * interp + x``.

Both versions return ``(interp, idx)``: the picks ``idx (B, N, k)``
(int32, rank order) come out too, so the selection can be checked on
its own.

Features stay float32 (the TPU kernel rounds them to bf16), and ``h_s``
is the min over all k picks (the TPU fused kernel takes the rank-1
pick's distance, which differs when that pick is a duplicate).

- :func:`interlevel_plain`: the plain PyTorch version.
- :func:`interlevel`: the CUDA kernel ``csrc/interlevel.cu`` on CUDA
  tensors, :func:`interlevel_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor
from threepu_torch.ops.gather import batched_gather

#: rank of a duplicate (or phantom) previous point: after every real one
PENALTY = 1e30
#: kernel limits: k neighbours in registers, one thread per query
MAX_K = 8
MAX_N = 1024

KERNEL = Kernel("threepu_interlevel",
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6,
                source="threepu_torch/csrc/interlevel.cu",
                replaces="threepu/ops/interlevel_pallas.py:94")


def _sq3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared 3-D distance ``(dx*dx + dy*dy) + dz*dz`` over the last
    axis, rounded as the kernel rounds it."""
    dx, dy, dz = (a - b).unbind(-1)
    return dx * dx + dy * dy + dz * dz


def interlevel_plain(q_xyz: torch.Tensor, xq: torch.Tensor,
                     prev_xyz: torch.Tensor, prev_feat: torch.Tensor,
                     prev_dup: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q_xyz (B, N, 3)``, ``xq (B, N, C)``, ``prev_xyz (P, M, 3)``,
    ``prev_feat (P, M, C)``, bool ``prev_dup (P, M)`` with ``P | B``
    (sub-patch ``b`` belongs to top patch ``b // (B // P)``) ->
    ``(interp (B, N, C), idx (B, N, k) int32)``."""
    b, n, _ = q_xyz.shape
    p, m, c = prev_feat.shape
    group = b // p
    q = q_xyz.reshape(p, group * n, 1, 3)
    idx = []
    for t in range(p):       # one top patch at a time bounds the memory
        d = _sq3(q[t], prev_xyz[t][None])                    # (G*N, M)
        d = torch.where(prev_dup[t][None], torch.tensor(
            PENALTY, dtype=d.dtype, device=d.device), d)
        idx.append(torch.sort(d, dim=-1, stable=True).indices[:, :k])
    idx = torch.stack(idx)                                   # (P, G*N, k)
    nbrs = batched_gather(prev_xyz, idx).reshape(b, n, k, 3)
    feats = batched_gather(prev_feat, idx).reshape(b, n, k, c)

    d_s = _sq3(q_xyz[:, :, None, :], nbrs)                   # (B, N, k)
    diff = xq[:, :, None, :] - feats
    d_f = torch.sum(diff * diff, dim=-1)
    h_s = torch.mean(torch.amin(d_s, dim=-1), dim=-1)[:, None, None]
    h_f = torch.mean(torch.amin(d_f, dim=-1), dim=-1)[:, None, None]
    w = torch.exp(-d_s / (h_s / 2.0)) * torch.exp(-d_f / (h_f / 2.0))
    w = w / torch.sum(w + 1e-5, dim=-1, keepdim=True)
    interp = torch.sum(w[..., None] * feats, dim=-2)
    return interp, idx.reshape(b, n, k).to(torch.int32)


def interlevel(q_xyz: torch.Tensor, xq: torch.Tensor,
               prev_xyz: torch.Tensor, prev_feat: torch.Tensor,
               prev_dup: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`interlevel_plain`'s result, by the CUDA kernel on CUDA
    tensors (contiguous float32, bool ``prev_dup``; ``k <= 8``,
    ``N <= 1024``)."""
    if not q_xyz.is_cuda:
        return interlevel_plain(q_xyz, xq, prev_xyz, prev_feat, prev_dup, k)
    for name, t, dt, nd in (("q_xyz", q_xyz, torch.float32, 3),
                            ("xq", xq, torch.float32, 3),
                            ("prev_xyz", prev_xyz, torch.float32, 3),
                            ("prev_feat", prev_feat, torch.float32, 3),
                            ("prev_dup", prev_dup, torch.bool, 2)):
        check_cuda_tensor(f"interlevel: {name}", t, dt, nd)
    b, n, _ = q_xyz.shape
    p, m, c = prev_feat.shape
    if (q_xyz.shape[2] != 3 or tuple(xq.shape) != (b, n, c)
            or tuple(prev_xyz.shape) != (p, m, 3)
            or tuple(prev_dup.shape) != (p, m) or p == 0 or b == 0 or b % p):
        raise ValueError(
            "interlevel: shapes do not match q_xyz (B, N, 3), xq (B, N, C), "
            "prev_xyz (P, M, 3), prev_feat (P, M, C), prev_dup (P, M) with "
            f"P | B: {tuple(q_xyz.shape)} {tuple(xq.shape)} "
            f"{tuple(prev_xyz.shape)} {tuple(prev_feat.shape)} "
            f"{tuple(prev_dup.shape)}")
    if not 1 <= k <= min(m, MAX_K) or not 1 <= n <= MAX_N:
        raise ValueError(f"interlevel: need 1 <= k <= min(M, {MAX_K}) and "
                         f"1 <= N <= {MAX_N}, got k={k}, M={m}, N={n}")
    out = torch.empty((b, n, c), dtype=torch.float32, device=q_xyz.device)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=q_xyz.device)
    KERNEL(q_xyz.data_ptr(), xq.data_ptr(), prev_xyz.data_ptr(),
           prev_feat.data_ptr(), prev_dup.view(torch.uint8).data_ptr(),
           out.data_ptr(), idx.data_ptr(), b, n, p, m, c, k)
    return out, idx
