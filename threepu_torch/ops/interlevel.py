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
its own.  Both are differentiable as the JAX package's XLA branch is:
only ``prev_feat`` receives a gradient, ``w * g`` scattered to the
picked rows, because JAX stops the gradient of both weight factors.
The kernel writes the weights ``w (B, N, k)`` as a third output, which
the backward reads.

Features stay float32 (the TPU kernel rounds them to bf16), and ``h_s``
is the min over all k picks (the TPU fused kernel takes the rank-1
pick's distance, which differs when that pick is a duplicate).

- :func:`interlevel_plain`: the plain PyTorch version.
- :func:`interlevel`: the CUDA kernel ``csrc/interlevel.cu`` on CUDA
  tensors, :func:`interlevel_plain` on CPU tensors.  The kernel spreads
  each sub-patch's queries over a thread-block cluster, a team of
  :data:`TEAM` lanes a query; :func:`interlevel_plan` sizes the cluster.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor
from threepu_torch.ops.distances import sq_dist3
from threepu_torch.ops.gather import batched_gather

#: rank of a duplicate (or phantom) previous point: after every real one
PENALTY = 1e30
#: kernel limits: k neighbours in registers, N queries of a sub-patch over
#: one cluster of at most MAX_CLUSTER blocks of at most 1024 threads
MAX_K = 8
MAX_N = 1024
#: lanes that share a query's scan (as csrc/interlevel.cu is built), and
#: the largest cluster (the portable maximum on Hopper)
TEAM = 8
MAX_CLUSTER = 8

KERNEL = Kernel("threepu_interlevel",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9,
                source="threepu_torch/csrc/interlevel.cu",
                replaces="threepu/ops/interlevel_pallas.py:94")


class InterlevelPlan(NamedTuple):
    """How the kernel lays out one sub-patch: ``cluster`` blocks of
    ``queries`` queries each (the last may hold fewer), ``threads``
    threads a block (a team of :data:`TEAM` lanes a query, whole warps)."""
    cluster: int
    queries: int
    threads: int


def interlevel_plan(n: int) -> InterlevelPlan:
    """The kernel's layout for sub-patches of ``n`` queries, which the C
    entry point takes as given: a cluster of up to :data:`MAX_CLUSTER`
    blocks, as many as leave every block at least one query.  With
    ``n <= 1024`` every block stays within 1024 threads."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"interlevel: no layout for N={n}: need "
                         f"1 <= N <= {MAX_N}")
    per = -(-n // min(MAX_CLUSTER, n))
    cluster = -(-n // per)            # no block without a query
    return InterlevelPlan(cluster, per, -(-per * TEAM // 32) * 32)


def _plain_picks(q_xyz, prev_xyz, prev_dup, k):
    """The plain version's picks ``(P, G*N, k)``, rank order."""
    b, n, _ = q_xyz.shape
    p = prev_xyz.shape[0]
    q = q_xyz.reshape(p, b // p * n, 1, 3)
    idx = []
    for t in range(p):       # one top patch at a time bounds the memory
        d = sq_dist3(q[t], prev_xyz[t][None])                # (G*N, M)
        d = torch.where(prev_dup[t][None], torch.tensor(
            PENALTY, dtype=d.dtype, device=d.device), d)
        idx.append(torch.sort(d, dim=-1, stable=True).indices[:, :k])
    return torch.stack(idx)


def _plain(q_xyz, xq, prev_xyz, prev_feat, prev_dup, k, with_w=True):
    """The plain version's ``(interp, idx, w)``."""
    b, n, _ = q_xyz.shape
    c = prev_feat.shape[-1]
    idx = _plain_picks(q_xyz, prev_xyz, prev_dup, k)
    nbrs = batched_gather(prev_xyz, idx).reshape(b, n, k, 3)
    feats = batched_gather(prev_feat, idx).reshape(b, n, k, c)

    d_s = sq_dist3(q_xyz[:, :, None, :], nbrs)               # (B, N, k)
    diff = xq[:, :, None, :] - feats
    d_f = torch.sum(diff * diff, dim=-1)
    h_s = torch.mean(torch.amin(d_s, dim=-1), dim=-1)[:, None, None]
    h_f = torch.mean(torch.amin(d_f, dim=-1), dim=-1)[:, None, None]
    w = torch.exp(-d_s / (h_s / 2.0)) * torch.exp(-d_f / (h_f / 2.0))
    w = w / torch.sum(w + 1e-5, dim=-1, keepdim=True)
    interp = torch.sum(w[..., None] * feats, dim=-2)
    return interp, idx.reshape(b, n, k).to(torch.int32), w


def _launch(q_xyz, xq, prev_xyz, prev_feat, prev_dup, k, with_w=True):
    """The kernel's ``(interp, idx, w)``, laid out by
    :func:`interlevel_plan`; ``w`` is None (and the kernel writes none)
    unless ``with_w``."""
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
    plan = interlevel_plan(n)
    out = torch.empty((b, n, c), dtype=torch.float32, device=q_xyz.device)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=q_xyz.device)
    w = (torch.empty((b, n, k), dtype=torch.float32, device=q_xyz.device)
         if with_w else None)
    KERNEL(q_xyz.data_ptr(), xq.data_ptr(), prev_xyz.data_ptr(),
           prev_feat.data_ptr(), prev_dup.view(torch.uint8).data_ptr(),
           out.data_ptr(), idx.data_ptr(), None if w is None else w.data_ptr(),
           b, n, p, m, c, k, *plan)
    return out, idx, w


class _Interlevel(torch.autograd.Function):
    """JAX's gradient of the skip and nothing else: the weights are
    stop-gradiented there (``threepu/models/upsampler.py:58-61``), so only
    ``prev_feat`` receives one, ``d prev_feat[p, idx] += w * g``."""

    @staticmethod
    def forward(ctx, q_xyz, xq, prev_xyz, prev_feat, prev_dup, k, kernel):
        # the weights are kept only where a backward can follow
        with_w = ctx.needs_input_grad[3]
        out, idx, w = (_launch if kernel else _plain)(
            q_xyz, xq, prev_xyz, prev_feat, prev_dup, k, with_w)
        ctx.save_for_backward(idx, w)
        ctx.prev_shape = prev_feat.shape
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g, _gidx):
        idx, w = ctx.saved_tensors
        p, m, c = ctx.prev_shape
        b, n, k = idx.shape
        rows = (idx.long().reshape(p, -1)
                + torch.arange(p, device=idx.device)[:, None] * m)
        src = (w[..., None] * g[:, :, None, :]).reshape(-1, c)
        grad = torch.zeros((p * m, c), dtype=g.dtype, device=g.device)
        grad.index_add_(0, rows.reshape(-1), src)
        return None, None, None, grad.reshape(p, m, c), None, None, None


def interlevel_plain(q_xyz: torch.Tensor, xq: torch.Tensor,
                     prev_xyz: torch.Tensor, prev_feat: torch.Tensor,
                     prev_dup: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``q_xyz (B, N, 3)``, ``xq (B, N, C)``, ``prev_xyz (P, M, 3)``,
    ``prev_feat (P, M, C)``, bool ``prev_dup (P, M)`` with ``P | B``
    (sub-patch ``b`` belongs to top patch ``b // (B // P)``) ->
    ``(interp (B, N, C), idx (B, N, k) int32)``."""
    return _Interlevel.apply(q_xyz, xq, prev_xyz, prev_feat, prev_dup, k,
                             False)


def interlevel(q_xyz: torch.Tensor, xq: torch.Tensor,
               prev_xyz: torch.Tensor, prev_feat: torch.Tensor,
               prev_dup: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`interlevel_plain`'s result, by the CUDA kernel on CUDA
    tensors (contiguous float32, bool ``prev_dup``; ``k <= 8``,
    ``N <= 1024``), laid out by :func:`interlevel_plan`."""
    return _Interlevel.apply(q_xyz, xq, prev_xyz, prev_feat, prev_dup, k,
                             q_xyz.is_cuda)
