"""Furthest point sampling: kernel 2 of the port.

Counterpart of ``threepu/ops/fps.py`` and ``threepu/ops/fps_pallas.py``.
FPS starts at the first valid index with a min-distance carry of 1e10,
picks the point with the largest carry at each step (ties to the lowest
index), and never picks a masked or non-finite point while a valid one
is left.

- :func:`fps_plain`: the plain PyTorch version (``fps_indices`` with
  ``sanitize_points``), one Python step per pick.
- :func:`fps`: the CUDA kernel ``csrc/fps.cu`` on a CUDA tensor,
  :func:`fps_plain` on a CPU tensor.  On the GPU every FPS call of the
  pipeline goes through it, the 48 seed picks included.  The kernel
  splits each cloud over a thread-block cluster; :func:`fps_plan` sizes
  the cluster.
- :func:`fps_hierarchical`: Morton-stratified grouped FPS, for the final
  re-stitch and for clouds above :data:`PALLAS_MAX_N` points.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from threepu_torch._build import Kernel, check_cuda_tensor

_INIT_DIST = 1e10
#: clouds above this many points take :func:`fps_hierarchical`, as the
#: JAX package does on the TPU, so groupings match it
PALLAS_MAX_N = 480_000
_INT32_MAX = 2**31 - 1
#: the largest cluster the kernel takes: 8, the portable maximum on
#: Hopper (a pick on a cluster of 16 cost about a third more than on one of
#: 8 wherever both were timed: PERF.md)
MAX_CLUSTER = 8
#: a block's slice stays in its 256 threads' registers, 8 or 16 points a
#: thread, up to 16 * 256 points; in its shared memory as float4 (x, y, z,
#: carry) up to MAX_STAGED_BYTES (225 KiB of the 227 KiB a Hopper block may
#: opt into, the rest left for the kernel's static shared memory); and in
#: device memory above that
BLOCK_THREADS = 256
MAX_STAGED_BYTES = 225 * 1024
#: the kernel's codes for where a block keeps its slice
STORAGE = ("device", "shared", "registers-8", "registers-16")
#: SMs of an H100 SXM, the plan's default; the wrapper reads the card's
H100_SMS = 132

KERNEL = Kernel("threepu_fps",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
                source="threepu_torch/csrc/fps.cu",
                replaces="threepu/ops/fps_pallas.py:33")


class FpsPlan(NamedTuple):
    """How the kernel lays out one call: ``cluster`` blocks per cloud,
    each owning ``slice`` consecutive points, kept in ``storage``: one of
    :data:`STORAGE`."""
    cluster: int
    storage: str
    slice: int


def fps_plan(b: int, n: int, m: int, sms: int = H100_SMS) -> FpsPlan:
    """The kernel's layout for ``b`` clouds of ``n`` points and ``m``
    picks on a card of ``sms`` SMs.  The cluster is a power of two up to
    :data:`MAX_CLUSTER` whose ``b`` clusters fit on the SMs at one block
    each: the smallest whose blocks hold their slice in registers at 8
    points a thread, else at 16; where none does (clouds above 32,768
    points), the largest."""
    if b < 1 or not 1 <= n <= _INT32_MAX or m < 1 or sms < 1:
        raise ValueError(f"fps: no launch plan for B={b}, N={n}, m={m} on "
                         f"{sms} SMs: need B >= 1, 1 <= N < 2**31, m >= 1 "
                         "and an SM")
    top = MAX_CLUSTER
    while top > 1 and b * top > sms:
        top //= 2
    for regs in (8, 16):
        c = 1
        while c <= top:
            if -(-n // c) <= regs * BLOCK_THREADS:
                return _layout(c, n)
            c *= 2
    return _layout(top, n)


def _layout(c: int, n: int) -> FpsPlan:
    """Clusters of ``c`` blocks over clouds of ``n`` points, each block's
    slice in registers where it fits, else in shared memory, else in
    device memory."""
    per = -(-n // c)
    for regs in (8, 16):
        if per <= regs * BLOCK_THREADS:
            return FpsPlan(c, f"registers-{regs}", per)
    return FpsPlan(c, "shared" if per * 16 <= MAX_STAGED_BYTES else "device",
                   per)


def sanitize_points(points: torch.Tensor,
                    valid_mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-finite points become invalid, and their coordinates zero."""
    finite = torch.all(torch.isfinite(points), dim=-1)
    points = torch.where(finite[..., None], points, torch.zeros_like(points))
    mask = finite if valid_mask is None else (valid_mask & finite)
    return points, mask


def fps_plain(points: torch.Tensor, m: int,
              valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``points (B, N, 3)`` -> ``(B, m)`` int32 indices in pick order."""
    b, n, _ = points.shape
    points, mask = sanitize_points(points.to(torch.float32), valid_mask)
    rows = torch.arange(b, device=points.device)
    last = torch.argmax(mask.to(torch.int32), dim=-1)        # first valid
    temp = torch.where(mask, torch.full_like(points[..., 0], _INIT_DIST),
                       torch.full_like(points[..., 0], float("-inf")))
    picks = [last]
    for _ in range(m - 1):
        diff = points - points[rows, last][:, None, :]
        dx, dy, dz = diff.unbind(-1)
        d = dx * dx + dy * dy + dz * dz
        temp = torch.minimum(temp, d)
        last = torch.argmax(temp, dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def fps(points: torch.Tensor, m: int,
        valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`fps_plain`'s result, by the CUDA kernel on a CUDA tensor.

    The kernel takes contiguous float32 ``points (B, N, 3)`` and a bool
    ``valid_mask (B, N)``.
    """
    if not points.is_cuda:
        return fps_plain(points, m, valid_mask)
    check_cuda_tensor("fps: points", points, torch.float32, 3)
    b, n, c = points.shape
    if c != 3 or not 1 <= m or n < 1:
        raise ValueError(f"fps: need points (B, N>=1, 3) and m >= 1, got "
                         f"{tuple(points.shape)}, m={m}")
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    check_cuda_tensor("fps: valid_mask", valid_mask, torch.bool, 2)
    if tuple(valid_mask.shape) != (b, n):
        raise ValueError(f"fps: valid_mask {tuple(valid_mask.shape)} does "
                         f"not match points {tuple(points.shape)}")
    out = torch.empty((b, m), dtype=torch.int32, device=points.device)
    if b:
        sms = torch.cuda.get_device_properties(
            points.device).multi_processor_count
        _launch(points, valid_mask, out, fps_plan(b, n, m, sms))
    return out


def _launch(points: torch.Tensor, valid_mask: torch.Tensor,
            out: torch.Tensor, plan: FpsPlan) -> None:
    """The kernel on checked inputs, laid out by ``plan``; writes ``out
    (B, m)``."""
    b, n, _ = points.shape
    scratch = torch.empty((b * n if plan.storage == "device" else 0, 4),
                          dtype=torch.float32, device=points.device)
    KERNEL(points.data_ptr(), valid_mask.view(torch.uint8).data_ptr(),
           scratch.data_ptr(), out.data_ptr(), b, n, out.shape[1],
           plan.cluster, STORAGE.index(plan.storage))


def _dispatch_fps(points: torch.Tensor, m: int,
                  valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS of the pipeline: hierarchical above :data:`PALLAS_MAX_N`
    points, :func:`fps` otherwise."""
    if points.shape[-2] > PALLAS_MAX_N:
        return fps_hierarchical(points, m, valid_mask=valid_mask)
    return fps(points, m, valid_mask)


def morton_codes(points: torch.Tensor, bits: int = 10,
                 valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Z-order keys ``(B, N, 3)`` -> ``(B, N)`` int32: coordinates are
    min-max quantized per cloud (over the valid points only, when
    ``valid_mask`` is given) to a ``2^bits`` grid and bit-interleaved."""
    if valid_mask is not None:
        m = valid_mask[..., None]
        inf = torch.tensor(float("inf"), device=points.device)
        lo = torch.amin(torch.where(m, points, inf), dim=-2, keepdim=True)
        hi = torch.amax(torch.where(m, points, -inf), dim=-2, keepdim=True)
    else:
        lo = torch.amin(points, dim=-2, keepdim=True)
        hi = torch.amax(points, dim=-2, keepdim=True)
    # a true division: `int / tensor` would take the reciprocal first and
    # round twice, moving points across quantization cells
    scale = torch.full_like(hi, 2**bits - 1) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((points - lo) * scale).to(torch.int32), 0, 2**bits - 1)

    def spread(v):  # every bit of v to every 3rd position (bits <= 10)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
            | (spread(q[..., 2]) << 2))


def _stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def fps_hierarchical(points: torch.Tensor, m: int,
                     valid_mask: Optional[torch.Tensor] = None,
                     group_max: int = PALLAS_MAX_N) -> torch.Tensor:
    """Grouped FPS (port of ``threepu/ops/fps.py:189-289``, Morton sort).

    The cloud is Z-order sorted, its valid points are spread evenly over
    ``G = ceil(N / group_max)`` contiguous groups, each group picks
    ``ceil(m / G)`` points by :func:`fps` (all groups in one batch), and
    the picks interleave round-robin across groups before the cut to
    ``m``; picks on invalid points go behind every valid pick.
    """
    b, n, c = points.shape
    dev = points.device
    groups = -(-n // group_max)
    n_pad = -(-n // groups) * groups
    per = n_pad // groups
    m_per = -(-m // groups)

    pts = torch.nn.functional.pad(points, (0, 0, 0, n_pad - n))
    mask = (torch.arange(n_pad, device=dev) < n)[None, :]
    if valid_mask is not None:
        mask = mask & torch.nn.functional.pad(valid_mask, (0, n_pad - n))
    mask = mask.expand(b, n_pad)

    key = torch.where(mask, morton_codes(pts, valid_mask=mask),
                      torch.tensor(_INT32_MAX, dtype=torch.int32, device=dev))
    order = _stable_argsort(key)                                # (B, n_pad)
    mask_s = torch.gather(mask, 1, order)
    # spread the valid run so every group gets ceil(n_valid / G)
    # contiguous-curve valid points; invalid points fill the free slots
    i = torch.arange(n_pad, device=dev)[None, :]
    n_valid = mask_s.sum(dim=-1, keepdim=True)
    vpg = torch.clamp(-(-n_valid // groups), min=1)
    g = torch.clamp(i // vpg, max=groups - 1)
    p_valid = g * per + (i - g * vpg)
    occupied = torch.zeros((b, n_pad), dtype=torch.int32, device=dev)
    occupied = occupied.scatter_reduce(
        1, torch.where(mask_s, p_valid, torch.zeros_like(p_valid)),
        mask_s.to(torch.int32), reduce="amax")
    free = _stable_argsort(occupied)                            # zeros first
    s = torch.clamp(i - n_valid, 0, n_pad - 1)
    dest = torch.where(mask_s, p_valid, torch.gather(free, 1, s))
    order = torch.zeros_like(order).scatter(1, dest, order)
    pts = torch.gather(pts, 1, order[..., None].expand(b, n_pad, c))
    mask = torch.gather(mask, 1, order)

    idx = fps(pts.reshape(b * groups, per, c).contiguous(), m_per,
              mask.reshape(b * groups, per).contiguous())
    offset = (torch.arange(b * groups, device=dev) % groups) * per
    idx = (idx.long() + offset[:, None]).reshape(b, groups, m_per)
    # round-robin interleave, so the dropped picks are each group's last
    idx = idx.transpose(1, 2).reshape(b, groups * m_per)
    picked_valid = torch.gather(mask, 1, idx)
    keep = _stable_argsort((~picked_valid).to(torch.uint8))
    idx = torch.gather(idx, 1, keep)[:, :m]
    return torch.gather(order, 1, idx).to(torch.int32)
