"""Row gathers (port of ``threepu/ops/gather.py``), as plain indexing."""

from __future__ import annotations

import torch


def batched_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (..., M, C)``, integer ``idx (..., X1, ..., Xk)`` in
    ``[0, M)`` -> ``(..., X1, ..., Xk, C)``.  The index axes are
    flattened first, so no ``(..., X, M, C)`` broadcast is built."""
    batch = points.shape[:-2]
    extra = idx.shape[len(batch):]
    c = points.shape[-1]
    flat = idx.reshape(*batch, -1).long()
    out = torch.gather(points, -2, flat[..., None].expand(*flat.shape, c))
    return out.reshape(*batch, *extra, c)


def gather_nd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channels-last gather: ``points (B, N, C)``, ``idx (B, M)`` ->
    ``(B, M, C)``."""
    return batched_gather(points, idx)
