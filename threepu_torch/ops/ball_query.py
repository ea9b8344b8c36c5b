"""Ball query (port of ``threepu/ops/ball_query.py``), plain PyTorch: the
JAX package computes it with XLA, not with a Pallas kernel.

For each query, up to ``nsample`` indices of the points strictly within
``radius`` (squared distance in the matmul form below ``radius**2``
rounded to float32), in index order; the slots after the hits hold the
first hit, and a query without a hit gets all zeros.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from threepu_torch.ops.distances import pairwise_dist2


def ball_query(radius: float, nsample: int, points: torch.Tensor,
               queries: torch.Tensor,
               valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``points (B, N, 3)``, ``queries (B, M, 3)``, optional bool
    ``valid_mask (B, N)`` (invalid points never match) -> int32 ``(B, M,
    nsample)`` indices."""
    d = pairwise_dist2(queries, points)                       # (B, M, N)
    r = np.float32(radius)
    within = d < float(r * r)
    if valid_mask is not None:
        within = within & valid_mask[:, None, :]
    # a point fills the slot of its rank among the hits before it
    rank = torch.cumsum(within.to(torch.int32), dim=-1) - 1
    slot = torch.where(within, rank, nsample).clamp(max=nsample).long()
    col = torch.arange(points.shape[-2], device=d.device, dtype=torch.int32)
    out = torch.full((*d.shape[:-1], nsample + 1), -1, dtype=torch.int32,
                     device=d.device)
    out.scatter_reduce_(-1, slot, torch.where(within, col, -1), "amax")
    out = out[..., :nsample]
    first = torch.where(within.any(-1), within.to(torch.uint8).argmax(-1), 0)
    return torch.where(out >= 0, out, first[..., None].to(torch.int32))
