"""Point-cloud normalization (port of ``threepu/ops/normalize.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def normalize_point_batch_cl(pc: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``pc (..., N, C)`` -> ``(normalized, centroid (..., 1, C),
    radius (..., 1, 1))``: subtract the centroid, divide by the largest
    2-norm."""
    centroid = torch.mean(pc, dim=-2, keepdim=True)
    pc = pc - centroid
    radius = torch.amax(torch.sqrt(torch.sum(pc * pc, dim=-1, keepdim=True)),
                        dim=-2, keepdim=True)
    return pc / radius, centroid, radius
