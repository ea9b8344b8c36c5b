"""Nearest-neighbour distances (port of ``threepu/ops/chamfer.py``).

Only :func:`self_nn_dist2`, which the eval cascade's outlier test uses,
is ported here; ``nn_distance`` and its Pallas kernel belong to the
training loss and come with the training path.
"""

from __future__ import annotations

import torch

from threepu_torch.ops.distances import pairwise_dist2


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
