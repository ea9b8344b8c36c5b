"""Inverse-distance interpolation from the three nearest points, PointNet++'s
feature propagation (``three_nn`` and ``three_interpolate`` of its
``tf_ops/3d_interpolation``), plain PyTorch.

The three neighbours are ranked as every kNN site of the port ranks them
(:func:`~threepu_torch.ops.knn.knn_group`: matmul-form distances, ties to
the lowest index, the selection kernel on the card); the weights then
take the direct squared distance to each, as the published ``three_nn``
returns it: ``w = 1 / max(d, 1e-10)``, normalized to sum 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from threepu_torch.ops.distances import sq_dist3
from threepu_torch.ops.gather import batched_gather
from threepu_torch.ops.knn import knn_group

#: the published floor under a squared distance before it is inverted
MIN_DIST2 = 1e-10


def three_nn(xyz: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``xyz (B, N, 3)``, ``known (B, M >= 3, 3)`` -> ``(dist2 (B, N, 3),
    int32 idx (B, N, 3))``: the three nearest known points of each point,
    nearest first, with their direct squared distances."""
    idx = knn_group(xyz, known, 3, with_neighbors=False).idx
    d = sq_dist3(xyz[..., None, :], batched_gather(known, idx))
    return d, idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dist2: torch.Tensor) -> torch.Tensor:
    """``features (B, M, C)`` at the known points, ``idx`` and ``dist2``
    of :func:`three_nn` -> ``(B, N, C)``, each point's three neighbours
    weighted by their inverse distance, normalized to sum 1."""
    inv = 1.0 / torch.clamp(dist2, min=MIN_DIST2)
    w = inv / torch.sum(inv, dim=-1, keepdim=True)
    return torch.sum(batched_gather(features, idx) * w[..., None], dim=-2)
