"""Batch augmentation (port of ``threepu/data/augment.py``).

Optional per-point jitter of the input, normalization of input and label
by the label patch's centroid and radius, and one random rotation per
batch element shared by both.  Every random draw (rotation angles,
jitter noise) is either passed in or drawn from an explicit
``torch.Generator``, so that tests can hand both packages the same
numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from threepu_torch.ops.normalize import normalize_point_batch_cl


def rotations(angles: torch.Tensor) -> torch.Tensor:
    """``angles (B, 3)`` about x, y, z -> ``(B, 3, 3)`` matrices
    ``Rz @ Ry @ Rx``."""
    cx, cy, cz = torch.cos(angles).unbind(-1)
    sx, sy, sz = torch.sin(angles).unbind(-1)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    shape = (*angles.shape[:-1], 3, 3)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     -1).reshape(shape)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     -1).reshape(shape)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     -1).reshape(shape)
    return rz @ ry @ rx


def random_angles(batch: int, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """``(batch, 3)`` angles uniform in ``[0, 2 pi)``."""
    return torch.rand((batch, 3), generator=generator,
                      device=device) * (2 * math.pi)


def jitter_points(pts: torch.Tensor, noise: torch.Tensor, sigma: float,
                  clip: float, is_2d: bool = False) -> torch.Tensor:
    """``pts`` plus ``sigma * noise`` clipped to ``[-clip, clip]``
    (``noise``: standard normal draws of ``pts``'s shape); no jitter on z
    for 2-D data."""
    noise = torch.clamp(sigma * noise, -clip, clip)
    if is_2d:
        noise = torch.cat([noise[..., :2], torch.zeros_like(noise[..., 2:])],
                          dim=-1)
    return pts + noise


def augment_batch(input_patches: torch.Tensor, label_patches: torch.Tensor,
                  jitter: bool = False, jitter_sigma: float = 0.005,
                  jitter_max: float = 0.01, is_2d: bool = False,
                  rotate: bool = True,
                  generator: Optional[torch.Generator] = None,
                  angles: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """input ``(B, K, 3)``, label ``(B, rK, 3)`` -> the augmented pair:
    jitter the input, normalize both by the label patch, rotate both.
    ``angles`` and ``noise`` are drawn from ``generator`` unless given."""
    if jitter:
        if noise is None:
            noise = torch.randn(input_patches.shape, generator=generator,
                                device=input_patches.device)
        input_patches = jitter_points(input_patches, noise, jitter_sigma,
                                      jitter_max, is_2d)
    label_patches, centroid, radius = normalize_point_batch_cl(label_patches)
    input_patches = (input_patches - centroid) / radius
    if rotate:
        if angles is None:
            angles = random_angles(input_patches.shape[0], generator,
                                   input_patches.device)
        rot = rotations(angles.to(input_patches.dtype))
        input_patches = input_patches @ rot
        label_patches = label_patches @ rot
    return input_patches, label_patches
