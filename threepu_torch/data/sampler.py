"""Training batches from one in-memory shape (port of ``_sample_impl`` of
``threepu/data/h5_dataset.py``, without the HDF5 reader).

``batch_size`` seed points of the input shape; around each, the
``num_patch_point`` nearest input points and the ``num_patch_point *
ratio`` nearest label points; then :func:`augment_batch` (train phase)
or normalization by the label patch (other phases), and an optional
drop-out of input points.  Every random draw is passed in or comes from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from threepu_torch.data.augment import augment_batch
from threepu_torch.ops.knn import knn_group
from threepu_torch.ops.normalize import normalize_point_batch_cl


def sample_batch(input_pc: torch.Tensor, label_pc: torch.Tensor, ratio: int,
                 batch_size: int, num_patch_point: int,
                 generator: Optional[torch.Generator] = None, *,
                 phase: str = "train", jitter: bool = False,
                 jitter_sigma: float = 0.005, jitter_max: float = 0.01,
                 drop_out: float = 1.0, is_2d: bool = False,
                 seed_idx: Optional[torch.Tensor] = None,
                 angles: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 perm: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``input_pc (N, 3)`` and its ``ratio``-times denser ``label_pc
    (M, 3)`` -> ``(input (B, K', 3), label (B, ratio*K, 3))`` with
    ``K = num_patch_point`` and ``K' = int(K * drop_out)``.

    ``seed_idx (B,)``, ``angles (B, 3)``, ``noise (B, K, 3)`` and ``perm
    (K,)`` replace the draws from ``generator`` when given.
    """
    dev = input_pc.device
    if seed_idx is None:
        seed_idx = torch.randint(0, input_pc.shape[0], (batch_size,),
                                 generator=generator, device=dev)
    seeds = input_pc[seed_idx.to(dev).long()][None]             # (1, B, 3)
    input_patches = knn_group(seeds, input_pc[None],
                              num_patch_point).neighbors[0]
    label_patches = knn_group(seeds, label_pc[None],
                              num_patch_point * ratio).neighbors[0]
    if phase == "train":
        input_patches, label_patches = augment_batch(
            input_patches, label_patches, jitter=jitter,
            jitter_sigma=jitter_sigma, jitter_max=jitter_max, is_2d=is_2d,
            generator=generator, angles=angles, noise=noise)
    else:
        label_patches, centroid, radius = normalize_point_batch_cl(
            label_patches)
        input_patches = (input_patches - centroid) / radius
    if drop_out < 1.0:
        keep = int(num_patch_point * drop_out)
        if perm is None:
            perm = torch.randperm(num_patch_point, generator=generator,
                                  device=dev)
        input_patches = input_patches[:, perm[:keep].to(dev).long()]
    return input_patches, label_patches
