"""Patch-parallel inference over a :class:`~threepu_torch.parallel.Mesh`
(port of ``threepu/parallel/inference.py``).

There is one pipeline: :func:`threepu_torch.inference.
upsample_point_cloud` takes a ``mesh``.  Every rank runs the seed FPS,
grouping and normalization (identical inputs, identical picks), the
``Net`` cascade over its own ``padded / size`` patches, one all-gather
of the denormalized patches, and the final re-stitch FPS over the whole
merge; every rank returns the whole output.  This module keeps the
convenience constructor.
"""

from __future__ import annotations

from typing import Optional

import torch

from threepu_torch.inference import upsample_point_cloud
from threepu_torch.parallel.mesh import Mesh


def make_sharded_upsampler(net, mesh: Mesh, ratio: int, num_point: int,
                           num_patches: Optional[int] = None,
                           num_out: Optional[int] = None,
                           chunk: Optional[int] = None,
                           axis_name: str = "data"):
    """An ``xyz (N, 3) -> (num_out, 3)`` upsampler with the patch axis
    split over ``mesh``; ``net`` holds the weights and lies on
    ``mesh.device``.

    ``num_patches`` overrides the reference's patch count
    ``int(N / num_point * patch_num_ratio)`` by solving for the
    ``patch_num_ratio`` that gives it; ``num_out`` defaults to ``N *
    ratio``.  Padding patches beyond the true count are masked out of the
    final FPS by the shared pipeline.
    """
    if axis_name != mesh.axis_name:
        raise ValueError(f"make_sharded_upsampler: axis {axis_name!r}, but "
                         f"the mesh's is {mesh.axis_name!r}")

    def upsample(xyz) -> torch.Tensor:
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=mesh.device)
        n = xyz.shape[0]
        ratio_kw = {}
        if num_patches is not None:
            # plan_patches floors N / num_point * ratio; the epsilon makes
            # the requested count exact after the floor
            ratio_kw["patch_num_ratio"] = num_patches * num_point / n + 1e-9
        return upsample_point_cloud(
            net, xyz, ratio, num_point,
            num_out if num_out is not None else n * ratio, chunk=chunk,
            mesh=mesh, **ratio_kw)

    return upsample
