"""The reference's call surface beside the batched pipeline (port of
``threepu/compat.py``): ``pc_prediction`` (``main.py:214-246``) and the
``get_stage_progress`` alias (``main.py:118-124``).  The reference's
``operations`` functions live in :mod:`threepu_torch.ops` under their own
names, NCHW conventions included.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from threepu_torch.data.curriculum import stage_progress as get_stage_progress  # noqa: F401
from threepu_torch.inference import cut_patches, plan_patches
from threepu_torch.ops.normalize import normalize_point_batch_cl


@torch.no_grad()
def pc_prediction(net, input_pc, ratio: int, num_point: int = 312,
                  patch_num_ratio: float = 3.0, chunk: int = 8
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The reference's patch prediction on the net's device: ``input_pc
    (1, 3, N)`` -> ``(inputs, outputs)``, one ``(1, 3, K)`` normalized
    input patch and one ``(1, 3, K * ratio)`` upsampled patch (in the
    shape's frame) per patch, computed by the batched cascade ``chunk``
    patches at a time."""
    dev = next(net.parameters()).device
    xyz = torch.as_tensor(input_pc, dtype=torch.float32).to(dev)
    shape_b = xyz.transpose(1, 2)[:1].contiguous()             # (1, N, 3)
    num_patches, _, _ = plan_patches(shape_b.shape[1], num_point,
                                     patch_num_ratio)
    norm, centroid, radius = normalize_point_batch_cl(
        cut_patches(shape_b, num_patches, num_point))
    up = torch.cat([net.upsample(norm[i:i + chunk], ratio)
                    for i in range(0, num_patches, chunk)]) * radius + centroid
    return ([p[None].transpose(1, 2) for p in norm],
            [u[None].transpose(1, 2) for u in up])
