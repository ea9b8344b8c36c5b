"""Geometric ops (port of :mod:`threepu.ops`), under the JAX package's
names and the reference's NCHW conventions where it keeps them.

Five modules hold a CUDA kernel beside its plain PyTorch version:
:mod:`~threepu_torch.ops.select`, :mod:`~threepu_torch.ops.fps`,
:mod:`~threepu_torch.ops.interlevel`, :mod:`~threepu_torch.ops.chamfer`
and :mod:`~threepu_torch.ops.edgeconv`; each keeps its kernel's launch
count on its ``KERNEL`` object (the wrappers ``select``, ``fps`` and
``interlevel`` share their modules' names, so they are not re-exported
here: the package attribute stays the module).  :func:`ball_query` is
plain PyTorch, as the JAX package computes it with XLA, and so are
PU-Net's :func:`three_nn` and :func:`three_interpolate`.
"""

from threepu_torch.ops.ball_query import ball_query
from threepu_torch.ops.chamfer import (nn_both_ways, nn_distance, nn_one_way,
                                       nndistance, self_nn_dist2)
from threepu_torch.ops.distances import (direct_dist2, duplicate_mask,
                                         pairwise_dist2)
from threepu_torch.ops.edgeconv import edge_conv_chain
from threepu_torch.ops.fps import fps_indices, furthest_point_sample
from threepu_torch.ops.gather import batched_gather, gather_nd, gather_points
from threepu_torch.ops.knn import KnnResult, group_knn, knn_group
from threepu_torch.ops.normalize import (normalize_point_batch,
                                         normalize_point_batch_cl)
from threepu_torch.ops.three_nn import three_interpolate, three_nn

__all__ = [
    "pairwise_dist2", "direct_dist2", "duplicate_mask",
    "knn_group", "group_knn", "KnnResult",
    "fps_indices", "furthest_point_sample",
    "gather_points", "gather_nd", "batched_gather",
    "ball_query", "three_nn", "three_interpolate",
    "normalize_point_batch", "normalize_point_batch_cl",
    "nn_distance", "nndistance", "self_nn_dist2",
    # the port's own: kernel wrappers
    "nn_both_ways", "nn_one_way", "edge_conv_chain",
]
