"""Patch-parallel training and inference over ``torch.distributed``
(port of :mod:`threepu.parallel`).

The scaling axis is the patch axis: a train batch is 16 patches, a
shape's inference batch its patches.  One process runs a device; a
:class:`Mesh` is its rank of the default process group (``nccl`` on the
card, ``gloo`` on the CPU), made by :func:`make_mesh` from the
environment ``torchrun`` sets, or by :func:`launch.spawn`:

- :func:`make_sharded_train_step`: data-parallel training, parameters
  replicated, the batch's rows split over the ranks, one all-reduce of
  a flat gradient buffer a step;
- :func:`make_sharded_upsampler`: the patches of one shape split over
  the ranks, one all-gather of the upsampled patches, the re-stitch FPS
  on every rank.

NCCL takes one rank a card, so one card runs world size 1.
"""

from threepu_torch.parallel.mesh import (Mesh, batch_sharded, make_mesh,
                                         replicated)
from threepu_torch.parallel.train import make_sharded_train_step
from threepu_torch.parallel.inference import make_sharded_upsampler

__all__ = ["make_mesh", "replicated", "batch_sharded",
           "make_sharded_train_step", "make_sharded_upsampler"]
