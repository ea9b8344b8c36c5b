"""Training data on the device (port of :mod:`threepu.data`, without the
HDF5 reader): patch sampling, augmentation and the curriculum."""

from threepu_torch.data.augment import (augment_batch, jitter_points,
                                        random_angles, rotations)
from threepu_torch.data.curriculum import (CurriculumState, curriculum_state,
                                           stage_progress)
from threepu_torch.data.sampler import sample_batch

__all__ = ["CurriculumState", "augment_batch", "curriculum_state",
           "jitter_points", "random_angles", "rotations", "sample_batch",
           "stage_progress"]
