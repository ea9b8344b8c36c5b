"""Training data (port of :mod:`threepu.data`): the HDF5 / ``.npz``
reader, the device-resident dataset and its reference-layout wrapper,
batches issued ahead, patch sampling, augmentation and the curriculum."""

from threepu_torch.data.augment import (augment_batch, jitter_points,
                                        random_angles, rotations)
from threepu_torch.data.curriculum import (CurriculumState, curriculum_state,
                                           stage_progress)
from threepu_torch.data.h5_dataset import (DeviceDataset, H5Dataset,
                                           load_h5_data)
from threepu_torch.data.prefetch import Prefetcher, step_generator
from threepu_torch.data.sampler import sample_batch

__all__ = ["CurriculumState", "DeviceDataset", "H5Dataset", "Prefetcher",
           "augment_batch", "curriculum_state", "jitter_points",
           "load_h5_data", "random_angles", "rotations", "sample_batch",
           "stage_progress", "step_generator"]
