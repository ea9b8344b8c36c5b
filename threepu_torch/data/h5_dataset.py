"""Multi-resolution training data on the device (port of
``threepu/data/h5_dataset.py``).

- :func:`load_h5_data`: the host-side load and normalization of the JAX
  package: resolutions parsed from the file name, the input resolution
  by ``searchsorted``, every resolution normalized by the input
  resolution's centroid and radius, 2-D detection.  It reads an HDF5
  file (``h5py``, imported only then) or a numpy archive (``.npz``) with
  the same ``<tag>_<n>`` datasets.
- :class:`DeviceDataset`: the whole dataset on the device; one
  :meth:`~DeviceDataset.sample` call cuts a training batch around random
  seed points of one shape with :func:`threepu_torch.data.sample_batch`.
  Its random draws come from a ``torch.Generator`` on the CPU and reach
  the device through pinned memory without a host sync, so the card and
  the CPU cut the same batch from the same generator.
- :class:`H5Dataset`: the reference's class API: curriculum mutators,
  300 batches per epoch, batches in the ``(B, 3, N)`` layout.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from threepu_torch.data.augment import random_angles
from threepu_torch.data.sampler import sample_batch
from threepu_torch.device import resolve_device
from threepu_torch.utils import logger

Device = Optional[Union[str, torch.device]]


def import_h5py(path: str):
    """``h5py``, or an ``ImportError`` that names the ``.npz`` route for
    ``path``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path}: reading or writing an HDF5 file needs h5py, which is "
            "not installed; convert the file to a numpy archive with the "
            "same '<tag>_<n>' datasets and a name ending in .npz (np.savez) "
            "on a machine that has h5py, or write synthetic data with "
            "python -m threepu_torch.data.synthetic --filename <name>.npz"
        ) from e
    return h5py


def _open(path: str):
    """The datasets of ``path``: an ``np.load`` archive for ``.npz``, an
    ``h5py.File`` otherwise."""
    if path.endswith(".npz"):
        return np.load(path)
    return import_h5py(path).File(path, "r")


def load_h5_data(h5_path: str, num_shape_point: int, up_ratio: int = 16,
                 step_ratio: int = 2
                 ) -> Tuple[np.ndarray, Dict[int, np.ndarray], bool]:
    """Returns (input (S, N, 3) normalized, {ratio: (S, rN, 3)}, is_2D)."""
    basename = os.path.basename(h5_path)
    stem = os.path.splitext(basename)[0]
    resolutions = np.asarray(sorted(int(x) for x in re.findall(r"\d+", stem)))
    tags = re.findall(r"_([A-Za-z]+)_", basename)
    if not tags or resolutions.size == 0:
        raise ValueError(
            f"{basename!r} does not follow the training-data filename "
            "convention '<prefix>_<tag>_<n1>_<tag>_<n2>_....hdf5' "
            "(e.g. 'train_poisson_310_poisson_625_..._poisson_80000"
            ".hdf5'); the dataset keys '<tag>_<n>' are derived from it")
    tag = tags[-1]
    num_in = int(resolutions[np.searchsorted(resolutions, num_shape_point)])

    with _open(h5_path) as f:
        data = f[f"{tag}_{num_in}"][:, :, 0:3].astype(np.float32)
        logger.info(f"input point_num {data.shape[1]}")
        centroid = np.mean(data, axis=1, keepdims=True)
        data = data - centroid
        furthest = np.amax(np.sqrt(np.sum(data ** 2, axis=-1)),
                           axis=1, keepdims=True)[..., None]
        data = data / furthest

        labels: Dict[int, np.ndarray] = {}
        num_levels = int(math.log(up_ratio, step_ratio))
        for x in range(1, num_levels + 1):
            r = step_ratio ** x
            res = int(resolutions[np.searchsorted(resolutions, num_in * r)])
            arr = f[f"{tag}_{res}"][:, :, 0:3].astype(np.float32)
            labels[r] = (arr - centroid) / furthest
            logger.info(f"gt (ratio {r}), point_num {arr.shape[1]}")

    is_2d = bool(np.all(data[:, :, 2] == 0))
    if is_2d:
        logger.info("2D dataset")
    logger.info(f"total {data.shape[0]} samples")
    return data, labels, is_2d


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A CPU tensor on ``device``; to a CUDA device through pinned memory
    and an asynchronous copy, since a copy from pageable memory holds the
    host until the device has run everything queued before it."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DeviceDataset:
    """The dataset in device memory; :meth:`sample` cuts one training
    batch: ``batch_size`` random seed points of one shape, the kNN patches
    of the input and of the ratio's label resolution around them, then
    augmentation (train phase) or normalization by the label patch.

    The dataset lives on ``device``: the card unless another device
    (``"cpu"``) is named.
    """

    def __init__(self, h5_path: str, num_shape_point: int,
                 num_patch_point: int, batch_size: int = 16,
                 up_ratio: int = 16, step_ratio: int = 2,
                 jitter: bool = False, jitter_sigma: float = 0.005,
                 jitter_max: float = 0.01, drop_out: float = 1.0,
                 phase: str = "train", device: Device = None):
        self.device = resolve_device(device)
        data, labels, is_2d = load_h5_data(h5_path, num_shape_point,
                                           up_ratio, step_ratio)
        self.input_array = torch.from_numpy(data).to(self.device)
        self.label_arrays = {r: torch.from_numpy(v).to(self.device)
                             for r, v in labels.items()}
        self.is_2d = is_2d
        self.num_shapes = data.shape[0]
        self.batch_size = batch_size
        self.num_patch_point = num_patch_point
        self.jitter = jitter
        self.jitter_sigma = jitter_sigma
        self.jitter_max = jitter_max
        self.drop_out = drop_out
        self.phase = phase
        self.step_ratio = step_ratio
        self.up_ratio = up_ratio

    def draws(self, generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """One batch's random draws on the CPU, in the order
        :func:`sample_batch` would draw them from ``generator``: seed
        points, then (train phase) jitter noise and rotation angles, then
        the drop-out order."""
        b, k = self.batch_size, self.num_patch_point
        out = {"seed_idx": torch.randint(0, self.input_array.shape[1], (b,),
                                         generator=generator)}
        if self.phase == "train":
            if self.jitter:
                out["noise"] = torch.randn((b, k, 3), generator=generator)
            out["angles"] = random_angles(b, generator)
        if self.drop_out < 1.0:
            out["perm"] = torch.randperm(k, generator=generator)
        return out

    def sample(self, step: int, ratio: int,
               generator: Optional[torch.Generator] = None,
               **draws: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(input (B, K', 3), label (B, rK, 3)) for the shape at ``step %
        num_shapes``.  The draws (:meth:`draws` names them) come from
        ``generator`` unless given."""
        if not draws:
            draws = self.draws(generator)
        draws = {k: to_device(v, self.device) for k, v in draws.items()}
        i = step % self.num_shapes
        return sample_batch(
            self.input_array[i], self.label_arrays[ratio][i], ratio,
            self.batch_size, self.num_patch_point, phase=self.phase,
            jitter=self.jitter, jitter_sigma=self.jitter_sigma,
            jitter_max=self.jitter_max, drop_out=self.drop_out,
            is_2d=self.is_2d, **draws)


class H5Dataset:
    """The reference's dataset class: stateful curriculum mutators, 300
    batches per epoch, batches in the ``(B, 3, N)`` layout.  The ratio of
    each combined batch comes from ``np.random.default_rng(seed)`` as in
    the JAX package, the batch's draws from a CPU generator seeded with
    ``seed``."""

    def __init__(self, h5_path: str, num_shape_point: int,
                 num_patch_point: int, phase: str = "train",
                 up_ratio: int = 16, step_ratio: int = 2,
                 jitter: bool = False, jitter_max: float = 0.01,
                 jitter_sigma: float = 0.005, batch_size: int = 16,
                 drop_out: float = 1.0, seed: int = 0, device: Device = None):
        self.device = DeviceDataset(
            h5_path, num_shape_point, num_patch_point,
            batch_size=batch_size, up_ratio=up_ratio,
            step_ratio=step_ratio, jitter=jitter,
            jitter_sigma=jitter_sigma, jitter_max=jitter_max,
            drop_out=drop_out, phase=phase, device=device)
        self.batch_size = batch_size
        self.step_ratio = step_ratio
        num_levels = int(math.log(up_ratio, step_ratio))
        self.all_scales = [step_ratio ** r for r in range(1, num_levels + 1)]
        self.curr_scales = list(self.all_scales)
        self._combined = True
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator().manual_seed(seed)

    def add_next_ratio(self):
        self.curr_scales = self.all_scales[
            :min(len(self.curr_scales) + 1, len(self.all_scales))]

    def set_combined(self):
        self._combined = True

    def unset_combined(self):
        self._combined = False

    def set_max_ratio(self, ratio: int):
        n = int(math.log(ratio, self.step_ratio))
        self.curr_scales = [self.step_ratio ** r for r in range(1, n + 1)]

    def sync_to_step(self, step: int, stage_steps: int = 15000,
                     up_ratio: Optional[int] = None):
        """Set the curriculum for global step ``step`` as the reference's
        ``train()`` restores it: the scales up to the stage's ratio (at
        most ``up_ratio``), combined past half the stage.  Returns
        ``(stage, progress)`` (the Chamfer threshold turns on past
        0.6)."""
        from threepu_torch.data.curriculum import stage_progress

        stage, progress = stage_progress(step, stage_steps)
        max_ratio = self.step_ratio ** (stage + 1)
        if up_ratio is not None:
            max_ratio = min(max_ratio, up_ratio)
        self.set_max_ratio(max_ratio)
        if progress > 0.5:
            self.set_combined()
        else:
            self.unset_combined()
        return stage, progress

    def __len__(self):
        return 300 * self.batch_size

    def __getitem__(self, index: int):
        if self._combined:
            ratio = int(self.curr_scales[
                self._rng.integers(len(self.curr_scales))])
        else:
            ratio = int(self.curr_scales[-1])
        inp, lab = self.device.sample(index, ratio, self._generator)
        return (inp.transpose(1, 2).contiguous(),
                lab.transpose(1, 2).contiguous(), ratio)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
