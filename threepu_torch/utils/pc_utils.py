"""Host-side (numpy) point-cloud helpers (port of
``threepu/utils/pc_utils.py``).  Random draws come from numpy's global
generator, in the JAX package's order, unless a function takes ``rng``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from threepu_torch import native


def normalize_point_cloud(pc: np.ndarray):
    """``pc (N, 3)`` or ``(B, N, 3)`` -> ``(normalized, centroid,
    furthest_distance)``."""
    axis = 0 if pc.ndim == 2 else 1
    centroid = np.mean(pc, axis=axis, keepdims=True)
    pc = pc - centroid
    furthest = np.amax(np.sqrt(np.sum(pc ** 2, axis=-1, keepdims=True)),
                       axis=axis, keepdims=True)
    return pc / furthest, centroid, furthest


def jitter_perturbation_point_cloud(batch_data: np.ndarray,
                                    rng: np.random.Generator,
                                    sigma: float = 0.005, clip: float = 0.02,
                                    is_2D: bool = False) -> np.ndarray:
    """Per-point gaussian jitter from ``rng``, clipped to ``+-clip``; z is
    left alone for 2-D data."""
    if clip <= 0:
        raise ValueError(f"clip must be positive, got {clip}")
    b, n, c = batch_data.shape
    chn = 2 if is_2D else 3
    jitter = np.clip(sigma * rng.standard_normal((b, n, c)), -clip, clip)
    jitter = jitter.astype(batch_data.dtype)
    jitter[:, :, chn:] = 0
    return batch_data + jitter


def random_rotation_matrix(dtype=np.float32,
                           rng: Optional[np.random.Generator] = None
                           ) -> np.ndarray:
    """``Rz @ Ry @ Rx`` of three angles uniform in [0, 2 pi), drawn from
    ``rng`` or numpy's global generator."""
    rand = rng.uniform(size=3) if rng is not None else np.random.uniform(
        size=3)
    angles = rand * 2 * np.pi
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], dtype)
    return np.dot(rz, np.dot(ry, rx))


def rotate_point_cloud_and_gt(batch_data: np.ndarray,
                              batch_gt: Optional[np.ndarray] = None):
    """One random rotation per shape (:func:`random_rotation_matrix`),
    applied to the input and its gt alike, and to normals (channels 3-5)
    where present.  Returns rotated copies ``(data, gt)``."""
    batch_data = batch_data.copy()
    batch_gt = batch_gt.copy() if batch_gt is not None else None
    for k in range(batch_data.shape[0]):
        rot = random_rotation_matrix(batch_data.dtype)
        batch_data[k, ..., 0:3] = batch_data[k, ..., 0:3] @ rot
        if batch_data.shape[-1] > 3:
            batch_data[k, ..., 3:6] = batch_data[k, ..., 3:6] @ rot
        if batch_gt is not None:
            batch_gt[k, ..., 0:3] = batch_gt[k, ..., 0:3] @ rot
            if batch_gt.shape[-1] > 3:
                batch_gt[k, ..., 3:6] = batch_gt[k, ..., 3:6] @ rot
    return batch_data, batch_gt


def random_scale_point_cloud_and_gt(batch_data: np.ndarray,
                                    batch_gt: Optional[np.ndarray] = None,
                                    scale_low: float = 0.5,
                                    scale_high: float = 2.0):
    """One random scale per cloud, uniform in ``[scale_low,
    scale_high)``, on the xyz channels of the input and its gt.  Returns
    ``(data, gt, scales (B,))``."""
    b = batch_data.shape[0]
    scales = np.random.uniform(scale_low, scale_high,
                               (b, 1, 1)).astype(batch_data.dtype)
    batch_data = np.concatenate(
        [batch_data[:, :, :3] * scales, batch_data[:, :, 3:]], axis=-1)
    if batch_gt is not None:
        batch_gt = np.concatenate(
            [batch_gt[:, :, :3] * scales, batch_gt[:, :, 3:]], axis=-1)
    return batch_data, batch_gt, np.squeeze(scales)


class FarthestSampler:
    """Furthest point sampling in numpy from a random first point (drawn
    from numpy's global generator); downsamples a cloud on the host."""

    @staticmethod
    def _calc_distances(p0: np.ndarray, points: np.ndarray) -> np.ndarray:
        return ((p0 - points[:, :3]) ** 2).sum(axis=1)

    def __call__(self, pts: np.ndarray, k: int) -> np.ndarray:
        """``pts (N, C)`` -> the ``k`` sampled rows, float32 ``(k, C)``."""
        farthest = np.zeros((k, pts.shape[1]), dtype=np.float32)
        farthest[0] = pts[np.random.randint(len(pts))]
        distances = self._calc_distances(farthest[0, :3], pts)
        for i in range(1, k):
            farthest[i] = pts[np.argmax(distances)]
            distances = np.minimum(
                distances, self._calc_distances(farthest[i, :3], pts))
        return farthest


def downsample_points(pts: np.ndarray, k: int) -> np.ndarray:
    """``k`` rows of ``pts``: by FPS from a random first point when the
    cloud holds at least ``2k`` points (the native library's
    :func:`~threepu_torch.native.fps_cpu`, else :class:`FarthestSampler`:
    the same picks), by random choice otherwise (with repeats when ``k``
    is below the cloud's size, as the JAX package and the reference draw
    it)."""
    if pts.shape[0] >= 2 * k:
        if not native.available():
            return FarthestSampler()(pts, k)
        seed = np.random.randint(pts.shape[0])
        return pts[native.fps_cpu(pts, k, seed)]
    return pts[np.random.choice(pts.shape[0], k, replace=(k < pts.shape[0]))]
