"""Host-side (numpy) point-cloud helpers (port of the parts of
``threepu/utils/pc_utils.py`` that inference and file loading use)."""

from __future__ import annotations

import numpy as np


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
    """``k`` rows of ``pts``: by FPS when the cloud holds at least ``2k``
    points, by random choice otherwise (with repeats when ``k`` is below
    the cloud's size, as the JAX package and the reference draw it)."""
    if pts.shape[0] >= 2 * k:
        return FarthestSampler()(pts, k)
    return pts[np.random.choice(pts.shape[0], k, replace=(k < pts.shape[0]))]
