"""Host-side (numpy) point-cloud helpers (port of the parts of
``threepu/utils/pc_utils.py`` that inference uses)."""

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
