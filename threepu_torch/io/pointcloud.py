"""Point-cloud files in and out (own copy of ``threepu/io/pointcloud.py``):
``.ply`` through :mod:`threepu_torch.io.ply`, any other extension as
whitespace-separated text (``.xyz``), parsed by the native library's
:func:`~threepu_torch.native.parse_xyz` where it builds and the file is
plain rows of numbers, else by ``np.loadtxt``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from threepu_torch import native
from threepu_torch.io.ply import read_ply, resize_count, save_ply


def _load_text(filename: str) -> np.ndarray:
    if native.available():
        try:
            return native.parse_xyz(filename)
        except ValueError:        # comments or ragged rows: np.loadtxt's
            pass
    return np.loadtxt(filename).astype(np.float32)


def load(filename: str, count: Optional[int] = None) -> np.ndarray:
    """The points of ``filename`` as float32 ``(N, C)`` (``(N, 3)`` for a
    ``.ply``), padded with random repeats or downsampled to ``count``
    rows when given (draws from numpy's global generator)."""
    if filename.endswith(".ply"):
        return read_ply(filename, count)[:, :3].astype(np.float32)
    points = _load_text(filename)
    if points.ndim == 1:
        points = points[None, :]
    return points if count is None else resize_count(points, count)


def save(points: np.ndarray, filename: str, **kwargs) -> None:
    """``.ply`` through :func:`save_ply` (``kwargs``: colours, normals),
    anything else as text."""
    if filename.endswith(".ply"):
        save_ply(points, filename, **kwargs)
    else:
        np.savetxt(filename, points)
