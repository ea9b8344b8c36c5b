"""Synthetic surfaces made from a seed (the generator of the program's
``data/synthetic.py``, copied so that the benchmark's inputs cannot move
with the program).

A shape is a unit sphere modulated by a low-frequency radial field of
its own: ``r(x, y) = 1 + sum_ij c_ij sin(3.1 i x) cos(3.1 j y)`` over
unit-sphere directions, ``c`` a ``(4, 4)`` field of N(0, 0.12^2)
coefficients.  Every resolution of a shape samples the same surface.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator keyed by the run's seed (any size) and a stream."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


class Reservoir:
    """``k`` items of a stream of unknown length, each item equally likely
    to be among them, drawn from the seed (Algorithm R): :meth:`offer`
    is asked before each item and returns the slot that the item takes
    (its record replaces the slot's), or ``None``."""

    def __init__(self, seed: int, stream: int, k: int):
        self.rng = rng_for(seed, stream)
        self.k, self.seen = k, 0

    def offer(self) -> Optional[int]:
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self.rng.integers(i + 1))
        return j if j < self.k else None


def surface(n: int, coef: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """``n`` points ``(n, 3)`` float32 of the surface of ``coef``."""
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    i = np.arange(4, dtype=np.float32)
    s = np.sin(pts[:, :1] * (3.1 * i))                    # (n, 4)
    c = np.cos(pts[:, 1:2] * (3.1 * i))                   # (n, 4)
    mod = 1.0 + np.einsum("ni,ij,nj->n", s, coef.astype(np.float32), c)
    return (pts * mod[:, None]).astype(np.float32)


def pool(seed: int, shapes: int, points: int) -> list:
    """``shapes`` distinct surfaces of ``points`` points each."""
    rng = rng_for(seed, 0)
    coef = rng.standard_normal((shapes, 4, 4)) * 0.12
    return [surface(points, coef[s], rng) for s in range(shapes)]


def training_file(seed: int, shapes: int,
                  resolutions: Sequence[int]) -> Dict[str, np.ndarray]:
    """The datasets of a training file, ``poisson_<n>: (shapes, n, 3)``:
    every resolution samples each shape's one surface."""
    rng = rng_for(seed, 1)
    coef = rng.standard_normal((shapes, 4, 4)) * 0.12
    return {f"poisson_{res}": np.stack([surface(res, coef[s], rng)
                                        for s in range(shapes)])
            for res in sorted(resolutions)}
