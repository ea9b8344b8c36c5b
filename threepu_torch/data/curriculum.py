"""Progressive-training curriculum as a pure function of the step (a copy
of ``threepu/data/curriculum.py``, which the port cannot import).

With S = ``stage_steps``: ``stage = (step + S) // (2S)`` and ``progress``
its fractional remainder; each stage unlocks the next ``step_ratio``-fold
ratio, ``progress > 0.5`` samples the ratio at random from the active
scales, and ``progress > 0.6`` turns on the Chamfer outlier threshold.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple


def stage_progress(step: int, stage_steps: int) -> Tuple[int, float]:
    """``(stage, progress in [0, 1))`` at ``step``."""
    stage = (step + stage_steps) // (2 * stage_steps)
    progress = (step + stage_steps) / (2 * stage_steps) - stage
    return int(stage), float(progress)


class CurriculumState(NamedTuple):
    stage: int
    progress: float
    scales: Tuple[int, ...]     # active ratios, e.g. (2, 4)
    combined: bool              # sample the ratio uniformly from scales
    threshold: Optional[float]  # Chamfer outlier threshold or None

    @property
    def max_ratio(self) -> int:
        return self.scales[-1]

    def choose_ratio(self, rng) -> int:
        """Ratio of the next batch: drawn from the active scales with the
        numpy generator ``rng`` when combined, else the newest scale."""
        if self.combined:
            return int(self.scales[int(rng.integers(len(self.scales)))])
        return int(self.scales[-1])


def curriculum_state(step: int, stage_steps: int, up_ratio: int,
                     step_ratio: int = 2,
                     cd_threshold: Optional[float] = 2.0
                     ) -> CurriculumState:
    """The full curriculum state at ``step``."""
    num_levels = int(math.log(up_ratio, step_ratio))
    stage, progress = stage_progress(step, stage_steps)
    n_active = min(stage + 1, num_levels)
    scales = tuple(step_ratio ** r for r in range(1, n_active + 1))
    combined = progress > 0.5
    threshold = cd_threshold if progress > 0.6 else None
    return CurriculumState(stage=stage, progress=progress, scales=scales,
                           combined=combined, threshold=threshold)
