"""Batches issued ahead of the train step (port of
``threepu/data/prefetch.py``).

On the GPU sampling is asynchronous device work: keeping ``depth``
batches issued means the sampling kernels are queued before the train
step that consumes them, with no worker processes and no host copies.
Every random draw of step ``s`` comes from :func:`step_generator` ``(seed,
s)``, a CPU generator that depends on the step alone, so a resumed run
draws from ``start_step`` on exactly what an unbroken run draws.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, Tuple

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``(seed, step)`` alone."""
    state = np.random.SeedSequence([seed % (1 << 64), step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class Prefetcher:
    """Keeps ``depth`` batches issued ahead; yields ``(batch, ratio,
    step)``.

    ``sample_fn(step, ratio, generator)`` returns the batch (device
    tensors, e.g. :meth:`threepu_torch.data.DeviceDataset.sample`), drawing
    from ``generator`` (:func:`step_generator`); ``ratio_fn(step)``
    chooses the curriculum ratio of each batch on the host.
    """

    def __init__(self, sample_fn: Callable, ratio_fn: Callable[[int], int],
                 seed: int, depth: int = 2, start_step: int = 0):
        self.sample_fn = sample_fn
        self.ratio_fn = ratio_fn
        self.depth = depth
        self.seed = seed
        self._step = start_step
        self._queue: deque = deque()

    def _issue(self) -> None:
        ratio = int(self.ratio_fn(self._step))
        batch = self.sample_fn(self._step, ratio,
                               step_generator(self.seed, self._step))
        self._queue.append((batch, ratio, self._step))
        self._step += 1

    def __iter__(self) -> Iterator[Tuple[tuple, int, int]]:
        return self

    def __next__(self):
        while len(self._queue) < self.depth:
            self._issue()
        return self._queue.popleft()
