"""Tracing and throughput measurement (port of
``threepu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``) into a directory when it closes; it records the CPU,
  and the GPU where one is used.
- :func:`force_sync`: waits for the device work behind a tensor (a
  CUDA tensor's device is synchronized; a CPU tensor needs nothing).
- :class:`Stopwatch`: named stage timings, each ended by
  :func:`force_sync` on the stage's result.
- :class:`ThroughputMeter`: running upsampled points per second.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from threepu_torch.utils import logger


def trace_supported() -> bool:
    """Whether :func:`trace` records here: ``torch.profiler`` traces the
    CPU everywhere and a CUDA device through CUPTI, so always."""
    return True


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when
    ``cuda``, by default when a GPU is visible) and write
    ``<log_dir>/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities,
                 on_trace_ready=lambda prof: prof.export_chrome_trace(path)
                 ) as prof:
        yield prof
    logger.info(f"profiler trace written to {path}")


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def force_sync(x) -> None:
    """Wait until the device work behind the first tensor of ``x`` (a
    tensor, or a dict, list or tuple holding tensors) has finished."""
    leaf = _first_tensor(x)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class Stopwatch:
    """Named stage timings, each ending in :func:`force_sync` on the
    stage's result (``holder["result"]`` set inside the block, else the
    ``result`` argument)."""

    def __init__(self):
        self.stages: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        yield holder
        out = holder.get("result", result)
        if out is not None:
            force_sync(out)
        self.stages.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """The median seconds of each stage."""
        return {k: float(np.median(v)) for k, v in self.stages.items()}

    def report(self) -> str:
        return ", ".join(f"{k}={v * 1e3:.1f}ms"
                         for k, v in self.summary().items())


class ThroughputMeter:
    """Running upsampled points per second."""

    def __init__(self):
        self.points = 0
        self.seconds = 0.0

    def add(self, num_points: int, seconds: float) -> None:
        self.points += int(num_points)
        self.seconds += float(seconds)

    @property
    def points_per_sec(self) -> float:
        return self.points / self.seconds if self.seconds else 0.0
