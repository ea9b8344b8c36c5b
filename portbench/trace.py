"""Reading the device's work from ``torch.profiler`` and CUDA events.

:func:`profiled` runs a callable under the profiler and returns what the
per-layer readers take: the device operations' count and time by name,
the union of their intervals (the device's busy time), the wall time of
the window and, in a window that also records the host, the idle gaps
named by what the host was doing meanwhile.
``union_us`` and the interval reader are the ones ``chip_smoke.py``
uses, copied here.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Profile(dict):
    """``busy_s`` (the union of the device operations' intervals),
    ``window_s`` (host clock), ``n_ops``, ``by_name``: ``{operation:
    device seconds}``, ``gaps``: ``{host activity: idle seconds}``."""


def start_profile(host: bool = False):
    """A running ``torch.profiler`` and its start on the host clock,
    after a device sync.  Device activity only unless ``host``: recording
    every host operation stretches the host's time (a shape by 17-36%, a
    training step by 2x), and the busy share is read without it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof, time.perf_counter()


def finish_profile(prof, t0: float) -> Profile:
    """Ends ``prof`` after a device sync and reads it (``gaps`` is empty
    without host activity); raises where the device recorded nothing."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    ops, host = [], []
    for ev in prof.events():
        if ev.is_user_annotation and ev.device_type == DeviceType.CUDA:
            continue           # an annotation spans the kernels it holds
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in ops:
        by_name[name] += (e - s) / 1e6
    busy = merged([(s, e) for _, s, e in ops])
    gaps: Dict[str, float] = defaultdict(float)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gaps[host_at((e0 + s1) / 2, host, starts)] += (s1 - e0) / 1e6
    return Profile(busy_s=union_us([(s, e) for _, s, e in ops]) / 1e6,
                   window_s=window_s, by_name=dict(by_name), gaps=dict(gaps),
                   n_ops=len(ops))


def warm_profiler(device) -> None:
    """One profiled device operation, so that the profiler's own start-up
    (CUPTI's, some tens of ms) falls outside a measured sub-window."""
    profiled(lambda: torch.ones(1, device=device).add_(1))


def profiled(fn: Callable[[], None], host: bool = False) -> Profile:
    """``fn()`` under the profiler (:func:`start_profile`)."""
    prof, t0 = start_profile(host)
    fn()
    return finish_profile(prof, t0)


def host_at(t: float, host, starts=None, reach: int = 512) -> str:
    """The innermost host event that holds the time ``t`` (of those
    among the ``reach`` latest to start before it, the one that started
    last), or ``"host (no op)"``; ``host`` is sorted by start."""
    import bisect
    if starts is None:
        starts = [h[1] for h in host]
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "host (no op)"


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Spans:
    """CUDA-event spans by name: ``open(name)`` / ``close(name)`` around
    a call into the program; :meth:`ms` reads them once the device is
    synchronized."""

    def __init__(self):
        self.events: Dict[str, list] = defaultdict(list)
        self._open: Dict[str, torch.cuda.Event] = {}

    def open(self, name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self._open[name] = e

    def is_open(self, name: str) -> bool:
        return name in self._open

    def close(self, name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[name].append((self._open.pop(name), e))

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.events.items()}
