"""The port's tracing: the command line's Chrome trace and the spans the
eval path records while a profiler records.

- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``) into a directory when it closes; it records the CPU,
  and the GPU where one is used.
- :func:`span`: a named stretch of the program.  While a profiler
  records (:func:`trace`, or any ``torch.profiler``), a span keeps its
  host and device times and its place in the tree of spans, and shows
  on the profiler's timeline as ``threepu.<name>``; otherwise it does
  nothing.
- :func:`finished_spans`, :func:`clear_spans`: the spans kept so far.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from threepu_torch.utils import logger

#: finished spans kept at most; the oldest go first
MAX_SPANS = 16384

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class _Off:
    """The span of a process where no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_INHERIT = -1          # device of a span given none: its parent's
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _cuda_index(on) -> Optional[int]:
    """The CUDA device index of a tensor or device, else ``None``."""
    dev = on.device if torch.is_tensor(on) else torch.device(on)
    if dev.type != "cuda":
        return None
    return torch.cuda.current_device() if dev.index is None else dev.index


class _Span:
    """A span being recorded; once closed, the record :class:`SpanLog`
    keeps."""

    __slots__ = ("name", "id", "parent", "shape", "dev", "t0", "t1",
                 "ev0", "ev1", "_rf")

    def __init__(self, name: str, on):
        self.name = name
        self.dev = _INHERIT if on is None else _cuda_index(on)
        self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.shape = self.id if parent is None else parent.shape
        if self.dev == _INHERIT:
            self.dev = None if parent is None else parent.dev
        # record_function's C++ twin: the same annotation on the
        # profiler's timeline at a few µs less a span
        self._rf = torch._C._profiler._RecordFunctionFast(
            "threepu." + self.name)
        self._rf.__enter__()
        if self.dev is not None:
            self.ev0 = LOG.event(self.dev)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        if self.dev is not None:
            self.ev1 = LOG.event(self.dev)
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        LOG.keep(self)
        return False


def span(name: str, on=None):
    """A context manager around one stretch of the program.

    Where no profiler records (``torch.profiler`` is off) it is one
    shared object that does nothing.  While one records, the span shows
    on the profiler's timeline as ``threepu.<name>`` (a user annotation,
    as ``torch.profiler.record_function`` makes) and keeps a
    record (:func:`finished_spans`): its name, id, parent span and shape
    (the id of the outermost span around it), the host clock at start
    and end, and, on a CUDA device, a pair of timing events on that
    device's current stream.  ``on`` (a tensor or a device) names the
    device; by default a span takes its parent's.  An exception inside
    the span closes it and goes on.  Inside a CUDA graph's capture it
    does nothing either: its events would belong to the graph, and the
    graph's replays run no Python to record them.
    """
    if not _profiler_enabled() or (torch.cuda.is_available() and
                                   torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _Span(name, on)


class SpanLog:
    """The finished spans of this process, at most :attr:`limit` (the
    oldest go first), and the pool of CUDA events they time the device
    with."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self._spans: collections.deque = collections.deque()
        self._pool: Dict[int, List[torch.cuda.Event]] = {}
        self._lock = threading.Lock()

    def event(self, dev: int) -> torch.cuda.Event:
        """A timing event from the pool, recorded on ``dev``'s current
        stream."""
        with self._lock:
            free = self._pool.setdefault(dev, [])
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def _release(self, s: _Span) -> None:
        if s.dev is not None:
            self._pool[s.dev].extend(e for e in (s.ev0, s.ev1)
                                     if e is not None)

    def keep(self, s: _Span) -> None:
        with self._lock:
            self._spans.append(s)
            while len(self._spans) > self.limit:
                self._release(self._spans.popleft())

    def clear(self) -> None:
        with self._lock:
            for s in self._spans:
                self._release(s)
            self._spans.clear()

    def finished(self) -> List[dict]:
        """The kept spans in the order they closed, as dicts: ``name``,
        ``id``, ``parent``, ``shape``, ``host_start_ns`` and
        ``host_end_ns`` (``time.perf_counter_ns``), ``device_start_ms``
        and ``device_end_ms`` (from the earliest device event kept of the
        span's shape; ``None`` off a CUDA device).  Waits once for each
        device the spans timed."""
        with self._lock:
            spans = list(self._spans)
        for dev in sorted({s.dev for s in spans if s.dev is not None}):
            torch.cuda.synchronize(dev)
        first: Dict[int, _Span] = {}
        for s in spans:
            f = first.get(s.shape)
            if s.dev is not None and (f is None or s.t0 < f.t0):
                first[s.shape] = s
        out = []
        for s in spans:
            f = first.get(s.shape)
            timed = s.dev is not None and f.dev == s.dev
            out.append(dict(
                name=s.name, id=s.id, parent=s.parent, shape=s.shape,
                host_start_ns=s.t0, host_end_ns=s.t1,
                device_start_ms=f.ev0.elapsed_time(s.ev0) if timed else None,
                device_end_ms=f.ev0.elapsed_time(s.ev1) if timed else None))
        return out


LOG = SpanLog()


def finished_spans() -> List[dict]:
    """The spans kept so far (:meth:`SpanLog.finished`)."""
    return LOG.finished()


def clear_spans() -> None:
    """Forget the kept spans."""
    LOG.clear()
