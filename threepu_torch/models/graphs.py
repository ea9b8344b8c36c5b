"""CUDA graphs over a net's eval stages: :class:`Stages`, one set for
one input shape on one device, and :class:`StageSets`, the one set a net
holds.

On a CUDA device each stage, a function of tensors, is captured as a
CUDA graph at its first call and replayed at every later one, so a
chunk's hundreds of small launches become a few dozen replays and the
host no longer sets its pace.  The kernels are the same as eager; only
how they are launched changes.  On the CPU every stage runs as written.

A stage takes static inputs (:meth:`Stages.input`, a copy of a tensor
from outside the graphs) or earlier stages' outputs, which belong to the
graphs: the same storage on every call, overwritten by the next replay.
Whatever leaves the graphs for code that may keep it goes through
:meth:`Stages.own`, a copy.

``Kernel.launches`` counts Python calls, and a replay makes none: a
capture records each kernel's launches, and every replay adds them.  The
run before a capture and the capture itself count nothing, so a chunk
counts the launches of one eager run whether it captured or replayed.

A net keeps at most one set (:class:`StageSets`), captured when two calls
in a row ask for the same key: a shape seen once runs eagerly
(:data:`EAGER`) and costs no capture, and a shape that repeats replaces
the set held, so the graphs' memory does not grow with the shapes seen.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, NamedTuple, Optional, Tuple

import torch

from threepu_torch._build import Kernel


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    args: Tuple[torch.Tensor, ...]
    out: object
    launched: Dict[Kernel, int]


def _launch_counts() -> Dict[Kernel, int]:
    return {k: k.launches for k in Kernel.instances}


class Stages:
    """The stages of one input shape on one device.  On a CUDA device
    each stage is captured into one pool: first one run outside the
    capture on a side stream, as cuBLAS and the allocator want, then the
    capture, then a replay.  The stages must replay in the order they
    were captured, as one pool's graphs share its memory.

    :attr:`graphs` holds each stage's graph, :attr:`captures` and
    :attr:`replays` count, by stage name, how often each was captured
    and replayed."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.graphs: Dict[str, _Graph] = {}
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        self._inputs: Dict[str, torch.Tensor] = {}
        if self.cuda:
            with torch.cuda.device(self.device):
                self.pool = torch.cuda.graph_pool_handle()

    @staticmethod
    def graphed(t: torch.Tensor) -> bool:
        """Whether stages on ``t``'s device run as graphs: on a CUDA
        device."""
        return t.is_cuda

    def input(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the static input ``name``: on a CUDA device a copy in
        storage of its own that every call of that name overwrites."""
        if not self.cuda:
            return t.contiguous()
        buf = self._inputs.get(name)
        if buf is None:
            buf = self._inputs[name] = torch.empty(
                t.shape, dtype=t.dtype, device=self.device)
        elif buf.shape != t.shape or buf.dtype != t.dtype:
            raise RuntimeError(f"graph input {name} was {tuple(buf.shape)} "
                               f"{buf.dtype}; got {tuple(t.shape)} {t.dtype}")
        buf.copy_(t)
        return buf

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """A stage's output as the caller's own: a copy on a CUDA device,
        which no later replay overwrites."""
        return t.clone() if self.cuda else t

    def __call__(self, name: str, fn: Callable, *args: torch.Tensor):
        """``fn(*args)``: on a CUDA device captured at the first call of
        ``name`` and replayed at every later one, which must pass the
        same tensors."""
        if not self.cuda:
            return fn(*args)
        got = self.graphs.get(name)
        if got is not None and (len(args) != len(got.args) or any(
                a.data_ptr() != b.data_ptr() for a, b in zip(args, got.args))):
            raise RuntimeError(f"graph stage {name} was captured on other "
                               "tensors")
        if got is None:
            before = _launch_counts()
            try:
                self._warm(fn, args)
                warm = _launch_counts()
                graph, out = self._record(fn, args)
                launched = {k: k.launches - n for k, n in warm.items()
                            if k.launches != n}
            finally:
                for kernel, n in before.items():
                    kernel.launches = n
            got = self.graphs[name] = _Graph(graph, args, out, launched)
            self.captures[name] += 1
        got.graph.replay()
        for kernel, n in got.launched.items():
            kernel.launches += n
        self.replays[name] += 1
        return got.out

    def _warm(self, fn: Callable, args: tuple) -> None:
        """The run before a capture, on a side stream."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*args)
            torch.cuda.current_stream().wait_stream(side)

    def _record(self, fn: Callable, args: tuple):
        """``(graph, outputs)`` of ``fn(*args)`` captured into the pool."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self.pool):
            out = fn(*args)
        return graph, out


#: stages run as written, on any device: for paths that take no graphs
EAGER = Stages("cpu")


class StageSets(dict):
    """A net's graphs: at most one :class:`Stages`, under the key it was
    captured for (input shape, device and whatever else fixes the
    stages).  :meth:`take` hands out the set for a key once two calls in
    a row have asked for it; :meth:`clear` (a net's ``_apply``) drops
    it."""

    def __init__(self):
        super().__init__()
        self._last: Optional[Hashable] = None

    def take(self, key: Hashable, make: Callable[[], Stages]) -> Stages:
        """The set held for ``key``; else, when the last call asked for
        ``key`` too, a new set from ``make()`` in place of the one held;
        else :data:`EAGER`."""
        last, self._last = self._last, key
        got = self.get(key)
        if got is None and key == last:
            super().clear()
            got = self[key] = make()
        return EAGER if got is None else got

    def clear(self) -> None:
        super().clear()
        self._last = None
