"""CUDA graphs over a net's eval stages: :class:`Stages`, one set for
one input shape on one device, and :class:`GraphedNet`, the base of the
eval nets, which holds one set a stream slot (:class:`SlotSets`).

On a CUDA device each stage, a function of tensors, is captured as a
CUDA graph at its first call and replayed at every later one, so a
chunk's hundreds of small launches become a few dozen replays and the
host no longer sets its pace.  The kernels are the same as eager; only
how they are launched changes.  On the CPU every stage runs as written.

A stage passes an earlier stage's output (or a view of one) as it is and
copies any other tensor into a static input, once a set: a later stage
given the same tensor, unchanged, reads that copy.  Outputs belong to
the graphs, overwritten by the next replay; whatever leaves them for
code that may keep it goes through :meth:`Stages.own`, a copy.

``Kernel.launches`` counts Python calls, and a replay makes none: a
capture records each kernel's launches, and every replay adds them.  The
run before a capture and the capture itself count nothing, so a chunk
counts the launches of one eager run whether it captured or replayed.

The inference pipeline runs a shape's chunks two at a time, one on each
of :data:`SLOTS` stream slots (:class:`SlotStreams`), so that one
chunk's work fills the SMs that the other's merge FPS leaves idle.  Each
slot has a set of graphs of its own, captured and replayed on its own
stream, so the two chunks share no static input, output or workspace.
Code outside the pipeline runs in slot 0.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from collections.abc import Mapping
from functools import partial
from typing import (Callable, Dict, Hashable, Iterator, NamedTuple, Optional,
                    Sequence, Set, Tuple)

import torch
from torch import nn

from threepu_torch._build import Kernel


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    args: Tuple[torch.Tensor, ...]
    out: object
    launched: Dict[Kernel, int]


def _launch_counts() -> Dict[Kernel, int]:
    return {k: k.launches for k in Kernel.instances}


#: stream slots: a net holds a set of graphs for each, and the pipeline
#: runs a shape's chunks on them in turn
SLOTS = 2
_local = threading.local()


def current_slot() -> int:
    """The stream slot this thread runs in (:func:`slot`); 0 outside."""
    return getattr(_local, "slot", 0)


@contextlib.contextmanager
def slot(i: int):
    """Runs the block in stream slot ``i``: :meth:`GraphedNet.stages_for`
    hands out slot ``i``'s set."""
    prev, _local.slot = current_slot(), i
    try:
        yield
    finally:
        _local.slot = prev


class SlotStreams:
    """A CUDA device's stream for each slot, made once a device
    (:meth:`of`).  A slot's graphs are captured on its stream, and the
    pipeline runs the slot's chunks there: :meth:`fork` after the work
    they read, :meth:`run` around each chunk, :meth:`join` before the
    work that reads their outputs."""

    _made: Dict[torch.device, "SlotStreams"] = {}

    @staticmethod
    def streamed(t: torch.Tensor) -> bool:
        """Whether ``t``'s device has slot streams: a CUDA device."""
        return t.is_cuda

    @classmethod
    def of(cls, device: torch.device) -> "SlotStreams":
        got = cls._made.get(device)
        if got is None:
            got = cls._made[device] = cls(device)
        return got

    def __init__(self, device: torch.device):
        self.device = device
        self.streams = tuple(torch.cuda.Stream(device) for _ in range(SLOTS))

    def fork(self) -> None:
        """Every slot's stream waits for the work enqueued so far on the
        caller's stream."""
        ready = torch.cuda.current_stream(self.device).record_event()
        for s in self.streams:
            s.wait_event(ready)

    @contextlib.contextmanager
    def run(self, i: int):
        """Runs the block in slot ``i``, on its stream."""
        with torch.cuda.stream(self.streams[i]), slot(i):
            yield

    def join(self, outs: Sequence[torch.Tensor]) -> None:
        """The caller's stream waits for every slot's stream, and ``outs``,
        made there, go back to the allocator only once the caller's
        stream's work enqueued until they are freed has run."""
        caller = torch.cuda.current_stream(self.device)
        for s in self.streams:
            caller.wait_stream(s)
        for t in outs:
            t.record_stream(caller)


class Stages:
    """The stages of one input shape on one device.  On a CUDA device
    each stage is captured into one pool: first one run outside the
    capture on a side stream, as cuBLAS and the allocator want, then the
    capture, then a replay.  The stages must replay in the order they
    were captured, as one pool's graphs share its memory.

    The run before a capture and the capture go on the stream of the
    set's slot (:class:`SlotStreams`), so that the graphs of two slots
    own distinct cuBLAS workspaces (a workspace a stream).

    :attr:`graphs` holds each stage's graph, :attr:`captures` and
    :attr:`replays` count, by stage name, how often each was captured
    and replayed."""

    def __init__(self, device: torch.device, slot: int = 0):
        self.device = torch.device(device)
        self.slot = slot
        self.cuda = self.device.type == "cuda"
        self.graphs: Dict[str, _Graph] = {}
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        # static inputs by (stage, position), what each holds a copy of,
        # and the storage of the static inputs and captured outputs
        self._inputs: Dict[Tuple[str, int], torch.Tensor] = {}
        self._sources: Dict[Tuple[str, int], Optional[tuple]] = {}
        self._held: Set[int] = set()
        if self.cuda:
            with torch.cuda.device(self.device):
                self.pool = torch.cuda.graph_pool_handle()

    @staticmethod
    def graphed(t: torch.Tensor) -> bool:
        """Whether stages on ``t``'s device run as graphs: on a CUDA
        device."""
        return t.is_cuda

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """A stage's output as the caller's own: a copy on a CUDA device,
        which no later replay overwrites."""
        return t.clone() if self.cuda else t

    def _static(self, name: str, i: int, t: torch.Tensor) -> torch.Tensor:
        """Argument ``i`` of stage ``name`` in storage of this set: ``t``
        where the storage is the set's; else the static input an earlier
        stage copied ``t`` into, where ``t`` has not changed since; else
        ``t`` copied into the static input ``(name, i)``."""
        if t.untyped_storage().data_ptr() in self._held:
            return t
        for key, src in self._sources.items():
            if src is not None and src[0]() is t and src[1] == t._version:
                return self._inputs[key]
        key = (name, i)
        buf = self._inputs.get(key)
        if buf is None:
            buf = self._inputs[key] = torch.empty(
                t.shape, dtype=t.dtype, device=self.device)
            self._held.add(buf.untyped_storage().data_ptr())
        elif buf.shape != t.shape or buf.dtype != t.dtype:
            raise RuntimeError(f"graph input {i} of {name} was "
                               f"{tuple(buf.shape)} {buf.dtype}; got "
                               f"{tuple(t.shape)} {t.dtype}")
        buf.copy_(t)
        # an inference tensor counts no versions: copied at every call
        self._sources[key] = None if t.is_inference() else (
            weakref.ref(t), t._version)
        return buf

    def __call__(self, name: str, fn: Callable, *args: torch.Tensor):
        """``fn(*args)``: on a CUDA device captured at the first call of
        ``name`` and replayed at every later one, on the arguments as
        :meth:`_static` stages them, the same tensors at every call
        (contiguous, on the CPU).  ``fn`` returns a tensor or a tuple of
        tensors."""
        if not self.cuda:
            return fn(*(a.contiguous() for a in args))
        args = tuple(self._static(name, i, a) for i, a in enumerate(args))
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
            self._held.update(t.untyped_storage().data_ptr() for t in (
                out if isinstance(out, tuple) else (out,)))
        got.graph.replay()
        for kernel, n in got.launched.items():
            kernel.launches += n
        self.replays[name] += 1
        return got.out

    def _stream(self) -> "torch.cuda.Stream":
        return SlotStreams.of(self.device).streams[self.slot]

    def _warm(self, fn: Callable, args: tuple) -> None:
        """The run before a capture, on the slot's stream."""
        with torch.cuda.device(self.device):
            side = self._stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*args)
            torch.cuda.current_stream().wait_stream(side)

    def _record(self, fn: Callable, args: tuple):
        """``(graph, outputs)`` of ``fn(*args)`` captured into the pool on
        the slot's stream."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self.pool, stream=self._stream()):
            out = fn(*args)
        return graph, out


#: stages run as written, on any device: for paths that take no graphs
EAGER = Stages("cpu")


class StageSets(dict):
    """A slot's graphs: at most one :class:`Stages`, under the key it was
    captured for (input shape, device and whatever else fixes the
    stages).  :meth:`take` hands out the set for a key once two calls in
    a row have asked for it: a shape seen once runs eagerly and costs no
    capture, and one that repeats replaces the set held, so the graphs'
    memory does not grow with the shapes seen."""

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


class SlotSets(Mapping):
    """A net's graphs: a :class:`StageSets` for each stream slot, each
    with its own rule, so a net holds at most :data:`SLOTS` sets.  As a
    mapping, the sets held by ``(slot, key)``."""

    def __init__(self):
        self._slots = tuple(StageSets() for _ in range(SLOTS))

    def take(self, i: int, key: Hashable,
             make: Callable[[], Stages]) -> Stages:
        """:meth:`StageSets.take` of slot ``i``."""
        return self._slots[i].take(key, make)

    def __getitem__(self, slot_key: Tuple[int, Hashable]) -> Stages:
        i, key = slot_key
        return self._slots[i][key]

    def __iter__(self) -> Iterator[Tuple[int, Hashable]]:
        return ((i, key) for i, sets in enumerate(self._slots)
                for key in sets)

    def __len__(self) -> int:
        return sum(map(len, self._slots))

    def clear(self) -> None:
        """Forgets every slot's set and last key."""
        for sets in self._slots:
            sets.clear()


class GraphedNet(nn.Module):
    """An eval net whose stages run as CUDA graphs on a card: it holds
    their sets, one a stream slot, hands out the set of the slot a call
    runs in (:meth:`stages_for`) and drops them when its tensors move or
    change type."""

    #: the sets' class, which says what it graphs (tests emulate it)
    stage_class = Stages

    def __init__(self):
        super().__init__()
        self._stages = SlotSets()

    def stages_for(self, xyz: torch.Tensor, *key: Hashable) -> Stages:
        """The stages of a call on ``xyz``: :data:`EAGER` off a CUDA
        tensor, else the set that the current slot (:func:`slot`) hands
        out for ``xyz``'s shape and device and ``key``, whatever else
        fixes the stages."""
        if not self.stage_class.graphed(xyz):
            return EAGER
        i = current_slot()
        return self._stages.take(i, (tuple(xyz.shape), xyz.device, *key),
                                 partial(self.stage_class, xyz.device, i))

    def _apply(self, fn, *args, **kwargs):
        # moved or cast parameters leave the captured graphs' pointers
        # behind: capture anew, in every slot
        self._stages.clear()
        return super()._apply(fn, *args, **kwargs)
