"""The port's tracing (``threepu_torch.utils.profiling``): the
``torch.profiler`` trace of the command line, and the spans the eval
path records while a profiler records, on the CPU at tiny sizes."""

import torch_threads  # noqa: F401  (first: sets torch's threads)
import json
import os
import re
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from threepu_torch import inference as inf
from threepu_torch.models import Net
from threepu_torch.utils import profiling
from threepu_torch.utils.profiling import (clear_spans, finished_spans,
                                           span, trace)


#: tiny nets of three levels of 2x and two of 4x
NETS = {
    2: dict(max_up_ratio=8, step_ratio=2, knn=8, growth_rate=4, dense_n=2,
            max_num_point=32, fm_knn=3),
    4: dict(max_up_ratio=16, step_ratio=4, knn=8, growth_rate=4, dense_n=2,
            max_num_point=32, fm_knn=3),
}
SHAPE_KW = dict(num_point=16, chunk=4)
N_POINTS = 64


@pytest.fixture(autouse=True)
def no_spans_left():
    clear_spans()
    yield
    clear_spans()


def tiny(step):
    torch.manual_seed(step)
    net = Net(**NETS[step]).eval()
    pts = np.random.default_rng(step).standard_normal(
        (N_POINTS, 3)).astype(np.float32)
    return net, pts, NETS[step]["max_up_ratio"]


def profiled_shape(step):
    """A tiny shape under the CPU profiler: the spans and the profiler."""
    net, pts, ratio = tiny(step)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = inf.upsample_shape(net, pts, ratio, **SHAPE_KW)
    return finished_spans(), prof, out


@pytest.mark.parametrize("cuda", [False, None])
def test_trace_writes_a_chrome_trace(tmp_path, cuda):
    """``trace`` records the block with ``torch.profiler`` and writes
    ``trace.json`` (CPU events here: no GPU is visible, so the default
    asks for none)."""
    with trace(str(tmp_path / "prof"), cuda=cuda) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_holds_the_spans(tmp_path):
    """The command line's trace of a shape names the program's stages."""
    net, pts, ratio = tiny(2)
    with trace(str(tmp_path / "prof"), cuda=False):
        inf.upsample_shape(net, pts, ratio, **SHAPE_KW)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"threepu.shape", "threepu.level1.conv1"} <= names


def test_cli_has_one_profiler_helper():
    """The command line profiles through ``utils.profiling.trace``."""
    import threepu_torch.cli as cli
    assert cli.trace is profiling.trace
    assert not hasattr(cli, "_profiled")
    assert os.path.basename(profiling.__file__) == "profiling.py"


def test_off_records_and_creates_nothing(monkeypatch):
    """Without a profiler a span is one shared object: no record, no
    profiler annotation, no CUDA event."""
    def refuse(*a, **kw):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    net, pts, ratio = tiny(2)
    inf.upsample_shape(net, pts, ratio, **SHAPE_KW)
    assert span("a") is span("b", on=torch.zeros(1))
    assert finished_spans() == []
    # the same patch stops a span while a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError):
            with span("a"):
                pass


def test_outputs_equal_with_and_without_a_profiler():
    net, pts, ratio = tiny(2)
    want = inf.upsample_shape(net, pts, ratio, **SHAPE_KW)
    _, _, got = profiled_shape(2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_the_pipeline_keeps_its_outside_hooks():
    """What the benchmark wraps from outside: ``net.upsample`` through
    the instance, once a chunk, then the module's ``fps_hierarchical``
    and ``gather_nd``, in that order, for the re-stitch."""
    net, pts, ratio = tiny(2)
    calls = []
    upsample = net.upsample

    def chunk(x, r=None, capture=None):
        calls.append("chunk")
        return upsample(x, r, capture)

    def record(name, fn):
        return lambda *a, **kw: (calls.append(name), fn(*a, **kw))[1]

    net.upsample = chunk
    with mock.patch.object(inf, "fps_hierarchical",
                           record("fps", inf.fps_hierarchical)), \
            mock.patch.object(inf, "gather_nd",
                              record("gather", inf.gather_nd)):
        inf.upsample_shape(net, pts, ratio, restitch_groups=2, **SHAPE_KW)
    _, padded, c = inf.plan_patches(N_POINTS, SHAPE_KW["num_point"],
                                    chunk=SHAPE_KW["chunk"])
    chunks = padded // c
    # the seed's gather, the chunks, then the re-stitch
    assert calls == ["gather"] + ["chunk"] * chunks + ["fps", "gather"]


@pytest.mark.parametrize("step", [2, 4])
def test_span_tree(step):
    """One shape, one root; the chunks' cascades under one span, a
    cascade span a chunk, a level span a level of each; merge FPS under
    the levels that split; every span inside its parent's host time."""
    spans, _, _ = profiled_shape(step)
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["shape"]
    assert {s["shape"] for s in spans} == {roots[0]["id"]}
    for s in spans:
        p = by_id.get(s["parent"])
        if p is not None:
            assert p["host_start_ns"] <= s["host_start_ns"] \
                <= s["host_end_ns"] <= p["host_end_ns"]
    _, padded, c = inf.plan_patches(N_POINTS, SHAPE_KW["num_point"],
                                    chunk=SHAPE_KW["chunk"])
    chunks = padded // c
    n = Counter(s["name"] for s in spans)
    children = [s for s in spans if s["parent"] == roots[0]["id"]]
    assert [s["name"] for s in children] == ["prepare", "seed", "cascades",
                                             "restitch", "finish"]
    assert [s["name"] for s in spans
            if s["parent"] == children[2]["id"]] == ["cascade"] * chunks
    levels = {2: 3, 4: 2}[step]
    for l in range(1, levels + 1):
        assert n[f"level{l}"] == chunks
        for i in (1, 2, 3, 4):
            assert n[f"level{l}.conv{i}"] == chunks
        assert n[f"level{l}.head"] == chunks
    assert not any(k.startswith(f"level{levels + 1}") for k in n)
    # a level splits where its input outgrows the patch: every level
    # after the first
    split = [l for l in range(1, levels + 1)
             if SHAPE_KW["num_point"] * NETS[step]["step_ratio"] ** (l - 1)
             > min(SHAPE_KW["num_point"], NETS[step]["max_num_point"])]
    assert split == list(range(2, levels + 1))
    for s in spans:
        if s["name"].endswith((".merge_fps", ".extract")):
            parent = by_id[s["parent"]]["name"]
            assert parent == s["name"].split(".")[0]
            assert int(parent[len("level"):]) in split
    for l in split:
        assert n[f"level{l}.merge_fps"] == n[f"level{l}.extract"] == chunks
    for s in spans:
        if s["name"].startswith("level") and "." not in s["name"]:
            assert by_id[s["parent"]]["name"] == "cascade"
    assert [by_id[s["parent"]]["name"] for s in spans
            if s["name"].startswith("finish.")] == ["finish", "finish"]


def test_spans_are_profiler_annotations():
    """Every span shows on the profiler's timeline as ``threepu.<name>``;
    no name reads like a kernel's (the port's kernels end in
    ``_kernel``), so none is taken for a device operation."""
    spans, prof, _ = profiled_shape(2)
    annotated = {e.name for e in prof.events()
                 if e.name.startswith("threepu.")}
    assert annotated == {"threepu." + s["name"] for s in spans}
    for name in annotated:
        assert re.fullmatch(r"threepu\.[a-z0-9_.]+", name), name
        assert "kernel" not in name, name


def test_an_exception_closes_the_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("inside")
        with span("after"):
            pass
    spans = finished_spans()
    assert [s["name"] for s in spans] == ["inner", "outer", "after"]
    inner, outer, after = spans
    assert inner["parent"] == outer["id"] and after["parent"] is None
    assert outer["host_end_ns"] >= inner["host_end_ns"]


def test_the_bound_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling.LOG, "limit", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [s["name"] for s in finished_spans()] == ["s2", "s3", "s4"]


def test_clear_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            pass
    assert len(finished_spans()) == 1
    clear_spans()
    assert finished_spans() == []


class FakeEvent:
    """A CUDA timing event's surface, its time set by the test."""
    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """Spans ``on`` a tensor time "cuda:0" with :class:`FakeEvent`."""
    syncs = []
    FakeEvent.made, FakeEvent.clock = 0, 0.0
    monkeypatch.setattr(profiling, "LOG", profiling.SpanLog())
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    monkeypatch.setattr(profiling, "_cuda_index",
                        lambda on: 0 if torch.is_tensor(on) else None)
    return syncs


def test_device_times_from_the_shapes_first_event(fake_card):
    """Device ms from the first event of the span's shape, a child on its
    parent's device; one wait for the device."""
    x = torch.zeros(1)
    with profile(activities=[ProfilerActivity.CPU]):
        for base in (100.0, 500.0):
            FakeEvent.clock = base
            with span("shape", on=x):
                FakeEvent.clock += 2.0
                with span("seed"):
                    FakeEvent.clock += 3.0
                FakeEvent.clock += 1.0
        with span("host only"):
            pass
    spans = finished_spans()
    assert fake_card == [0]
    times = [(s["name"], s["device_start_ms"], s["device_end_ms"])
             for s in spans]
    assert times == [("seed", 2.0, 5.0), ("shape", 0.0, 6.0)] * 2 \
        + [("host only", None, None)]
    assert spans[0]["shape"] == spans[1]["id"] != spans[2]["id"]


def test_events_come_from_a_pool(fake_card):
    """Closed spans' events go back to the pool when the spans are
    dropped or cleared: no event is made a span once it is warm."""
    x = torch.zeros(1)

    def shape():
        with profile(activities=[ProfilerActivity.CPU]):
            with span("shape", on=x):
                with span("seed"):
                    pass

    shape()
    assert FakeEvent.made == 4
    clear_spans()
    shape()
    assert FakeEvent.made == 4
    profiling.LOG.limit = 2
    shape()                          # the second shape's spans dropped
    shape()
    # three more while the second shape's spans were still kept
    assert FakeEvent.made == 7
