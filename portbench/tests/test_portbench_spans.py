"""The readers of the program's own spans (``pipeline.seed_ms``,
``cascade.merge_fps_ms``, ``pipeline.host_ms``) on synthetic records,
and the spans' names against the kernel map."""

import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spec
from threepu_torch.utils import profiling

_ids = itertools.count(1)


def shape(seed_ms, merge_ms, host_ms, device=True):
    """One shape's records as ``finished_spans`` gives them: ``seed``
    taking ``seed_ms`` on the device, a ``level<l>.merge_fps`` span for
    each of ``merge_ms`` and ``prepare`` / ``finish.host`` splitting
    ``host_ms`` on the host; ``finish.download`` and the cascade around
    them are not read."""
    root = next(_ids)
    recs, t = [], [0.0]

    def rec(name, dev_ms, host, parent=root):
        i = next(_ids)
        recs.append(dict(name=name, id=i, parent=parent, shape=root,
                         host_start_ns=0,
                         host_end_ns=round(host * 1e6),
                         device_start_ms=t[0] if device else None,
                         device_end_ms=t[0] + dev_ms if device else None))
        t[0] += dev_ms
        return i

    rec("prepare", 0.0, host_ms * 0.75)
    rec("seed", seed_ms, 0.1)
    cascade = rec("cascade", 5.0, 0.2)
    for l, ms in enumerate(merge_ms, start=2):
        rec(f"level{l}.merge_fps", ms, 0.1, parent=cascade)
    rec("finish.download", 7.0, 7.0)
    rec("finish.host", 0.0, host_ms * 0.25)
    recs.append(dict(name="shape", id=root, parent=None, shape=root,
                     host_start_ns=0, host_end_ns=10 ** 9,
                     device_start_ms=0.0 if device else None,
                     device_end_ms=t[0] if device else None))
    return recs


@pytest.fixture
def spans(monkeypatch):
    """Sets what ``finished_spans`` returns."""
    kept = []
    monkeypatch.setattr(profiling, "finished_spans", lambda: list(kept))
    return kept


def read(name, ctx=None):
    return spec.metric_reader(name)({"unit": "shape"} if ctx is None
                                    else ctx)


def test_sums_a_shape_and_takes_the_median(spans):
    """The sum over a shape's spans, the median over shapes: the
    host-profiled shape (slow everywhere) is put aside."""
    spans += shape(1.0, [0.5, 1.0, 2.0], 0.4)
    spans += shape(1.2, [0.5, 1.0, 2.5], 0.6)
    spans += shape(1.4, [0.5, 1.5, 2.5], 0.8)
    spans += shape(9.0, [5.0, 5.0, 5.0], 9.0)      # host-profiled
    spans += shape(1.1, [0.5, 1.0, 2.0], 0.5)
    assert read("pipeline.seed_ms") == pytest.approx(1.2)
    assert read("cascade.merge_fps_ms") == pytest.approx(4.0)
    assert read("pipeline.host_ms") == pytest.approx(0.6)


def test_spans_outside_a_shape_are_not_read(spans):
    spans += shape(1.0, [1.0], 1.0)
    # a seed span whose shape root was never kept
    orphan = shape(50.0, [50.0], 50.0)
    spans += [r for r in orphan if r["name"] != "shape"]
    assert read("pipeline.seed_ms") == pytest.approx(1.0)
    assert read("cascade.merge_fps_ms") == pytest.approx(1.0)
    assert read("pipeline.host_ms") == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["pipeline.seed_ms", "cascade.merge_fps_ms",
                                  "pipeline.host_ms"])
def test_none_for_another_unit_or_no_records(spans, name):
    assert read(name) is None
    spans += shape(1.0, [1.0], 1.0)
    assert read(name, {"unit": "step"}) is None
    assert read(name, {}) is None
    assert read(name) is not None


@pytest.mark.parametrize("name", ["pipeline.seed_ms", "cascade.merge_fps_ms"])
def test_device_readers_need_device_times(spans, name):
    """Spans timed on the host alone (a CPU run) give no device ms."""
    spans += shape(1.0, [1.0], 1.0, device=False)
    assert read(name) is None
    assert read("pipeline.host_ms") == pytest.approx(1.0)


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent commit's program has no ``finished_spans``."""
    monkeypatch.delattr(profiling, "finished_spans")
    for name in ("pipeline.seed_ms", "cascade.merge_fps_ms",
                 "pipeline.host_ms"):
        assert read(name) is None


def test_no_span_is_read_as_a_kernel():
    """No annotation of a tiny step-2 shape holds a key of the kernel
    map, so the roofline readers never count a span as a kernel."""
    from threepu_torch.inference import upsample_shape
    from threepu_torch.models import Net

    torch.manual_seed(0)
    net = Net(max_up_ratio=8, step_ratio=2, knn=8, growth_rate=4,
              dense_n=2, max_num_point=32, fm_knn=3).eval()
    pts = np.random.default_rng(0).standard_normal((64, 3)).astype(
        np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        upsample_shape(net, pts, 8, num_point=16, chunk=4)
    profiling.clear_spans()
    names = {e.name.lower() for e in prof.events()
             if e.name.startswith("threepu.")}
    assert "threepu.level3.merge_fps" in names
    keys = [k.lower() for k, _ in spec.kernel_map()]
    assert keys
    for name in names:
        assert not any(k in name for k in keys), name
