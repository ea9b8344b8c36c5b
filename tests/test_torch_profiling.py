"""The port's profiling helpers (``threepu_torch.utils.profiling``): the
cases of ``tests/test_profiling.py`` (the JAX package's) on the port's
module, and its ``torch.profiler`` trace on the CPU."""

import json
import os
import time

import pytest
import torch

from threepu_torch.utils import profiling
from threepu_torch.utils.profiling import (Stopwatch, ThroughputMeter,
                                           force_sync, trace,
                                           trace_supported)


class TestStopwatch:
    def test_stages_and_report(self):
        sw = Stopwatch()
        with sw.stage("a") as h:
            h["result"] = torch.ones((4, 4)) * 2
        with sw.stage("a"):
            time.sleep(0.01)
        with sw.stage("b"):
            pass
        s = sw.summary()
        assert set(s) == {"a", "b"}
        assert s["a"] > 0
        assert "a=" in sw.report() and "b=" in sw.report()


class TestThroughputMeter:
    def test_accumulates(self):
        m = ThroughputMeter()
        m.add(100, 2.0)
        m.add(300, 2.0)
        assert m.points_per_sec == 100.0

    def test_zero_safe(self):
        assert ThroughputMeter().points_per_sec == 0.0


def test_force_sync():
    force_sync({"x": torch.arange(5.0)})
    force_sync([1, (torch.zeros(2),)])
    force_sync({})


def test_force_sync_synchronizes_a_cuda_tensor(monkeypatch):
    """A CUDA tensor's device is synchronized; a CPU tensor needs
    nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    force_sync(torch.zeros(2))
    assert calls == []
    force_sync({"y": torch.zeros(2).as_subclass(FakeCuda)})
    assert len(calls) == 1


@pytest.mark.parametrize("cuda", [False, None])
def test_trace_writes_a_chrome_trace(tmp_path, cuda):
    """``trace`` records the block with ``torch.profiler`` and writes
    ``trace.json`` (CPU events here: no GPU is visible, so the default
    asks for none)."""
    assert trace_supported()
    with trace(str(tmp_path / "prof"), cuda=cuda) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_cli_has_one_profiler_helper():
    """The command line profiles through ``utils.profiling.trace``."""
    import threepu_torch.cli as cli
    assert cli.trace is profiling.trace
    assert not hasattr(cli, "_profiled")
    assert os.path.basename(profiling.__file__) == "profiling.py"
