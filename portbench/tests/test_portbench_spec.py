"""Finding cells, configurations, mixes, limits, metric readers and the
kernel map by name; ``BENCHMARK.json`` against the benchmark contract's
shape."""

import json
import re
import shutil

import pytest

from portbench import spec
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_files(bench):
    import importlib
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        traffic = spec.traffic(w["traffic"])
        importlib.import_module(f"portbench.drivers.{traffic['kind']}")
        assert spec.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for name in names + cells + metrics:
        assert NAME.match(name), name
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], cell), (m["name"], cell)
    for w in bench["workloads"]:
        wanted = spec.cell_metrics(bench, w["name"])
        reported = {m["name"] for m in wanted["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert wanted["per_layer"]
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
    # a check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s
    # a cell to compile and 1,200 s spare, fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def test_an_added_cell_mix_metric_and_mapping_are_found(tmp_path):
    root = tiny.checkout(tmp_path, [(
        "tiny-new", {"name": "tiny-new-config", "net": tiny.NET,
                     "weights": "seed"},
        dict(tiny.EVAL, pool=2), dict(tiny.EVAL_LIMITS))])
    bench = spec.load_benchmark(root)
    assert spec.cell(bench, "tiny-new")["config"] == "tiny-new-config"
    assert spec.config(bench, "tiny-new-config", root)["net"] == tiny.NET
    assert spec.traffic("tiny-new", root)["pool"] == 2
    assert spec.limits("tiny-new", root) == tiny.EVAL_LIMITS
    (root / "portbench" / "metrics" / "new.metric_ms.py").write_text(
        "def read(ctx):\n    return 4.5\n")
    assert spec.metric_reader("new.metric_ms", root)({}) == 4.5
    (root / "portbench" / "kernel_map" / "later.json").write_text(
        json.dumps({"map": [["fused_level_kernel", "level"]]}))
    rules = spec.kernel_map(root)
    assert spec.operation_of("void fused_level_kernel<4>(float*)", rules) \
        == "level"
    assert spec.operation_of("void fps_kernel<3>(float const*)", rules) \
        == "fps"
    assert spec.operation_of("sm80_xmma_gemm_f32f32", rules) is None


def test_names_outside_the_rules_are_refused(tmp_path):
    with pytest.raises(ValueError):
        spec.traffic("../BENCHMARK", tmp_path)
    with pytest.raises(KeyError):
        spec.cell(spec.load_benchmark(), "no-such-cell")
    shutil.rmtree(tmp_path, ignore_errors=True)
