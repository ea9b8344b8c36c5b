"""The PU-Net cell (``punet-eval-5k``): its files are found, a tiny run of
its driver on the CPU is correct, its control (the reference in TF32 in
the program's place) and a program with a fault are not, and its readers
read ``None`` where the run has nothing for them."""

import json
import time
from unittest import mock

import pytest
import torch

from portbench import control, harness, spec, work_punet
from portbench.tests import tiny

CELL = "tiny-punet"
NET = {"num_point": 64, "up_ratio": 4, "radii": [0.05, 0.1, 0.2, 0.3],
       "nsample": 32,
       "sa_mlps": [[32, 32, 64], [64, 64, 128], [128, 128, 256],
                   [256, 256, 512]],
       "fp_mlp": [64], "expand_mlp": [256, 128], "coord_mlp": [64, 3]}
TRAFFIC = {"kind": "punet_eval", "pool": 3, "points": 200, "ratio": 4,
           "num_point": 64, "patch_num_ratio": 3, "chunk": 4,
           "world_size": 1}
METRICS = ("punet.sa_ms", "punet.ball_query_ms", "punet.fps_roofline",
           "mfu.punet_eval")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # two threads a worker, as the other runs' tests take: the control's
    # TF32 rounding oversubscribes the cores under several workers
    torch.set_num_threads(2)
    real = spec.load_benchmark()
    root = tiny.checkout(tmp_path_factory.mktemp("tiny"), [(
        CELL, {"name": "tiny-punet", "net": NET, "weights": "seed"},
        dict(TRAFFIC), spec.limits("punet-eval-5k"))])
    bench = spec.load_benchmark(root)
    for m in bench["end_to_end"]:
        if m["name"] in ("shape_s", "shape_p90_s"):
            m["workloads"].append(CELL)
    bench["per_layer"] += [dict(m, workloads=[CELL])
                           for m in real["per_layer"] if m["name"] in METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, seed=2**31 + 91):
    result, lines = harness.run_cell(spec.load_benchmark(root), CELL, seed,
                                     1.0, 0, "cpu", time.time(), root)
    assert lines[-1].startswith("checked shapes or steps")
    return result


def test_the_cell_finds_its_files():
    bench = spec.load_benchmark()
    cell = spec.cell(bench, "punet-eval-5k")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "punet-4x", "punet-closed-5k", 1)
    cfg = spec.config(bench, "punet-4x")
    assert cfg["net"]["num_point"] == 1024 and cfg["reduced"] == []
    assert spec.traffic("punet-closed-5k")["kind"] == "punet_eval"
    assert set(spec.limits("punet-eval-5k")) == {"start", "sa_rows",
                                                 "coords", "restitch"}
    wanted = spec.cell_metrics(bench, "punet-eval-5k")
    assert {m["name"] for m in wanted["end_to_end"]} == {
        "shape_s", "shape_p90_s", "setup_s"}
    assert {m["name"] for m in wanted["per_layer"]} == set(METRICS)


def test_the_work_is_the_published_table():
    cfg = spec.config(spec.load_benchmark(), "punet-4x")["net"]
    got = work_punet.patch_flops(cfg, 1024)
    want = dict(sa1=0.21, sa2=0.54, sa3=1.08, sa4=2.15, fp=0.12,
                expand=0.81, coords=0.07)
    assert {k: round(v / 1e9, 2) for k, v in got.items()} == want
    traffic = spec.traffic("punet-closed-5k")
    assert work_punet.shape_flops(cfg, traffic) == 14 * sum(got.values())
    # the seed, 2 chunks of 4 SA levels, the re-stitch of 8 groups
    bounds = work_punet.fps_bounds(cfg, traffic)
    assert len(bounds) == 10
    assert bounds[1].ops == 8 * 1024 * 1023 * 10
    assert bounds[-1].ops == 8 * 7168 * 2499 * 10


def test_a_tiny_run_is_correct(root):
    res = run(root)
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"shape_s", "shape_p90_s", "setup_s"}
    checked = res["checked"]
    assert checked["start"]["value"] == checked["sa_rows"]["value"] == 0.0
    assert checked["coords"]["value"] <= 1e-5
    assert res["attempted"] >= 2


def test_the_control_fails(root):
    lim = spec.limits(CELL, root)
    bench = spec.load_benchmark(root)
    for seed in (11, 12):
        got = control.readings(bench, CELL, seed, "cpu", True, root)
        assert any(got[k] > v for k, v in lim.items()), got
    sound = control.readings(bench, CELL, 11, "cpu", False, root)
    assert all(sound[k] <= v for k, v in lim.items()), sound


def test_fps_picks_that_differ_fail(root):
    from threepu_torch.models import punet
    fps = punet.fps

    def reversed_picks(points, m, valid_mask=None):
        return fps(points, m, valid_mask).flip(-1).contiguous()

    with mock.patch.object(punet, "fps", reversed_picks):
        res = run(root)
    assert not res["correct"]
    # nearly every FPS row differs: 120 of a patch's 432 rows
    assert res["checked"]["sa_rows"]["value"] > 0.2


def test_an_output_altered_fails(root):
    from threepu_torch.models import punet
    upsample = punet.PUNet.upsample

    def altered(self, x, ratio=None, capture=None):
        return upsample(self, x, ratio, capture) + 1e-3

    with mock.patch.object(punet.PUNet, "upsample", altered):
        res = run(root)
    assert not res["correct"]
    assert res["checked"]["coords"]["value"] > 1e-4


@pytest.mark.parametrize("name", METRICS)
def test_each_reader_reads_none_without_records(name, monkeypatch):
    from threepu_torch.utils import profiling
    monkeypatch.setattr(profiling, "finished_spans", lambda: [])
    read = spec.metric_reader(name)
    assert read({"unit": "shape", "profile": None, "spans": {},
                 "window_units": 0, "units_profiled": 0}) is None
