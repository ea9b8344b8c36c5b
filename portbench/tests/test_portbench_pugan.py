"""The PU-GAN cell (``pugan-eval-5k``): its files are found, a tiny run of
its driver on the CPU is correct, its control (the reference in TF32 in
the program's place) and programs with a fault are not, its readers read
``None`` where the run has nothing for them, and its reference imports
nothing of the port or of JAX."""

import json
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench import control, harness, spec, work_pugan
from portbench.pugancheck import READINGS
from portbench.tests import tiny

CELL, REAL = "tiny-pugan", "pugan-eval-5k"
NET = {"num_point": 64, "up_ratio": 4, "more_up": 2, "growth_rate": 24,
       "dense_n": 3, "knn": 16, "comp": 48, "layer0": 24, "up_feat": 128,
       "up_hidden": 256, "attention_in": 130, "attention": 32,
       "coord_mlp": [64, 3]}
TRAFFIC = {"kind": "pugan_eval", "pool": 3, "points": 200, "ratio": 4,
           "num_point": 64, "patch_num_ratio": 3, "chunk": 4,
           "world_size": 1}


def cell_metrics():
    """The real cell's per-layer metrics, as ``BENCHMARK.json`` lists
    them."""
    return spec.cell_metrics(spec.load_benchmark(), REAL)["per_layer"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # two threads a worker, as the other runs' tests take: the control's
    # TF32 rounding oversubscribes the cores under several workers
    torch.set_num_threads(2)
    root = tiny.checkout(tmp_path_factory.mktemp("tiny"), [(
        CELL, {"name": "tiny-pugan", "net": NET, "weights": "seed"},
        dict(TRAFFIC), spec.limits(REAL))])
    bench = spec.load_benchmark(root)
    for m in bench["end_to_end"]:
        if m["name"] in ("shape_s", "shape_p90_s"):
            m["workloads"].append(CELL)
    names = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [dict(m, workloads=[CELL]) for m in cell_metrics()
                           if m["name"] not in names]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, seed=2**31 + 77):
    result, lines = harness.run_cell(spec.load_benchmark(root), CELL, seed,
                                     1.0, 0, "cpu", time.time(), root)
    assert lines[-1].startswith("checked shapes or steps")
    return result


def test_the_cell_finds_its_files():
    bench = spec.load_benchmark()
    cell = spec.cell(bench, REAL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pugan-4x", "pugan-closed-5k", 1)
    cfg = spec.config(bench, "pugan-4x")
    assert cfg["reduced"] == [] and cfg["weights"] == "seed"
    assert dict(cfg["net"], num_point=64) == NET
    assert cfg["net"]["num_point"] == 256
    assert "gamma" in cfg["assumed"]
    traffic = spec.traffic("pugan-closed-5k")
    assert {k: traffic[k] for k in TRAFFIC} == dict(
        TRAFFIC, pool=32, points=5000, num_point=256, chunk=8)
    assert set(spec.limits(REAL)) == set(READINGS)
    wanted = spec.cell_metrics(bench, REAL)
    assert {m["name"] for m in wanted["end_to_end"]} == {
        "shape_s", "shape_p90_s", "setup_s"}
    names = {m["name"] for m in wanted["per_layer"]}
    assert {"pugan.updown_ms", "pugan.attention_roofline",
            "mfu.pugan_eval"} <= names
    for name in names:
        assert callable(spec.metric_reader(name)), name


def test_the_work_is_the_issues_table():
    cfg = spec.config(spec.load_benchmark(), "pugan-4x")["net"]
    got = work_pugan.patch_flops(cfg, 256)
    want = dict(extract=0.21, conv0=0.03, up0=1.04, up1=1.04, down=0.12,
                coords=0.03)
    assert {k: round(v / 1e9, 2) for k, v in got.items()} == want
    traffic = spec.traffic("pugan-closed-5k")
    assert work_pugan.shape_flops(cfg, traffic) == 58 * sum(got.values())
    # two units a patch, 64 patches run; 2 M^2 (32 + 130) + 5 M^2 each
    bound = work_pugan.attention_bound(cfg, traffic)
    assert bound.ops == 128 * (2 * 1536 ** 2 * 162 + 5 * 1536 ** 2)
    assert bound.nbytes == 128 * 1536 * (32 + 32 + 130 + 130) * 4
    assert bound.by == "operations"
    assert 11.5e-6 < bound.seconds / 128 < 11.7e-6


def test_the_fps_work_counts_every_call():
    """The seed's 58 picks of 5,000, each of the 8 chunks' net FPS (8 x
    1,536 -> 1,024, padding patches included) and the re-stitch."""
    from portbench import work, work_punet
    cfg = spec.config(spec.load_benchmark(), "pugan-4x")["net"]
    traffic = spec.traffic("pugan-closed-5k")
    got = work_pugan.fps_bounds(cfg, traffic)
    assert got[0] == work.fps_bound(1, 5000, 58)
    assert got[2:] == [work.fps_bound(8, 1536, 1024)] * 8
    assert got[:2] == work_punet.fps_bounds(dict(sa_mlps=()), traffic)


def test_a_tiny_run_is_correct(root):
    res = run(root)
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"shape_s", "shape_p90_s", "setup_s"}
    checked = res["checked"]
    assert checked["start"]["value"] == checked["sel_rows"]["value"] == 0.0
    assert checked["coords"]["value"] <= 1e-6
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
    from threepu_torch.models import pugan
    fps = pugan.fps

    def reversed_picks(points, m, valid_mask=None):
        return fps(points, m, valid_mask).flip(-1).contiguous()

    with mock.patch.object(pugan, "fps", reversed_picks):
        res = run(root)
    assert not res["correct"]
    assert res["checked"]["sel_rows"]["value"] > 0.2


def test_a_program_that_skips_the_attention_fails(root):
    """The seeded ``gamma`` keeps the attention in the output: a program
    whose attention returns zeros reads far off the reference."""
    from threepu_torch.models import pugan

    def skipped(q, k, v):
        return torch.zeros_like(v)

    with mock.patch.object(pugan, "attention", skipped):
        res = run(root)
    assert not res["correct"]
    assert res["checked"]["coords"]["value"] > 1e-3


def test_an_output_altered_fails(root):
    from threepu_torch.models import pugan
    upsample = pugan.PUGAN.upsample

    def altered(self, x, ratio=None, capture=None):
        return upsample(self, x, ratio, capture) + 1e-3

    with mock.patch.object(pugan.PUGAN, "upsample", altered):
        res = run(root)
    assert not res["correct"]
    assert res["checked"]["coords"]["value"] > 1e-4


@pytest.mark.parametrize("name", [m["name"] for m in cell_metrics()])
def test_each_reader_reads_none_without_records(name, monkeypatch):
    from threepu_torch.utils import profiling
    monkeypatch.setattr(profiling, "finished_spans", lambda: [])
    read = spec.metric_reader(name)
    assert read({"unit": "shape", "profile": None, "spans": {},
                 "window_units": 0, "units_profiled": 0}) is None


def test_the_attention_roofline_reads_the_spans(monkeypatch):
    """Two shapes, each with two chunks' attention spans of 1 ms: the
    median shape's 4 ms against a shape's least time."""
    from threepu_torch.utils import profiling
    recs = []
    for shape in (1, 2):
        recs.append(dict(name="shape", id=shape, parent=None, shape=shape,
                         device_start_ms=0.0, device_end_ms=50.0))
        for j in range(4):
            recs.append(dict(name=f"pugan.up{j % 2}.attention", id=10 * shape
                             + j, parent=shape, shape=shape,
                             device_start_ms=float(j),
                             device_end_ms=float(j) + 1.0))
    monkeypatch.setattr(profiling, "finished_spans", lambda: recs)
    cfg = spec.config(spec.load_benchmark(), "pugan-4x")["net"]
    bound = work_pugan.attention_bound(cfg, spec.traffic("pugan-closed-5k"))
    got = spec.metric_reader("pugan.attention_roofline")(
        {"unit": "shape", "work": {"attention": bound}})
    assert got == pytest.approx(100.0 * bound.seconds / 4e-3)


def test_the_reference_imports_nothing_forbidden():
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import portbench.reference_pugan, portbench.pugancheck\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'threepu',\n"
            "                    'threepu_torch'}))\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
    text = (spec.HERE / "reference_pugan.py").read_text()
    assert "allow_tf32 = False" in text
