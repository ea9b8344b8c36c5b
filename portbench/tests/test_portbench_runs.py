"""Whole runs of the harness on the CPU at tiny sizes (everything but
the look for a card): sound runs come out correct; the control (the
reference in TF32 in the program's place) and runs with the timed path
broken underneath come out not correct."""

import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench import control, harness, spec
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    x4 = ("tiny-eval-x4", {"name": "tiny", "net": tiny.NET,
                           "weights": "seed"},
          dict(tiny.EVAL, world_size=4), dict(tiny.EVAL_LIMITS))
    return tiny.checkout(tmp, [tiny.train_cell(tmp), x4])


def run(root, cell, seed=2**31 + 77, trace=0):
    torch.set_num_threads(2)
    result, lines = harness.run_cell(spec.load_benchmark(root), cell, seed,
                                     1.0, trace, "cpu", time.time(), root)
    assert lines[-1].startswith("checked shapes or steps")
    return result


def test_eval_run_is_correct(root):
    res = run(root, "tiny-eval")
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"shape_s", "shape_p90_s", "setup_s"}
    assert list(res)[-1] == "checked"
    assert res["attempted"] >= 2 and res["failed"] == 0


def test_eval_run_over_four_ranks_is_correct(root):
    res = run(root, "tiny-eval-x4")
    assert res["correct"], res["checked"]
    assert res["device"]["count"] == 4


def test_train_run_is_correct(root):
    res = run(root, "tiny-train")
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-train"])
def test_the_control_fails(root, cell):
    lim = spec.limits(cell, root)
    bench = spec.load_benchmark(root)
    for seed in (11, 12, 13):
        got = control.readings(bench, cell, seed, "cpu", True, root)
        assert any(got[k] > v for k, v in lim.items()), got
    sound = control.readings(bench, cell, 11, "cpu", False, root)
    assert all(sound[k] <= v for k, v in lim.items()), sound


def test_an_answer_altered_where_it_is_made_fails(root):
    from threepu_torch.models import upsampler
    level = upsampler.Level.forward

    def altered(self, *a, **kw):
        xyz, feats = level(self, *a, **kw)
        return xyz + 1e-3, feats

    with mock.patch.object(upsampler.Level, "forward", altered):
        assert not run(root, "tiny-eval")["correct"]


def test_half_of_each_chunk_left_out_fails(root):
    from threepu_torch.models import upsampler
    upsample = upsampler.Net.upsample

    def half(self, x, ratio=None, capture=None):
        h = max(1, x.shape[0] // 2)
        out = upsample(self, x[:h], ratio, capture)
        return torch.cat([out, out[:x.shape[0] - h]])

    with mock.patch.object(upsampler.Net, "upsample", half):
        assert not run(root, "tiny-eval")["correct"]


def test_a_fault_in_one_chunk_only_fails(root):
    """Only the last chunk of each shape is altered: every chunk of a
    checked shape is replayed, so the check sees it."""
    from threepu_torch.models import upsampler
    upsample = upsampler.Net.upsample
    calls = [0]

    def last_altered(self, x, ratio=None, capture=None):
        out = upsample(self, x, ratio, capture)
        calls[0] += 1
        return out + 1e-3 if calls[0] % 5 == 0 else out

    with mock.patch.object(upsampler.Net, "upsample", last_altered):
        res = run(root, "tiny-eval")
    assert not res["correct"]
    assert res["checked"]["glue"]["value"] > 1e-4


def test_a_step_that_leaves_the_state_unchanged_fails(root):
    import threepu_torch.train.loop as loop_mod
    from threepu_torch.train.model import train_loss

    def no_update(net, opt, inp, gt, ratio, threshold=None,
                  weight_mode="floored", seed_idx=None, with_pred=False,
                  generator=None):
        opt.zero_grad(set_to_none=True)
        weighted, cd, pred, gt_out = train_loss(
            net, inp, gt, ratio, threshold, weight_mode, generator, seed_idx)
        weighted.backward()
        return (cd.detach(), (pred, gt_out)) if with_pred else cd.detach()

    with mock.patch.object(loop_mod, "train_step", no_update):
        res = run(root, "tiny-train")
    assert not res["correct"]
    assert res["checked"]["change1"]["value"] > 0.5


def test_half_of_the_batch_left_out_fails(root):
    import threepu_torch.train.loop as loop_mod
    step = loop_mod.train_step

    def half(net, opt, inp, gt, ratio, seed_idx=None, **kw):
        h = inp.shape[0] // 2
        return step(net, opt, inp[:h], gt[:h], ratio,
                    seed_idx=[s[:h] for s in seed_idx], **kw)

    with mock.patch.object(loop_mod, "train_step", half):
        assert not run(root, "tiny-train")["correct"]


def test_a_fault_that_starts_inside_the_window_fails(root):
    """The steps before the window are sound, the window's leave half of
    each batch out: the window's own step is checked."""
    import threepu_torch.train.loop as loop_mod
    from portbench.drivers import train as train_driver
    step, calls = loop_mod.train_step, [0]

    def half_later(net, opt, inp, gt, ratio, seed_idx=None, **kw):
        calls[0] += 1
        h = inp.shape[0] // 2 if calls[0] > train_driver.WARM_STEPS \
            else inp.shape[0]
        return step(net, opt, inp[:h], gt[:h], ratio,
                    seed_idx=[s[:h] for s in seed_idx], **kw)

    with mock.patch.object(loop_mod, "train_step", half_later):
        res = run(root, "tiny-train")
    assert not res["correct"]
    checked = res["checked"]
    assert all(checked[k]["value"] <= checked[k]["limit"]
               for k in ("batch", "decisions1", "loss1", "grad", "change1"))
    assert checked["window_loss"]["value"] > checked["window_loss"]["limit"]


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run as r, portbench.harness, portbench.control\n"
        "import portbench.drivers.eval, portbench.drivers.train\n"
        "import portbench.evalcheck, portbench.traincheck, portbench.readers\n"
        "import threepu_torch.inference, threepu_torch.train.loop\n"
        "import threepu_torch.parallel\n"
        "print(r.forbidden_modules())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_the_whole_name_check():
    import portbench.run as r
    with mock.patch.dict(sys.modules, {"threepu_torch_x": object()}):
        assert "threepu" not in r.forbidden_modules()
    with mock.patch.dict(sys.modules, {"threepu.models": object()}):
        assert r.forbidden_modules() == ["threepu"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "s2-eval-5k",
         "--seed", "9", "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
