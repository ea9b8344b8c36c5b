"""The training driver: the program's ``train.train_loop``, resumed from
a checkpoint, on a training file of synthetic surfaces written at set-up
into the run's temporary directory.

One ``train_loop`` call spans set-up and window.  The harness hands the
loop's step function to a wrapper (a patch of the loop module's
``train_step``): the first :data:`CHECK_STEPS` steps record what the
check needs (their batches, losses and picks, the parameters and Adam
state around them); the window opens after :data:`WARM_STEPS` steps and
closes at the first step that ends ``seconds`` after it opened, when the
wrapper ends the loop.  One window step, drawn from the seed uniformly
over however many the window runs, records the same, with the program's
parameters and Adam state just before it.  A traced run counts host
syncs per step in its window, then profiles steps on the device for
:data:`PROFILE_SECONDS` and :data:`HOST_PROFILE_STEPS` more with the
host's operations.

How much is warmed, checked and profiled is the harness's, the same for
every cell, and no traffic mix sets it.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

from portbench import surface, trace, traincheck, weights

#: steps from the checkpoint that the check follows
CHECK_STEPS = traincheck.START_STEPS
#: steps run before the window opens
WARM_STEPS = 5
#: the traced run's device-only profile runs steps until this long
PROFILE_SECONDS = 3.0
#: steps then profiled with the host's operations (the idle gaps)
HOST_PROFILE_STEPS = 5


class WindowClosed(Exception):
    """Raised from the step wrapper to end the loop."""


def data_file(job: dict, folder: str) -> str:
    t = job["traffic"]
    res = t["resolutions"]
    path = os.path.join(folder, "train_" + "_".join(
        f"poisson_{r}" for r in sorted(res)) + ".npz")
    np.savez(path, **surface.training_file(job["seed"], t["shapes"], res))
    return path


@contextlib.contextmanager
def recorded_decisions(into: dict):
    """The program's picks in call order, by site: every k-smallest
    selection, the interlevel picks, the Chamfer argmins."""
    import threepu_torch.models.upsampler as up_mod
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.knn as knn_mod
    sites = {"select": (knn_mod, "exact_select", (1,)),
             "interlevel": (up_mod, "interlevel", (1,)),
             "chamfer": (ch_mod, "nn_both_ways", (1, 3))}
    with contextlib.ExitStack() as stack:
        for site, (mod, attr, at) in sites.items():
            into[site] = []

            def record(*a, _f=getattr(mod, attr), _s=site, _at=at):
                out = _f(*a)
                into[_s].extend(out[i].detach() for i in _at)
                return out
            stack.enter_context(mock.patch.object(mod, attr, record))
        yield


class StepProbe:
    """The wrapper around the loop's step function."""

    def __init__(self, job: dict, step_fn, start_step: int):
        self.job, self.step_fn = job, step_fn
        self.log_steps = job["traffic"]["log_steps"]
        self.start_step = start_step
        self.calls = 0
        self.rec = {"steps": [], "start_step": start_step, "window": None}
        self.keep = surface.Reservoir(job["seed"], 4, 1)
        self.t0 = self.t0_wall = self.t_end = None
        self.window_steps = 0
        self.syncs = []           # host syncs of each window call
        self.sync_mode = bool(job["trace"]) and job["device"] != "cpu"
        self.prof = None
        self.profile = None
        self.peak = 0
        self.marks = []

    @staticmethod
    def params(net, opt, key=None):
        out = {}
        for name, p in net.named_parameters():
            v = p if key is None else opt.state[p][key]
            out[traincheck.torch_to_path(name)] = \
                traincheck.as_kernel(name, v.detach()).clone()
        return out

    @staticmethod
    def state(net, opt) -> dict:
        """The parameters and Adam state before a step."""
        first = next(iter(net.parameters()))
        return dict(p0=StepProbe.params(net, opt),
                    m0=StepProbe.params(net, opt, "exp_avg"),
                    v0=StepProbe.params(net, opt, "exp_avg_sq"),
                    count0=int(float(opt.state[first]["step"])))

    def sync(self):
        if self.job["device"] != "cpu":
            torch.cuda.synchronize()

    def __call__(self, net, opt, inp, gt, ratio, **kw):
        n = self.calls
        if n == 0:
            self.rec["p0"] = self.params(net, opt)
            self.rec["m0"] = self.params(net, opt, "exp_avg")
        if n == WARM_STEPS:
            self.sync()
            if self.job["device"] != "cpu":
                torch.cuda.reset_peak_memory_stats()
            if self.sync_mode:
                torch.cuda.set_sync_debug_mode("warn")
            self.t0_wall, self.t0 = time.time(), time.perf_counter()
        in_window = self.t0 is not None and self.t_end is None
        if in_window:
            self.syncs.append(0)
        kept = in_window and self.keep.offer() is not None
        before = self.state(net, opt) if kept else None
        if n < CHECK_STEPS or kept:
            dec = {}
            with recorded_decisions(dec):
                out = self.step_fn(net, opt, inp, gt, ratio, **kw)
            st = dict(step=self.start_step + n, inp=inp, gt=gt,
                      seeds=list(kw["seed_idx"]), ratio=ratio,
                      threshold=kw.get("threshold"), decisions=dec,
                      loss=out[0] if kw.get("with_pred") else out)
            if n < CHECK_STEPS:
                self.rec["steps"].append(st)
            if kept:
                self.rec["window"] = dict(
                    st, **before, m1=self.params(net, opt, "exp_avg"),
                    p1=self.params(net, opt))
        else:
            out = self.step_fn(net, opt, inp, gt, ratio, **kw)
        self.calls += 1
        if n == 0:
            self.rec["m1"] = self.params(net, opt, "exp_avg")
            self.rec["p1"] = self.params(net, opt)
        if self.calls == CHECK_STEPS:
            self.rec["p_end"] = self.params(net, opt)
        if in_window:
            self.window_steps += 1
            now = time.perf_counter()
            if self.window_steps % 100 == 0:
                self.marks.append(now)
            if now - self.t0 >= self.job["seconds"]:
                self.close_window(inp.device)
        elif self.prof is not None and self.profile is None:
            if time.perf_counter() - self.prof[1] >= PROFILE_SECONDS:
                self.profile = trace.finish_profile(*self.prof)
                self.profile["units"] = self.calls - self.prof_start
                self.prof = trace.start_profile(host=True)
                self.prof_start = self.calls
        elif self.prof is not None and \
                self.calls - self.prof_start >= HOST_PROFILE_STEPS:
            self.profile["gaps"] = trace.finish_profile(*self.prof)["gaps"]
            self.prof = None
            raise WindowClosed
        return out

    def close_window(self, device):
        self.sync()
        self.t_end = time.perf_counter()
        marks = [self.t0] + self.marks
        print("portbench: ms a step by 100 steps (host clock, no sync): "
              + ", ".join(f"{(b - a) * 10:.2f}"
                          for a, b in zip(marks, marks[1:])),
              file=sys.stderr)
        if self.job["device"] != "cpu":
            self.peak = torch.cuda.max_memory_allocated()
        if self.sync_mode:
            torch.cuda.set_sync_debug_mode("default")
        if not self.job["trace"] or self.job["device"] == "cpu":
            raise WindowClosed
        trace.warm_profiler(device)
        self.prof = trace.start_profile()
        self.prof_start = self.calls

    def on_warning(self, message, *args, **kwargs):
        if "synchroniz" in str(message) and self.syncs:
            self.syncs[-1] += 1

    def non_log_syncs(self):
        """Mean host syncs of the window's steps that did not log."""
        first = self.start_step + WARM_STEPS     # global step before call
        xs = [s for i, s in enumerate(self.syncs)
              if (first + i + 1) % self.log_steps]
        return sum(xs) / len(xs) if xs else None


def train_config(job: dict, data_path: str, folder: str):
    from threepu_torch.train.loop import TrainConfig
    t, net = job["traffic"], job["config"]["net"]
    return TrainConfig(
        h5_data=data_path, num_shape_point=t["num_shape_point"],
        num_point=t["num_point"], batch_size=t["batch_size"],
        up_ratio=net["max_up_ratio"], step_ratio=net["step_ratio"],
        knn=net["knn"], growth_rate=net["growth_rate"],
        dense_n=net["dense_n"], fm_knn=net["fm_knn"],
        max_num_point=net["max_num_point"], lr_init=t["lr"],
        stage_steps=t["stage_steps"], ckpt=job["resume"],
        model_dir=os.path.join(folder, "model"), log_steps=t["log_steps"],
        seed=job["seed"])


def prepare(job: dict) -> dict:
    job = dict(job)
    job["resume"] = str(weights.checkpoint_path(job["config"]))
    with np.load(job["resume"]) as f:
        job["start_step"] = int(f["step"])
    return job


def run(job: dict) -> dict:
    import threepu_torch.train.loop as loop_mod

    job = prepare(job)
    folder = tempfile.mkdtemp(prefix="portbench-train-")
    try:
        data_path = data_file(job, folder)
        cfg = train_config(job, data_path, folder)
        probe = StepProbe(job, loop_mod.train_step, job["start_step"])
        with warnings.catch_warnings(), \
                mock.patch.object(loop_mod, "train_step", probe):
            warnings.simplefilter("always")
            warnings.showwarning = probe.on_warning
            try:
                loop_mod.train_loop(cfg, device=job["device"])
                raise RuntimeError("the loop ended before the window closed")
            except WindowClosed:
                pass
            finally:
                if probe.sync_mode:
                    torch.cuda.set_sync_debug_mode("default")
        kind = (torch.cuda.get_device_name() if job["device"] != "cpu"
                else "cpu")
        if job["device"] != "cpu":
            torch.cuda.empty_cache()
        readings = traincheck.check_or_fail(probe.rec, job, data_path,
                                            torch.device(job["device"]))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return dict(job=job, probe=probe, readings=readings, kind=kind)


def summary(job: dict, out: dict) -> dict:
    from portbench import work
    probe, job = out["probe"], out["job"]
    t, net = job["traffic"], job["config"]["net"]
    window_s = probe.t_end - probe.t0
    e2e = {"step_ms": 1e3 * window_s / probe.window_steps,
           "setup_s": probe.t0_wall - job["t_start"]}
    ratio = traincheck.curriculum(job["start_step"], t["stage_steps"],
                                  net["max_up_ratio"], net["step_ratio"],
                                  job["seed"])[0]
    tr = dict(t, ratio=ratio)
    ctx = dict(unit="step",
               units_profiled=probe.profile["units"] if probe.profile else 0,
               window_units=probe.window_steps, window_s=window_s, chips=1,
               spans={}, counts={"host_syncs_per_step":
                                 probe.non_log_syncs()},
               profile=probe.profile,
               profiles=[probe.profile] if probe.profile else [],
               work=dict(select=work.total(work.train_select_bounds(net, tr)),
                         flops=work.train_step_flops(
                             net, t["batch_size"], t["num_point"], ratio)))
    return dict(e2e=e2e, ctx=ctx, readings=out["readings"],
                attempted=probe.window_steps,
                missing=int(probe.rec["window"] is None), kind=out["kind"],
                count=1, peak=probe.peak,
                checked=len(probe.rec["steps"])
                + (probe.rec["window"] is not None))


def control(job: dict, tf32: bool = True, fault: str = "") -> dict:
    """The check's readings with the reference's own steps in the
    program's place (TF32 products where ``tf32``; with ``fault="half"``
    each step on half its batch)."""
    job = prepare(job)
    dev = torch.device(job["device"])
    folder = tempfile.mkdtemp(prefix="portbench-train-")
    try:
        path = data_file(job, folder)
        rec = traincheck.control_rec(job, path, dev, tf32, fault,
                                     window_step=WARM_STEPS)
        return traincheck.check_or_fail(rec, job, path, dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
