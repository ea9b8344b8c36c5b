"""The PU-Net eval driver: a closed loop of whole shapes through the
program's ``inference.upsample_shape`` on a ``PUNet`` built by
``models.load_net(arch="punet")``, one shape at a time, from a pool of
synthetic surfaces made from the seed.

The window, warm-up, kept shapes, profiling and end-to-end numbers are
those of :mod:`portbench.drivers.eval`: set-up runs ``WARM_SHAPES``
shapes, the window runs shapes until ``seconds`` have passed (a shape's
latency is the host clock around its call, which ends with the result on
the host), ``CHECK_SHAPES`` window shapes drawn from the seed keep every
chunk's input, output and ``PUNet.upsample`` capture, and a traced run
then profiles shapes on the device for ``PROFILE_SECONDS`` and
``HOST_PROFILE_SHAPES`` more with the host's operations.  The kept shapes
are checked afterwards (:mod:`portbench.punetcheck`).

The weights are made from the seed (Xavier-uniform kernels, zero biases,
as the published layers initialize) under the published scopes, and the
same tensors go to the program and to the reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import evalcheck, punetcheck, reference as R
from portbench import reference_punet as RP
from portbench import surface, trace, work, work_punet
from portbench.drivers.eval import (CHECK_SHAPES, HOST_PROFILE_SHAPES,
                                    PROFILE_SECONDS, WARM_SHAPES,
                                    control_shapes)


def seeded(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{"<scope>/kernel": (in, out), "<scope>/bias": (out,)}`` drawn on
    ``device`` in one call from a generator seeded with ``seed``."""
    shapes = RP.param_shapes(net)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(sum(a * b for _, (a, b) in shapes), generator=gen,
                   device=device)
    flat, at = {}, 0
    for path, (a, b) in shapes:
        bound = math.sqrt(6.0 / (a + b))
        flat[f"{path}/kernel"] = (u[at:at + a * b].view(a, b) * 2 - 1) * bound
        flat[f"{path}/bias"] = torch.zeros(b, device=device)
        at += a * b
    return flat


def eval_net(job: dict, device):
    """``(the program's PUNet on device in eval mode, the reference's
    parameters)``."""
    from threepu_torch.models import load_net

    cfg = job["config"]
    if cfg["weights"] != "seed":
        raise ValueError("the PU-Net cell runs seeded weights only")
    net = load_net(None, device, arch="punet",
                   num_point=cfg["net"]["num_point"],
                   up_ratio=cfg["net"]["up_ratio"])
    flat = seeded(cfg["net"], job["seed"], device)
    state = {}
    for name, p in net.state_dict().items():
        scope, leaf = name.rsplit(".", 1)
        path = scope.replace(".", "/")
        state[name] = (flat[f"{path}/kernel"].t().reshape(p.shape)
                       if leaf == "weight" else flat[f"{path}/bias"])
    net.load_state_dict(state, strict=True)
    return net.eval(), R.pairs_of(flat)


class Recorder:
    """Wraps the net's ``upsample``: for a kept shape (``rec`` set), every
    chunk's input, output and capture."""

    def __init__(self, net):
        self.rec = None
        upsample = net.upsample

        def chunk(x, ratio=None, capture=None):
            if self.rec is None:
                return upsample(x, ratio, capture)
            capture = {} if capture is None else capture
            out = upsample(x, ratio, capture)
            self.rec["chunks"].append((x, out, capture))
            return out

        net.upsample = chunk


def shape_loop(job: dict) -> dict:
    """Set-up, window, trace and check on the job's device."""
    from threepu_torch.inference import upsample_shape
    from threepu_torch.utils.profiling import clear_spans

    t = job["traffic"]
    dev = torch.device(job["device"])
    net, params = eval_net(job, dev)
    pool = surface.pool(job["seed"], t["pool"], t["points"])
    recorder = Recorder(net)
    kwargs = dict(num_point=t["num_point"],
                  patch_num_ratio=t["patch_num_ratio"], chunk=t["chunk"])

    def run_shape(i: int):
        return upsample_shape(net, pool[i % len(pool)], t["ratio"], **kwargs)

    for i in range(WARM_SHAPES):
        run_shape(-1 - i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    keep = surface.Reservoir(job["seed"], 2, CHECK_SHAPES)
    records, lat = {}, []
    t0_wall, t0 = time.time(), time.perf_counter()
    i = 0
    while True:
        slot = keep.offer()
        recorder.rec = None if slot is None else dict(chunks=[])
        s = time.perf_counter()
        _, up = run_shape(i)
        e = time.perf_counter()
        if slot is not None:
            recorder.rec["output"] = up
            records[slot] = (i, recorder.rec)
        recorder.rec = None
        lat.append(e - s)
        i += 1
        if e - t0 >= job["seconds"]:
            break
    window_s = time.perf_counter() - t0
    prof = None
    if job["trace"] and dev.type == "cuda":
        n_prof = [0]

        def profiled_shapes():
            t_p = time.perf_counter()
            while time.perf_counter() - t_p < PROFILE_SECONDS:
                run_shape(i + n_prof[0])
                n_prof[0] += 1

        # the profiler's start-up (CUPTI's) outside the measured
        # sub-window, over a whole shape: a lone small operation was seen
        # to go unrecorded in this process, which trace.profiled refuses
        trace.profiled(lambda: run_shape(i))
        clear_spans()
        prof = trace.profiled(profiled_shapes)
        prof["units"] = n_prof[0]
        prof["gaps"] = trace.profiled(
            lambda: [run_shape(i + n_prof[0] + j)
                     for j in range(HOST_PROFILE_SHAPES)], host=True)["gaps"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    del net, recorder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings = [punetcheck.check_or_fail(R.Arith(), params,
                                         job["config"]["net"], t,
                                         pool[s % len(pool)], rec)
                for s, rec in records.values()]
    print(f"portbench: checked window shapes "
          f"{sorted(s for s, _ in records.values())} of {i}, every chunk, "
          f"in {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    return dict(kind=kind, t0_wall=t0_wall, window_s=window_s, shapes=i,
                latencies=lat, profile=prof, peak=peak,
                readings=evalcheck.worst(readings),
                missing=CHECK_SHAPES - len(records), checked=len(readings))


def run(job: dict) -> dict:
    if job["traffic"].get("world_size", 1) != 1:
        raise ValueError("the PU-Net cell runs on one card")
    return shape_loop(job)


def per_unit_work(job: dict) -> dict:
    """The work one shape needs, for the readers."""
    net, t = job["config"]["net"], job["traffic"]
    return dict(fps=work.total(work_punet.fps_bounds(net, t)),
                flops=work_punet.shape_flops(net, t))


def summary(job: dict, out: dict) -> dict:
    """End-to-end numbers, the readers' context and the check."""
    lat = out["latencies"]
    e2e = {"shape_s": out["window_s"] / out["shapes"],
           "shape_p90_s": float(np.quantile(lat, 0.9, method="linear")),
           "setup_s": out["t0_wall"] - job["t_start"]}
    prof = out["profile"]
    ctx = dict(unit="shape", units_profiled=prof["units"] if prof else 0,
               window_units=out["shapes"], window_s=out["window_s"],
               chips=1, spans={}, profile=prof,
               profiles=[prof] if prof else [], work=per_unit_work(job))
    return dict(e2e=e2e, ctx=ctx, readings=out["readings"],
                attempted=out["shapes"], missing=out["missing"],
                kind=out["kind"], count=1, peak=out["peak"],
                checked=out["checked"])


def control(job: dict, tf32: bool = True, fault: str = "") -> dict:
    """The check's readings with the reference in the program's place
    (TF32 products where ``tf32``) on the eval driver's control shapes,
    every chunk of each."""
    if fault:
        raise ValueError(f"no fault {fault!r} for the PU-Net cell's control")
    t, net = job["traffic"], job["config"]["net"]
    dev = torch.device(job["device"])
    params = R.pairs_of(seeded(net, job["seed"], dev))
    pool = surface.pool(job["seed"], t["pool"], t["points"])
    out = []
    for s in control_shapes(job):
        rec = punetcheck.reference_run(R.Arith(tf32=tf32), params, net, t,
                                       pool[s], dev)
        out.append(punetcheck.check_shape(R.Arith(), params, net, t,
                                          pool[s], rec))
    return evalcheck.worst(out)
