"""The PU-GAN eval driver: a closed loop of whole shapes through the
program's ``inference.upsample_shape`` on a ``PUGAN`` built by
``models.load_net(arch="pugan")``, one shape at a time, from a pool of
synthetic surfaces made from the seed.

The window, warm-up, kept shapes, profiling and end-to-end numbers are
those of :mod:`portbench.drivers.punet_eval` (and so of
:mod:`portbench.drivers.eval`); the kept shapes are checked afterwards by
:mod:`portbench.pugancheck`, every chunk of each.

The weights are made from the seed under the published scopes:
Xavier-uniform kernels and zero biases, as the published layers
initialize, and each attention unit's ``gamma`` drawn from
``[0.5, 1.5)`` (published: 0 at the start, which would leave the
attention dead arithmetic).  The same tensors go to the program and to
the reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import evalcheck, pugancheck, reference as R
from portbench import reference_pugan as RG
from portbench import surface, trace, work, work_pugan
from portbench.drivers.eval import (CHECK_SHAPES, HOST_PROFILE_SHAPES,
                                    PROFILE_SECONDS, WARM_SHAPES,
                                    control_shapes)
from portbench.drivers.punet_eval import Recorder

#: the range each ``gamma`` is drawn from
GAMMA_RANGE = (0.5, 1.5)


def seeded(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{"<scope>/kernel": (in, out), "<scope>/bias": (out,),
    "<up block>/attention_unit/gamma": (1,)}`` drawn on ``device`` in one
    call from a generator seeded with ``seed``."""
    shapes = RG.param_shapes(net)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    names = RG.gammas()
    u = torch.rand(sum(a * b for _, (a, b) in shapes) + len(names),
                   generator=gen, device=device)
    flat, at = {}, 0
    for path, (a, b) in shapes:
        bound = math.sqrt(6.0 / (a + b))
        flat[f"{path}/kernel"] = (u[at:at + a * b].view(a, b) * 2 - 1) * bound
        flat[f"{path}/bias"] = torch.zeros(b, device=device)
        at += a * b
    lo, hi = GAMMA_RANGE
    for i, name in enumerate(names):
        flat[name] = lo + (hi - lo) * u[at + i:at + i + 1]
    return flat


def params_of(flat: Dict[str, torch.Tensor]) -> R.Params:
    """The reference's parameters: ``{path: (kernel, bias)}``, each
    ``gamma`` as ``(gamma, None)``."""
    params = R.pairs_of(flat)
    params.update({name: (flat[name], None) for name in RG.gammas()})
    return params


def eval_net(job: dict, device):
    """``(the program's PUGAN on device in eval mode, the reference's
    parameters)``."""
    from threepu_torch.models import load_net

    cfg = job["config"]
    if cfg["weights"] != "seed":
        raise ValueError("the PU-GAN cell runs seeded weights only")
    net_cfg = cfg["net"]
    net = load_net(None, device, arch="pugan",
                   num_point=net_cfg["num_point"],
                   up_ratio=net_cfg["up_ratio"])
    flat = seeded(net_cfg, job["seed"], device)
    state = {}
    for name, p in net.state_dict().items():
        scope, leaf = name.rsplit(".", 1)
        path = scope.replace(".", "/")
        if leaf == "gamma":
            state[name] = flat[f"{path}/gamma"]
        elif leaf == "bias":
            state[name] = flat[f"{path}/bias"]
        elif p.dim() == 4 and p.shape[-1] > 1:
            # a kernel over the copies, rows copy-major: (r' in, out)
            state[name] = flat[f"{path}/kernel"].reshape(
                p.shape[-1], p.shape[1], p.shape[0]).permute(2, 1, 0)[
                    :, :, None, :]
        else:
            state[name] = flat[f"{path}/kernel"].t().reshape(p.shape)
    net.load_state_dict(state, strict=True)
    return net.eval(), params_of(flat)


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

        # the profiler's start-up outside the measured sub-window, over a
        # whole shape, as in the PU-Net driver
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
    readings = [pugancheck.check_or_fail(R.Arith(), params,
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
        raise ValueError("the PU-GAN cell runs on one card")
    return shape_loop(job)


def per_unit_work(job: dict) -> dict:
    """The work one shape needs, for the readers."""
    net, t = job["config"]["net"], job["traffic"]
    return dict(attention=work_pugan.attention_bound(net, t),
                fps=work.total(work_pugan.fps_bounds(net, t)),
                flops=work_pugan.shape_flops(net, t))


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
        raise ValueError(f"no fault {fault!r} for the PU-GAN cell's control")
    t, net = job["traffic"], job["config"]["net"]
    dev = torch.device(job["device"])
    params = params_of(seeded(net, job["seed"], dev))
    pool = surface.pool(job["seed"], t["pool"], t["points"])
    out = []
    for s in control_shapes(job):
        rec = pugancheck.reference_run(R.Arith(tf32=tf32), params, net, t,
                                       pool[s], dev)
        out.append(pugancheck.check_shape(R.Arith(), params, net, t,
                                          pool[s], rec))
    return evalcheck.worst(out)
