"""The eval driver: a closed loop of whole shapes through the program's
``inference.upsample_shape``, one shape at a time, from a pool of
synthetic surfaces made from the seed; with ``world_size`` > 1 the same
loop on every rank of a mesh started by ``parallel.launch.spawn``, one
rank a card.

Set-up builds the net, makes the pool and runs :data:`WARM_SHAPES`
shapes.  The window then runs shapes until ``seconds`` have passed; a
shape's latency is the host clock around its call, which ends with the
result on the host.  While it runs, :data:`CHECK_SHAPES` of its shapes,
drawn from the seed uniformly over however many it runs, keep what the
check needs.  A traced run records CUDA-event spans (the cascade's
chunks, the re-stitch, the all-gather) in its window, then profiles
shapes on the device for :data:`PROFILE_SECONDS`, and
:data:`HOST_PROFILE_SHAPES` more with the host's operations, which name
the device's idle gaps.  Afterwards the kept shapes are checked against
the reference (:mod:`portbench.evalcheck`), every chunk of each.

How much is warmed, checked and profiled is the harness's, the same for
every cell, and no traffic mix sets it.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from contextlib import ExitStack
from typing import Optional
from unittest import mock

import numpy as np
import torch

from portbench import evalcheck, reference as R, surface, trace, weights

#: shapes run at set-up, before the window
WARM_SHAPES = 2
#: window shapes checked, every chunk of each
CHECK_SHAPES = 2
#: the traced run's device-only profile runs shapes until this long
PROFILE_SECONDS = 3.0
#: shapes then profiled with the host's operations (the idle gaps)
HOST_PROFILE_SHAPES = 1


class Probe:
    """Wrappers the harness installs on the net it built (and its mesh):
    for a kept shape, every chunk's input, output and level calls and the
    all-gather's result; with ``spans``, CUDA events around each chunk
    and all-gather."""

    def __init__(self, net, mesh, spans: Optional[trace.Spans]):
        self.rec = None
        upsample = net.upsample

        def chunk(x, ratio=None, capture=None):
            rec = self.rec
            if rec is not None:
                rec["levels"].append([])
            if spans is not None:
                spans.open("cascade")
            out = upsample(x, ratio, capture)
            if spans is not None:
                spans.close("cascade")
            if rec is not None:
                rec["chunks"].append((x, out))
            return out

        net.upsample = chunk
        for name, lvl in net.levels.items():
            forward = lvl.forward
            l = int(name.split("_")[-1])

            def level(*args, _forward=forward, _l=l, **kw):
                out = _forward(*args, **kw)
                rec = self.rec
                if rec is not None and rec["levels"]:
                    rec["levels"][-1].append((_l, args, {
                        k: kw[k] for k in ("prev_group", "prev_dup")
                        if k in kw}, out))
                return out

            lvl.forward = level
        if mesh is not None:
            gather = mesh.all_gather

            def all_gather(out, x):
                if spans is not None:
                    spans.open("allgather")
                res = gather(out, x)
                if spans is not None:
                    spans.close("allgather")
                if self.rec is not None:
                    self.rec["gathered"] = res
                return res

            mesh.all_gather = all_gather


def restitch_spans(spans: trace.Spans):
    """Patches of the pipeline module's re-stitch FPS and its gather, so
    that one span covers both (a traced run only)."""
    import threepu_torch.inference as inf
    fps_h, gather = inf.fps_hierarchical, inf.gather_nd

    def fps_hierarchical(*a, **kw):
        spans.open("restitch")
        return fps_h(*a, **kw)

    def gather_nd(*a, **kw):
        out = gather(*a, **kw)
        if spans.is_open("restitch"):
            spans.close("restitch")
        return out

    return [mock.patch.object(inf, "fps_hierarchical", fps_hierarchical),
            mock.patch.object(inf, "gather_nd", gather_nd)]


def control_shapes(job: dict) -> list:
    """The pool's shapes that the control checks, drawn from the seed."""
    rng = surface.rng_for(job["seed"], 3)
    return sorted(int(i) for i in rng.choice(job["traffic"]["pool"],
                                             CHECK_SHAPES, replace=False))


def shape_loop(job: dict, mesh=None) -> dict:
    """Set-up, window, trace and check on this process's card (or the
    job's device); returns this rank's results."""
    from threepu_torch.inference import upsample_shape

    t = job["traffic"]
    world = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    dev = mesh.device if mesh is not None else torch.device(job["device"])
    net, ref_params = weights.eval_net(job, dev)
    pool = surface.pool(job["seed"], t["pool"], t["points"])
    spans = trace.Spans() if job["trace"] and dev.type == "cuda" else None
    probe = Probe(net, mesh, spans)
    kwargs = dict(num_point=t["num_point"],
                  patch_num_ratio=t["patch_num_ratio"], chunk=t["chunk"],
                  mesh=mesh)

    def run_shape(i: int):
        return upsample_shape(net, pool[i % len(pool)], t["ratio"], **kwargs)

    def stop(flag: bool) -> bool:
        if mesh is None:
            return flag
        # every rank leaves the window after the same shape
        f = torch.tensor([int(flag)], device=dev)
        torch.distributed.all_reduce(f, op=torch.distributed.ReduceOp.MAX)
        return bool(f.item())

    with ExitStack() as stack:
        if spans is not None:
            for p in restitch_spans(spans):
                stack.enter_context(p)
        for i in range(WARM_SHAPES):
            run_shape(-1 - i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if mesh is not None:
            torch.distributed.barrier()
        if spans is not None:
            spans.events.clear()
        keep = surface.Reservoir(job["seed"], 2, CHECK_SHAPES)
        records, lat = {}, []
        t0_wall, t0 = time.time(), time.perf_counter()
        i = 0
        while True:
            slot = keep.offer()
            rec = None
            if slot is not None:
                rec = dict(chunks=[], levels=[], gathered=None)
            probe.rec = rec
            s = time.perf_counter()
            _, up = run_shape(i)
            e = time.perf_counter()
            probe.rec = None
            if rec is not None:
                rec["output"] = up
                records[slot] = (i, rec)
            lat.append(e - s)
            i += 1
            if stop(e - t0 >= job["seconds"]):
                break
        window_s = time.perf_counter() - t0
        span_ms = spans.ms() if spans is not None else {}
        prof = None
        if job["trace"] and dev.type == "cuda":
            n_prof = [0]

            def profiled_shapes():
                t_p = time.perf_counter()
                while True:
                    run_shape(i + n_prof[0])
                    n_prof[0] += 1
                    if stop(time.perf_counter() - t_p >= PROFILE_SECONDS):
                        break

            trace.warm_profiler(dev)
            prof = trace.profiled(profiled_shapes)
            prof["units"] = n_prof[0]
            prof["gaps"] = trace.profiled(
                lambda: [run_shape(i + n_prof[0] + j)
                         for j in range(HOST_PROFILE_SHAPES)],
                host=True)["gaps"]
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    del net, probe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    A = R.Arith()
    spec = R.NetSpec(**job["config"]["net"])
    t_check = time.perf_counter()
    readings = [evalcheck.check_or_fail(A, ref_params, spec, t,
                                        pool[s % len(pool)], rec, rank, world)
                for s, rec in records.values()]
    print(f"portbench: rank {rank} checked window shapes "
          f"{sorted(s for s, _ in records.values())} of {i}, every chunk, "
          f"in {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    missing = CHECK_SHAPES - len(records)
    return dict(rank=rank, kind=kind, t0_wall=t0_wall, window_s=window_s,
                shapes=i, latencies=lat, span_ms=span_ms, profile=prof,
                peak=peak, readings=evalcheck.worst(readings),
                missing=missing, checked=len(readings))


def rank_main(mesh, job: dict) -> dict:
    """One rank of a mesh job: what :func:`shape_loop` returns, plain
    numbers and arrays (nothing crosses as a tensor)."""
    res = shape_loop(job, mesh)
    if res["profile"] is not None:
        res["profile"] = dict(res["profile"])
    return res


def run(job: dict) -> dict:
    """Runs the cell; returns ``rank_results`` (rank 0 first)."""
    world = job["traffic"].get("world_size", 1)
    if world == 1:
        return dict(ranks=[shape_loop(job)])
    from threepu_torch.parallel.launch import spawn
    # NCCL reaches the other cards over NVLink; its shared-memory
    # transport would leave segments under /dev/shm
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    return dict(ranks=spawn(rank_main, world, job,
                            device="cpu" if job["device"] == "cpu" else None))


def per_unit_work(job: dict) -> dict:
    """The work one shape needs on one rank, for the readers."""
    from portbench import work
    net, t = job["config"]["net"], job["traffic"]
    world = t.get("world_size", 1)
    return dict(fps=work.total(work.eval_fps_bounds(net, t, world)),
                select=work.total(work.eval_select_bounds(net, t, world)),
                flops=work.eval_shape_flops(net, t, world))


def summary(job: dict, out: dict) -> dict:
    """End-to-end numbers, the readers' context and the check."""
    ranks = out["ranks"]
    r0 = ranks[0]
    lat = r0["latencies"]
    e2e = {"shape_s": r0["window_s"] / r0["shapes"],
           "shape_p90_s": float(np.quantile(lat, 0.9, method="linear")),
           "setup_s": r0["t0_wall"] - job["t_start"]}
    profiles = [r["profile"] for r in ranks if r.get("profile")]
    readings = evalcheck.worst([r["readings"] for r in ranks])
    missing = sum(r["missing"] for r in ranks)
    ctx = dict(unit="shape",
               units_profiled=profiles[0]["units"] if profiles else 0,
               window_units=r0["shapes"], window_s=r0["window_s"],
               chips=len(ranks), spans=r0["span_ms"],
               profile=profiles[0] if profiles else None,
               profiles=profiles, work=per_unit_work(job))
    return dict(e2e=e2e, ctx=ctx, readings=readings,
                attempted=r0["shapes"],
                missing=missing, kind=r0["kind"], count=len(ranks),
                peak=max(r["peak"] for r in ranks),
                checked=sum(r["checked"] for r in ranks))


def control(job: dict, tf32: bool = True, fault: str = "") -> dict:
    """The check's readings with the reference in the program's place
    (TF32 products where ``tf32``) on :func:`control_shapes`, every chunk
    of each at rank 0 of the cell's layout (no planted faults here: the
    runs' tests plant them in the program)."""
    if fault:
        raise ValueError(f"no fault {fault!r} for an eval cell's control")
    t = job["traffic"]
    world = t.get("world_size", 1)
    dev = torch.device(job["device"])
    params = weights.reference_params(job, dev)
    pool = surface.pool(job["seed"], t["pool"], t["points"])
    spec = R.NetSpec(**job["config"]["net"])
    out = []
    for s in control_shapes(job):
        rec = evalcheck.reference_run(R.Arith(tf32=tf32), params, spec, t,
                                      pool[s], dev, 0, world)
        out.append(evalcheck.check_shape(R.Arith(), params, spec, t,
                                         pool[s], rec, 0, world))
    return evalcheck.worst(out)
