"""One run of one cell: the job from ``BENCHMARK.json`` and the files it
names, the driver of the cell's traffic kind, the metrics, the check
against the limits, and the result line.

:func:`run_cell` takes a device: ``run.py`` gives it the card and
refuses to run without one; the tests give it the CPU at tiny sizes.
"""

from __future__ import annotations

import importlib
import math
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from portbench import spec


def power_limit() -> str:
    """The cards' ``power.limit`` as ``nvidia-smi`` reads it."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e.__class__.__name__})"
    return ", ".join(res.stdout.split("\n")[:-1]) or "unread"


def make_job(bench: dict, workload: str, seed: int, seconds: float,
             trace: int, device: str, t_start: float,
             root: Path = spec.ROOT) -> dict:
    cell = spec.cell(bench, workload)
    return dict(workload=workload, seed=int(seed), seconds=float(seconds),
                trace=int(trace), device=device, t_start=t_start,
                chips=cell["chips"],
                config=spec.config(bench, cell["config"], root),
                traffic=spec.traffic(cell["traffic"], root),
                limits=spec.limits(workload, root))


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: int, device: str, t_start: float,
             root: Path = spec.ROOT) -> Tuple[dict, List[str]]:
    """``(result line, check lines)`` of one run."""
    job = make_job(bench, workload, seed, seconds, trace, device, t_start,
                   root)
    kind = job["traffic"]["kind"]
    drv = importlib.import_module(f"portbench.drivers.{kind}")
    out = drv.summary(job, drv.run(job))
    wanted = spec.cell_metrics(bench, workload)
    metrics: Dict[str, dict] = {}
    if trace:
        ctx = dict(out["ctx"], rules=spec.kernel_map(root))
        for m in wanted["per_layer"]:
            value = spec.metric_reader(m["name"], root)(ctx)
            if value is not None:
                if m["unit"] == "%" and not 0.0 <= value <= 105.0:
                    raise ValueError(f"{m['name']} reads {value}%: its work "
                                     "or its time is counted wrong")
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    limits = job["limits"]
    readings = out["readings"]
    # a reading that could not be taken (a shape that differs) reads 1e30
    checked = {k: [min(float(readings.get(k, math.inf)), 1e30), v]
               for k, v in limits.items()}
    correct = (out["checked"] > 0 and out["missing"] == 0
               and all(r <= lim for r, lim in checked.values()))
    device = {"platform": "gpu" if device != "cpu" else "cpu",
              "kind": out["kind"], "count": out["count"],
              "memory_peak_bytes": int(out["peak"]),
              "power_limit": power_limit() if device != "cpu" else "none"}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": 0, "metrics": metrics, "device": device}
    profiles = out["ctx"].get("profiles") or []
    if trace and profiles:
        device["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
        device["window_s"] = sum(p["window_s"]
                                 for p in profiles) / len(profiles)
        p0 = profiles[0]
        from portbench.trace import top
        result["breakdown"] = {"device_ops": top(p0["by_name"]),
                               "idle_gaps": top(p0["gaps"])}
    result["checked"] = {k: {"value": r, "limit": lim}
                         for k, (r, lim) in checked.items()}
    lines = [f"checked {k}: {r!r} (limit {lim!r})"
             for k, (r, lim) in checked.items()]
    lines.append("readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                          sorted(readings.items())))
    lines.append(f"checked shapes or steps: {out['checked']}, not reached: "
                 f"{out['missing']}, correct: {correct}")
    return result, lines
