"""What the per-layer readers (``portbench/metrics/<name>.py``) share.

A reader takes the run's context: ``unit`` (``"shape"`` or ``"step"``),
``spans`` (``{name: [ms, ...]}`` of the CUDA-event spans in the traced
window), ``profile`` (rank 0's profiled sub-window: ``busy_s``,
``window_s``, ``n_ops``, ``by_name`` seconds, ``gaps``) over
``units_profiled`` units, ``window_units`` and ``window_s`` of the
traced window, ``chips``, ``counts``, ``work`` (:mod:`portbench.work`'s
bounds and operations for one unit) and ``rules`` (the kernel map).  It
returns ``None`` where the run has nothing for it to read.
"""

from __future__ import annotations

from typing import Optional

from portbench import spec, work


def span_mean(ctx: dict, name: str) -> Optional[float]:
    xs = ctx.get("spans", {}).get(name)
    return sum(xs) / len(xs) if xs else None


def _profile(ctx: dict, unit: str):
    if ctx.get("unit") != unit:
        return None
    return ctx.get("profile")


def ops_per_unit(ctx: dict, unit: str) -> Optional[float]:
    p = _profile(ctx, unit)
    return None if p is None else p["n_ops"] / ctx["units_profiled"]


def op_seconds(ctx: dict, op: str) -> float:
    """Device seconds of the profiled operations mapped to ``op``."""
    return sum(s for name, s in ctx["profile"]["by_name"].items()
               if spec.operation_of(name, ctx["rules"]) == op)


def roofline(ctx: dict, op: str, unit: str) -> Optional[float]:
    """% of the operation's least time (its work per unit over the
    card's peaks) in the device time of its kernels."""
    p = _profile(ctx, unit)
    if p is None or op not in ctx["work"]:
        return None
    t = op_seconds(ctx, op)
    if t <= 0:
        return None
    return 100.0 * ctx["work"][op].seconds * ctx["units_profiled"] / t


def idle_share(ctx: dict, unit: str) -> Optional[float]:
    """% of a unit's wall time in which no device operation ran: the
    device's busy time a unit in the profiled sub-window, over the wall
    time a unit in the traced run's window, which the profiler does not
    stretch (recording the device's operations stretches the host's
    launches: a step-4 shape by about a quarter)."""
    p = _profile(ctx, unit)
    if p is None or not ctx.get("units_profiled") \
            or not ctx.get("window_units"):
        return None
    busy = p["busy_s"] / ctx["units_profiled"]
    wall = ctx["window_s"] / ctx["window_units"]
    return 100.0 * (1.0 - busy / wall)


def mfu(ctx: dict, unit: str) -> Optional[float]:
    """% of the chips' float32 peak that the layer equations' operations
    of the traced window's units fill over its wall time."""
    if ctx.get("unit") != unit or not ctx.get("window_units"):
        return None
    rate = ctx["work"]["flops"] * ctx["window_units"] / ctx["window_s"]
    return 100.0 * rate / (work.FP32_FLOPS * ctx["chips"])
