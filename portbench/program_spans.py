"""What the readers of the program's own spans share.

``threepu_torch.utils.profiling`` keeps a span's record while a profiler
records, so in a traced run the records are those of the profiled
sub-window: the device-only profile's shapes and the one shape profiled
with the host's operations.  A reader sums the named spans of each shape
(the spans under one ``shape`` root) and takes the median over the
shapes, which puts the host-profiled one aside.  Where the program keeps
no spans (an older program, a CPU run, the parent process of a mesh) it
reads ``None``.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional


def records() -> List[dict]:
    """The program's finished spans in this process, or ``[]`` where it
    keeps none."""
    try:
        from threepu_torch.utils import profiling
    except ImportError:
        return []
    finished = getattr(profiling, "finished_spans", None)
    return finished() if finished is not None else []


def device_ms(rec: dict) -> Optional[float]:
    s, e = rec["device_start_ms"], rec["device_end_ms"]
    return None if s is None or e is None else e - s


def host_ms(rec: dict) -> float:
    return (rec["host_end_ns"] - rec["host_start_ns"]) / 1e6


def shape_median(ctx: dict, wanted: Callable[[str], bool],
                 value: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The median over shapes of the sum of ``value`` over the spans
    whose name is ``wanted``; a shape where a wanted span has no value
    is left out."""
    if ctx.get("unit") != "shape":
        return None
    recs = records()
    sums = {r["id"]: 0.0 for r in recs
            if r["name"] == "shape" and r["parent"] is None}
    for r in recs:
        if r["shape"] in sums and wanted(r["name"]):
            v = value(r)
            if v is None:
                del sums[r["shape"]]
            else:
                sums[r["shape"]] += v
    return statistics.median(sums.values()) if sums else None
