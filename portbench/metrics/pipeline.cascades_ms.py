"""Median device ms a shape of all its chunks' cascades, end to end: the
program's ``cascades`` span, from the fork of the chunks' streams to their
join (the profiled sub-window); ``None`` where the program keeps no such
span (a shape without one would read 0)."""

from portbench import program_spans


def cascades(name: str) -> bool:
    return name == "cascades"


def read(ctx):
    if not any(cascades(r["name"]) for r in program_spans.records()):
        return None
    return program_spans.shape_median(ctx, cascades, program_spans.device_ms)
