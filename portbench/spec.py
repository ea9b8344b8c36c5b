"""Finds what ``BENCHMARK.json`` names, by name, in files of their own.

- a cell: an entry of ``workloads`` in ``BENCHMARK.json``;
- a configuration: ``configs[].file`` (the sizes of a net and its weights);
- a traffic mix: ``portbench/traffic/<name>.json``, whose ``kind`` names
  the driver module ``portbench.drivers.<kind>`` that runs it;
- the limits of a cell's correctness check: ``portbench/limits/<cell>.json``;
- a per-layer metric: the reader ``portbench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the number or ``None``;
- the kernel-to-operation map: every ``portbench/kernel_map/*.json``.

A later change adds a cell, a mix, a metric or a kernel mapping by adding
files and entries; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _data(folder: str, name: str, root: Path) -> dict:
    path = Path(root) / "portbench" / folder / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _data("traffic", _name("traffic", name), root)


def limits(workload: str, root: Path = ROOT) -> dict:
    """``{number: limit}`` of the cell's correctness check."""
    return _data("limits", _name("workload", workload), root)


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    path = Path(root) / "portbench" / "metrics" / f"{_name('metric', name)}.py"
    return _module(path, "portbench_metric_" + re.sub(r"\W", "_", name)).read


def kernel_map(root: Path = ROOT) -> List[List[str]]:
    """``[[substring of a kernel's name, operation], ...]`` from every
    mapping file, in file-name order; the first match of a name wins."""
    rules: List[List[str]] = []
    folder = Path(root) / "portbench" / "kernel_map"
    for path in sorted(folder.glob("*.json")):
        with open(path) as f:
            rules.extend([str(k), str(v)] for k, v in json.load(f)["map"])
    return rules


def operation_of(kernel: str, rules: List[List[str]]) -> Optional[str]:
    low = kernel.lower()
    for key, op in rules:
        if key.lower() in low:
            return op
    return None


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in a cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench: dict, workload: str) -> Dict[str, List[dict]]:
    return {key: [m for m in bench[key] if applies(m, workload)]
            for key in ("end_to_end", "per_layer")}
