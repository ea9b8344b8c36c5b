"""A checkout in a temporary folder whose ``BENCHMARK.json`` holds tiny
cells, for running the harness on the CPU in the tests: the real
metric readers and kernel map, tiny configurations, mixes and limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import spec

NET = {"max_up_ratio": 4, "step_ratio": 2, "knn": 8, "growth_rate": 12,
       "dense_n": 3, "max_num_point": 32, "fm_knn": 5}
EVAL = {"kind": "eval", "pool": 3, "points": 200, "ratio": 4,
        "num_point": 32, "patch_num_ratio": 3, "chunk": 4, "world_size": 1}
EVAL_LIMITS = {"start": 0.0, "glue": 0.0, "level_rows": 0.001,
               "restitch": 0.0}


TRAIN = {"kind": "train", "shapes": 4, "resolutions": [200, 400, 800],
         "num_shape_point": 200, "num_point": 32, "batch_size": 4,
         "lr": 5e-4, "stage_steps": 100, "log_steps": 5}
TRAIN_LIMITS = {"batch": 0.0, "decisions1": 0.001, "loss1": 1e-5,
                "grad": 1e-3, "change1": 1e-3, "change_median": 1e-3,
                "window_batch": 0.0, "window_decisions": 0.001,
                "window_loss": 1e-5, "window_grad": 1e-3,
                "window_change": 1e-3}
#: the training cell's metrics, which no cell of ``BENCHMARK.json``
#: reports yet
TRAIN_METRICS = {
    "end_to_end": [{"name": "step_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock"}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": "train", "moves": "step_ms"}
        for n, u, b in (("train_step.device_ops", "count", "lower"),
                        ("train_loop.host_syncs", "count", "lower"),
                        ("select_roofline.train", "%", "higher"),
                        ("device.idle_share.train", "%", "lower"),
                        ("mfu.train", "%", "higher"))]}


def tiny_checkpoint(path: Path, step: int = 100) -> str:
    """A full-state checkpoint of the tiny net at ``step`` (fresh
    weights, zero Adam moments), written by the program."""
    import torch
    from threepu_torch.io import save_train_checkpoint
    from threepu_torch.models import Net
    from threepu_torch.train import make_optimizer
    torch.manual_seed(0)
    net = Net(**NET)
    save_train_checkpoint(str(path), net, make_optimizer(net.parameters()),
                          step=step)
    return str(path)


def train_cell(tmp: Path):
    """``(cell, config, traffic, limits)`` of ``tiny-train``."""
    ckpt = tiny_checkpoint(Path(tmp) / "tiny_ckpt.npz")
    return ("tiny-train", {"name": "tiny-trained", "net": NET,
                           "weights": ckpt}, dict(TRAIN), dict(TRAIN_LIMITS))


def checkout(tmp: Path, extra_cells=()) -> Path:
    """A root with the cell ``tiny-eval`` (and ``extra_cells``: ``(cell,
    config dict, traffic dict, limits dict)``)."""
    root = Path(tmp)
    pb = root / "portbench"
    for folder in ("metrics", "kernel_map"):
        shutil.copytree(spec.HERE / folder, pb / folder)
    cells = [("tiny-eval", {"name": "tiny", "net": NET, "weights": "seed"},
              dict(EVAL), dict(EVAL_LIMITS)), *extra_cells]
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, cfg, traffic, limits in cells:
        for folder, key, data in (("configs", cfg["name"], cfg),
                                  ("traffic", name, traffic),
                                  ("limits", name, limits)):
            (pb / folder).mkdir(parents=True, exist_ok=True)
            (pb / folder / f"{key}.json").write_text(json.dumps(data))
        if cfg["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({
                "name": cfg["name"],
                "source": "https://arxiv.org/abs/1811.11286",
                "file": f"portbench/configs/{cfg['name']}.json", "reduced": [],
                "why": "tiny"})
        bench["workloads"].append({"name": name, "config": cfg["name"],
                                   "traffic": name, "chips": 1, "why": "tiny"})
    # the real eval cell's metric lists and the training metrics, given
    # to the tiny cells of each kind
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[key] + TRAIN_METRICS[key]:
            kind = "train" if m in TRAIN_METRICS[key] else "eval"
            if "workloads" in m or kind == "train":
                if kind == "eval" and "s2-eval-5k" not in m["workloads"]:
                    continue
                m = dict(m, workloads=[n for n, _, t, _ in cells
                                       if t["kind"] == kind])
                if not m["workloads"]:
                    continue
            kept.append(m)
        bench[key] = kept
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
