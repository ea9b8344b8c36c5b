#!/usr/bin/env python3
"""The Chamfer kernel's time at every layout it takes, beside the plan's.

    python3 chamfer_layouts.py

At ``chip_smoke.py``'s two Chamfer shapes (the train step's (16, 624) x
(16, 624) and the fixture's 80k output against its 80k ground truth),
both ways in one launch and each way alone, launches
``threepu_torch/csrc/chamfer.cu`` at 64, 96 and 128 threads a block and
clusters of 1 to 8 blocks, holds each layout's result against the plain
version (exact, values and indices), and prints each layout's
microseconds a call replayed in a CUDA graph (``chip_smoke.graph_us``,
device time), the least, and the layout ``ops.chamfer.chamfer_plan``
takes.  Needs one GPU; exits non-zero on a refused launch or a result
that differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke as cs
import threepu_torch.ops.chamfer as ch_mod
from threepu_torch import _build, require_cuda
from threepu_torch.device import card_line

THREADS = (64, 96, 128)


def main() -> int:
    card = card_line()
    print(card, flush=True)
    dev = require_cuda()
    _build.build(ptxas_verbose=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    fx = np.load(cs.FIXTURE)
    cases = (("80k", [torch.from_numpy(fx[k][None]).to(dev)
                      for k in ("jax_out", "gt")]),
             ("train", cs.chamfer_inputs(dev, g, *cs.CHAMFER_TRAIN_CASE)))
    active = ch_mod.active_clusters(dev.index)
    for name, (a, b) in cases:
        bsz, n, _ = a.shape
        m = b.shape[1]
        want = (*ch_mod.nn_one_way_plain(a, b),
                *ch_mod.nn_one_way_plain(b, a))
        reps = max(3, min(50, 2 ** 26 // (bsz * n * m)))
        calls = {"both ways": (a, b, True, want),
                 "a -> b": (a, b, False, want[:2])}
        for what, (x, y, both, ref) in calls.items():
            plan = ch_mod.chamfer_plan(bsz, n, m, active, both)
            row = {}
            for threads in THREADS:
                for cl in range(1, ch_mod.MAX_CLUSTER + 1):
                    lay = ch_mod.ChamferPlan(threads, cl,
                                             ch_mod.STAGE * threads)
                    cs.chamfer_exact(f"{name} {what} {tuple(lay)}",
                                     ch_mod._launch(x, y, both, lay), ref)
                    row[f"{threads}x{cl}"] = round(cs.graph_us(
                        lambda: ch_mod._launch(x, y, both, lay), reps), 2)
            key = f"{plan.threads}x{plan.cluster}"
            print(f"chamfer {name} {tuple(a.shape)} x {tuple(b.shape)} "
                  f"{what}: exact at every layout; us a call in a CUDA "
                  f"graph by threads x cluster {row}; least "
                  f"{min(row, key=row.get)}; the plan's {key} "
                  f"{row[key]} [{card}]", flush=True)
        del want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
