#!/usr/bin/env python3
"""Phase 3 and phase 4b of ``chip_smoke.py`` for several source trees, in
turns, on one GPU.

    python3 compare_trees.py TREE [TREE ...]

Each TREE is a directory holding a checkout of this repository (for
example a ``git archive`` of another commit, unpacked).  For each, in
the order given, a fresh process started in TREE builds that tree's
kernels and runs that tree's own ``chip_smoke.check_kernels`` (every
kernel against its plain version, with times) and
``chip_smoke.end_to_end`` (the 16x pipeline, launch counts, warm seconds
per shape).  Every output line is prefixed with ``[TREE]``.  Give the
trees as A B B A to compare two versions on one card with the drift of
the card's clocks spread over both.  Exits non-zero when any tree
fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

RUN = r"""
import sys
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from threepu_torch import _build, require_cuda
from threepu_torch.device import card_line
from threepu_torch.models import load_net
import threepu_torch.ops.edgeconv as ec
import threepu_torch.ops.fps as fp
import threepu_torch.ops.interlevel as il
import threepu_torch.ops.select as se

card = card_line()
print(card, flush=True)
dev = require_cuda()
_build.library()
fx = np.load(cs.FIXTURE)
cs.check_kernels(dev, card, fx)
net = load_net(cs.WEIGHTS, **cs.NET).eval()
cs.end_to_end(net, fx, card, {"select": se.KERNEL, "fps": fp.KERNEL,
                              "interlevel": il.KERNEL, "edgeconv": ec.KERNEL})
"""


def run_tree(tree: str) -> int:
    """One tree's phases 3 and 4b in a fresh process; returns its exit
    code."""
    proc = subprocess.Popen([sys.executable, "-c", RUN], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    for line in proc.stdout:
        print(f"[{tree}] {line}", end="", flush=True)
    return proc.wait()


def main() -> int:
    trees = sys.argv[1:]
    if not trees or not all(os.path.isfile(os.path.join(t, "chip_smoke.py"))
                            for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    failed = [t for t in trees if run_tree(t) != 0]
    if failed:
        print(f"compare_trees: failed in {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
