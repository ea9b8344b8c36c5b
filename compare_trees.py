#!/usr/bin/env python3
"""Phase 3 and phase 4b of ``chip_smoke.py`` for several source trees, in
turns, on one GPU.

    python3 compare_trees.py TREE [TREE ...]

Each TREE is a directory holding a checkout of this repository (for
example a ``git archive`` of another commit, unpacked).  For each, in
the order given, a fresh process started in TREE builds that tree's
kernels (printing ``ptxas -v``'s registers, shared memory and spills per
kernel) and runs that tree's own ``chip_smoke.check_kernels`` (every
kernel against its plain version, with times) at the interlevel and
edge-conv shapes of the ``chip_smoke.py`` beside this script, so that
every tree times the same shapes; then the edge-conv wrapper's host
microseconds a call on that script's arguments of the level-1 edge conv
(``chip_smoke.edgeconv_inputs`` and ``edgeconv_host_us``, the same for
every tree); then that script's ``chamfer_times`` (the Chamfer kernel
one way and both ways through ``nn_one_way`` and ``nn_distance``, at the
80k and train shapes: events, time in a CUDA graph, launches a call);
then ``chip_smoke.end_to_end`` (the 16x pipeline on the plain edge-conv
chain, launch counts, warm seconds per shape) and the warm seconds per
shape again with the edge-conv toggle ``ops.edgeconv.ENABLED`` on
(``chip_smoke.warm_shape_s``), with that run's edge-conv launches per
shape.  Every output line is prefixed with ``[TREE]``.  Give the trees
as A B B A to compare two versions on one card with the drift of the
card's clocks spread over both.  Exits non-zero when any tree fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

import chip_smoke as cs

RUN = r"""
import importlib.util
import sys
from unittest import mock
import numpy as np
import torch
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
_build.build(ptxas_verbose=True)
_build.library()
fx = np.load(cs.FIXTURE)
# every tree times the shapes of the tree that runs this script
cs.INTERLEVEL_CASES = INTERLEVEL_CASES
cs.EDGECONV_CASES = EDGECONV_CASES
cs.check_kernels(dev, card, fx)
# the edge-conv wrapper's host time on the arguments as the invoking
# tree's DenseEdgeConv passes them, at the level-1 shape
spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE)
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
args = here.edgeconv_inputs(
    dev, torch.Generator(device=dev).manual_seed(cs.SEED), 8, 312, 32, 12, 3)
print(f"edge conv wrapper, the layer's arguments at B=8 N=312 k=32 G=12 "
      f"n=3: {here.edgeconv_host_us(ec.edge_conv_chain, args):.2f} us of "
      f"host a call [{card}]", flush=True)
here.chamfer_times(dev, fx, card)
net = load_net(cs.WEIGHTS, **cs.NET).eval()
# the plain chain's warm s/shape: phase 4b returns it second
off_s = cs.end_to_end(net, fx, card, {
    "select": se.KERNEL, "fps": fp.KERNEL, "interlevel": il.KERNEL,
    "edgeconv": ec.KERNEL})[1]
before = ec.KERNEL.launches
with mock.patch.object(ec, "ENABLED", True):
    on_s, times = cs.warm_shape_s(net, fx)
print(f"16x warm s/shape, edge-conv kernel on {on_s:.4f} (runs "
      f"{[round(t, 4) for t in times]}; "
      f"{(ec.KERNEL.launches - before) // len(times)} edge-conv launches a "
      f"shape), off {off_s:.4f} [{card}]", flush=True)
"""


def run_tree(tree: str) -> int:
    """One tree's phases 3 and 4b in a fresh process; returns its exit
    code."""
    run = RUN.replace("= INTERLEVEL_CASES", f"= {cs.INTERLEVEL_CASES!r}") \
             .replace("= EDGECONV_CASES", f"= {cs.EDGECONV_CASES!r}") \
             .replace("HERE)", f"{os.path.abspath(cs.__file__)!r})")
    proc = subprocess.Popen([sys.executable, "-c", run], cwd=tree,
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
