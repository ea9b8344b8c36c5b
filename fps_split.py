#!/usr/bin/env python3
"""Where the time of an FPS pick goes on the GPU.

    python3 fps_split.py

Builds ``threepu_torch/csrc/fps.cu`` (with ``common.cu``) once more, with
``-DTHREEPU_FPS_SPLIT``, into a library of its own: there block 0 of
each launch counts the ``clock64`` cycles of each stage of a pick.  The
library that the port loads, and its launch counters, are left alone.
Runs the kernel at ``chip_smoke.py``'s phase-3 FPS shapes, laid out by
``ops.fps.fps_plan``, and at the pick chain's floor (8 clouds of N = C
points, C = 1 to 8), holds every result against the plain version, and
prints block 0's mean cycles per pick in each stage of its one exchange:

- slice pass: each thread's update of its points and their largest
  carry (an ``fmaxf`` tree; the first place that holds it comes from the
  same tree);
- warp argmax: the warp's candidate, one ``redux.sync`` and a ballot
  (a second ``redux.sync`` only where real carries tie between lanes);
- publish: the candidate, its key and its point, into the warp's slot
  of every block (C > 1: lanes 0..C-1 take it from the winning lane by
  shuffles, each sends it to one block with one ``st.async``) or of its
  own block (C = 1: the winning lane's plain store);
- exchange wait: C > 1, the wait on the block's mbarrier for the 8 C
  candidates of the cluster; C = 1, the one ``__syncthreads``;
- slot reduction: the warp's own reduction of the 8 C slots (one
  ``redux.sync`` and a ballot: slot order is index order) and the
  winner's point by shuffles.

Needs one GPU; exits non-zero on a refused launch or a wrong pick.
"""

from __future__ import annotations

import ctypes
import sys

import torch

import chip_smoke as cs
import threepu_torch.ops.fps as fps_mod
from threepu_torch import _build, require_cuda
from threepu_torch.device import card_line

STAGES = ("slice pass", "warp argmax", "publish", "exchange wait",
          "slot reduction")


def main() -> int:
    card = card_line()
    print(card, flush=True)
    dev = require_cuda()
    lib = ctypes.CDLL(str(_build.build(stems=("common", "fps"),
                                       defines=("THREEPU_FPS_SPLIT",))))
    launch = lib.threepu_fps
    launch.argtypes = fps_mod.KERNEL.argtypes + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    lib.threepu_fps_split.argtypes = [ctypes.c_void_p]
    lib.threepu_fps_split.restype = ctypes.c_int
    lib.threepu_error_string.argtypes = [ctypes.c_int]
    lib.threepu_error_string.restype = ctypes.c_char_p

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = [(*cs.fps_inputs(dev, g, b, n), m, fps_mod.fps_plan(b, n, m, sms))
             for b, n, m in cs.FPS_CASES]
    for c in (1, 2, 4, 8):
        cases.append((torch.randn((8, c, 3), generator=g, device=dev),
                      torch.ones((8, c), dtype=torch.bool, device=dev),
                      cs.FPS_FLOOR_PICKS, fps_mod.FpsPlan(c, "registers-8", 1)))

    for pts, valid, m, plan in cases:
        b, n, _ = pts.shape
        out = torch.empty((b, m), dtype=torch.int32, device=dev)
        scratch = torch.empty((b * n if plan.storage == "device" else 0, 4),
                              dtype=torch.float32, device=dev)
        err = launch(pts.data_ptr(), valid.view(torch.uint8).data_ptr(),
                     scratch.data_ptr(), out.data_ptr(), b, n, m,
                     plan.cluster, fps_mod.STORAGE.index(plan.storage),
                     torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        cycles = (ctypes.c_float * len(STAGES))()
        err = err or lib.threepu_fps_split(ctypes.addressof(cycles))
        if err:
            msg = lib.threepu_error_string(err)
            raise RuntimeError(f"fps_split: ({b}, {n}) -> {m}: cudaError_t "
                               f"{err}: {msg}")
        if not torch.equal(out, fps_mod.fps_plain(pts, m, valid)):
            raise AssertionError(f"fps_split: ({b}, {n}) -> {m} differs from "
                                 "the plain version")
        stages = ", ".join(f"{name} {c:.0f}"
                           for name, c in zip(STAGES, cycles))
        print(f"fps ({b}, {n}) -> {m}, {plan.cluster} blocks a cloud, kept in "
              f"{plan.storage}: cycles per pick in block 0: {stages}; total "
              f"{sum(cycles):.0f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
