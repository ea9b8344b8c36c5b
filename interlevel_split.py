#!/usr/bin/env python3
"""Where the time of an interlevel call goes on the GPU: the selection
against the whole kernel.

    python3 interlevel_split.py

Builds ``threepu_torch/csrc/interlevel.cu`` (with ``common.cu``) twice
into libraries of their own: as the port builds it, and with
``-DTHREEPU_IL_SCAN_ONLY``, where the kernel returns once it has written
the picks.  The library that the port loads, and its launch counters, are
left alone.  At ``chip_smoke.py``'s phase-3 interlevel shapes (levels 2,
3 and 4, and the train step's with the weights output), laid out by
``ops.interlevel.interlevel_plan``, holds both builds' picks (and the
whole kernel's values and weights) against the plain version, and prints
the milliseconds of each, timed in the order A B B A and averaged, with
the selection's issue-slot floor.  Here a call is one launch through
``ctypes`` and nothing else, so the small shapes read device time, not
the wrapper's.  Needs one GPU; exits non-zero on a refused launch or a
result outside its band.
"""

from __future__ import annotations

import ctypes
import sys

import torch

import chip_smoke as cs
import threepu_torch.ops.interlevel as il_mod
from threepu_torch import _build, require_cuda
from threepu_torch.device import card_line

#: build name -> its defines
BUILDS = {"whole kernel": (), "selection alone": ("THREEPU_IL_SCAN_ONLY",)}
K = 5


def bind(defines):
    """The interlevel entry point of a library built with ``defines``."""
    lib = ctypes.CDLL(str(_build.build(ptxas_verbose=True,
                                       stems=("common", "interlevel"),
                                       defines=defines)))
    fn = lib.threepu_interlevel
    fn.argtypes = list(il_mod.KERNEL.argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    card = card_line()
    print(card, flush=True)
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    fns = {}
    for name, defines in BUILDS.items():
        print(f"interlevel build, {name}: "
              f"{' '.join('-D' + d for d in defines) or 'no defines'}",
              flush=True)
        fns[name] = bind(defines)
    cases = [(p, group, m, False) for p, group, m in cs.INTERLEVEL_CASES]
    cases.append((*cs.INTERLEVEL_TRAIN_CASE, True))
    for p, group, m, with_w in cases:
        args = cs.interlevel_inputs(dev, g, p, group, m)
        q_xyz, xq, prev_xyz, prev_feat, prev_dup = args
        b, n, _ = q_xyz.shape
        c = prev_feat.shape[-1]
        out = torch.empty((b, n, c), device=dev)
        idx = torch.empty((b, n, K), dtype=torch.int32, device=dev)
        w = torch.empty((b, n, K), device=dev) if with_w else None
        ptrs = (q_xyz.data_ptr(), xq.data_ptr(), prev_xyz.data_ptr(),
                prev_feat.data_ptr(), prev_dup.view(torch.uint8).data_ptr(),
                out.data_ptr(), idx.data_ptr(),
                None if w is None else w.data_ptr(), b, n, p, m, c, K,
                *il_mod.interlevel_plan(n))
        want = il_mod._plain(*args, K)

        def run(name):
            err = fns[name](*ptrs, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"interlevel_split: {name}: cudaError_t "
                                   f"{err}")

        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            out.fill_(float("nan"))
            run(name)
            torch.cuda.synchronize()
            errs = [0.0]
            if name == "whole kernel":
                errs.append(float((out - want[0]).abs().max()))
                if w is not None:
                    errs.append(float((w - want[2]).abs().max()))
            if not torch.equal(idx, want[1]) or not max(errs) <= \
                    cs.INTERLEVEL_BAND:
                raise AssertionError(f"interlevel_split: {name}, group "
                                     f"{group}, M {m}: picks or values "
                                     f"differ ({errs})")
            times[name].append(cs.cuda_ms(lambda: run(name), 20))
        print(f"interlevel P={p} group={group} M={m}"
              + (" with w" if with_w else "") + ", ms (A B B A, mean): "
              + ", ".join(f"{name} {sum(t) / len(t):.4f}"
                          for name, t in times.items())
              + f"; issue-slot floor {cs.interlevel_issue_floor_ms(args):.4f}"
              f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
