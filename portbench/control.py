"""The control of a cell's correctness check: the plain reference put in
the program's place and computed one precision step below the float32
(TF32 off) that the configurations state, in TF32, then checked exactly
as a run checks the program.  It has to come out as not correct.

    python3 portbench/control.py --workload s2-eval-5k --seeds 11 12 13

prints one JSON line per seed with the check's readings and the cell's
limits.  On the card it runs at the cell's own size; the tests run it on
the CPU at tiny sizes (:func:`readings`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(bench: dict, workload: str, seed: int, device: str,
             tf32: bool = True, root=None, fault: str = "") -> dict:
    """The check's readings of the reference run in the program's place
    (in TF32 where ``tf32``) on the cell's traffic from ``seed``."""
    from portbench import harness, spec
    job = harness.make_job(bench, workload, seed, 0.0, 0, device, 0.0,
                           root or spec.ROOT)
    drv = importlib.import_module(
        f"portbench.drivers.{job['traffic']['kind']}")
    return drv.control(job, tf32, fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fp32", action="store_true",
                    help="the reference in float32 instead: a sound run")
    ap.add_argument("--fault", default="",
                    help="a fault planted in the reference in the program's "
                         "place (train: 'half', half of each batch)")
    args = ap.parse_args(argv)
    import torch
    from portbench import spec
    if not torch.cuda.is_available():
        print("portbench/control.py: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    lim = spec.limits(args.workload)
    for seed in args.seeds:
        t = time.time()
        got = readings(bench, args.workload, seed, "cuda", not args.fp32,
                       fault=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "fp32" if args.fp32 else "tf32",
                          "fault": args.fault,
                          "readings": got, "limits": lim,
                          "fails": any(got.get(k, 0.0) > v
                                       for k, v in lim.items()),
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
