"""Runs one cell of the benchmark of ``threepu_torch`` once and prints
its result as the last line of standard output::

    python3 portbench/run.py --workload s2-eval-5k --seed 7 --seconds 30 \
        --trace 0

The cell, its configuration and its traffic mix come from
``BENCHMARK.json`` and the files it names.  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics.  The run needs as many CUDA cards as the cell asks for, and
exits with a code other than 0, printing no result, without them, or
where ``jax``, ``jaxlib``, ``flax`` or ``threepu`` is loaded once the
window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules the run may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "threepu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); {seen} visible", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(bench, args.workload, args.seed,
                                     args.seconds, args.trace, "cuda",
                                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
