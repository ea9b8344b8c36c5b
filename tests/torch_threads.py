"""Two intra-op threads for torch in every process that runs the port's
tests; every ``tests/test_torch_*.py`` imports this module first.

The suite runs in six worker processes at once (pytest-xdist), and
torch's default of one OpenMP thread per core in each of them puts many
spinning threads on every core: the port's tests then run one to two
orders of magnitude slower than alone.  Two threads a worker ran the
whole suite a few percent faster than one on 8 cores.
``OMP_NUM_THREADS`` is set for the processes the tests start (the
parallel workers, the CLI runs), unless the environment already sets it.
"""

import os

import torch

THREADS = 2

os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
