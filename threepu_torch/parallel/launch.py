"""Run a function on every rank of a process group on this host, without
``torchrun``.

    results = spawn(fn, world_size, *args, device="cpu")

starts ``world_size`` processes with ``torch.multiprocessing.spawn``,
sets in each the environment that ``torchrun`` would (``MASTER_ADDR``
127.0.0.1, a free ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``), builds the rank's :class:`~threepu_torch.parallel.Mesh`
(``device=None``: the card ``cuda:rank`` and ``nccl``; ``"cpu"``:
``gloo``), calls ``fn(mesh, *args)`` and returns every rank's result in
rank order.  ``fn`` must be importable by name in a fresh process (a
module-level function of a module that the children can import), and
its result picklable; a rank that raises ends the call with its
traceback.  A CPU rank runs one thread: the ranks share the host's
cores.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Callable, List, Optional, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from threepu_torch.parallel.mesh import make_mesh


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, port: int,
               device: Optional[str], out_dir: str, args: tuple) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(device=device)
    try:
        result = fn(mesh, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, *args,
          device: Optional[Union[str, torch.device]] = None) -> List:
    """``fn(mesh, *args)`` on each of ``world_size`` ranks; returns their
    results in rank order."""
    device = None if device is None else str(device)
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(fn, world_size, free_port(), device,
                                   out_dir, args),
                 nprocs=world_size, join=True)
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
