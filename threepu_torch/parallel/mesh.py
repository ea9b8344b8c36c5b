"""The process group that the sharded paths run over (port of
``threepu/parallel/mesh.py``).

JAX builds a mesh of the devices one process sees.  PyTorch runs one
process a device: a :class:`Mesh` is this process's place in the default
process group, its rank, the group's size and the rank's device.  Its
one axis is the patch (batch) axis, as in JAX.  Every collective of the
sharded paths goes through a method of :class:`Mesh`, which counts its
calls by kind in :attr:`Mesh.counts`: the count is how the tests and
``chip_smoke.py`` see which collectives a path ran.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from threepu_torch.device import require_cuda

# ``all_gather_into_tensor`` is deprecated in favour of
# ``all_gather_single`` where the latter exists
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass
class Mesh:
    """One rank of a 1-D mesh over the default process group."""
    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"
    #: collectives run through this rank's mesh, by kind
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def _collective(self, kind: str, fn, *args, **kwargs):
        self.counts[kind] += 1
        return fn(*args, group=self.group, **kwargs)

    def all_gather(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, concatenated along dim 0 in rank order,
        into ``out`` (``size`` times ``x``'s rows); returns ``out``."""
        self._collective("all_gather", _ALL_GATHER, out, x.contiguous())
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place; returns ``x``."""
        self._collective("all_reduce", dist.all_reduce, x)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns ``x``."""
        self._collective("broadcast", dist.broadcast, x, src)
        return x

    def barrier(self) -> None:
        """Waits until every rank has reached it."""
        kwargs = {}
        if self.device.type == "cuda":
            kwargs["device_ids"] = [self.device.index]
        self._collective("barrier", dist.barrier, **kwargs)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This process's rank of the default process group, as a
    :class:`Mesh`.

    The group is initialized from the environment that ``torchrun`` (or
    :func:`threepu_torch.parallel.launch.spawn`) sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    unless one exists already.  ``device=None`` takes the card
    ``cuda:LOCAL_RANK`` and ``nccl``, and raises where no GPU is visible;
    ``device="cpu"`` takes the CPU and ``gloo``.  ``n_devices``, where
    given, must be the world size: a mesh smaller than its process group
    would need a subgroup, and no caller needs one.
    """
    if device is None or torch.device(device).type == "cuda":
        require_cuda()
        index = torch.device(device).index if device is not None else None
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
        dev, backend = torch.device("cuda", index), "nccl"
    elif torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"make_mesh: no backend for device {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process "
                         f"group has {size} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, dev, axis_name)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """Rank 0's ``x`` (a tensor or array) on every rank, as a new tensor
    on ``mesh.device``."""
    x = torch.as_tensor(x).detach().to(mesh.device)
    return mesh.broadcast(x.clone(memory_format=torch.contiguous_format))


def batch_sharded(mesh: Mesh, x: Union[torch.Tensor, np.ndarray]):
    """This rank's rows of ``x``'s leading axis: ``size`` contiguous
    blocks in rank order, the layout of JAX's ``P("data")``.  Raises
    where the axis does not divide by ``mesh.size``."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch_sharded: a leading axis of {n} does not "
                         f"divide over {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]
