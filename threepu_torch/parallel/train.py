"""Patch-parallel training over a :class:`~threepu_torch.parallel.Mesh`
(port of ``threepu/parallel/train.py``).

The step takes the global batch, as the serial step does, and every rank
runs the forward and backward on its own contiguous rows.  The Chamfer
loss is a mean over clouds and the local batches are equal, so the mean
of the ranks' gradients is the gradient of the global loss: one
all-reduce a step of one flat buffer holds every parameter's gradient
(zeros where the loss did not reach it, the rule of
:func:`~threepu_torch.train.make_optimizer`) and the unweighted loss,
and is divided by the world size before the clipped Adam step sees it.

Why not ``DistributedDataParallel``: the set of parameters that get a
gradient changes with each step's ratio (the curriculum), which DDP only
takes with ``find_unused_parameters`` and its own buckets; one flat
all-reduce is one collective a step, as XLA's all-reduce is in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from threepu_torch.parallel.mesh import Mesh, batch_sharded
from threepu_torch.train.loop import repatch_sizes
from threepu_torch.train.model import train_loss


def make_sharded_train_step(net, opt: torch.optim.Optimizer, mesh: Mesh):
    """A function with the signature of :func:`threepu_torch.train.
    train_step` that runs over ``mesh``; its ``net`` and ``opt``
    arguments are accepted and ignored (the ones given here are closed
    over).  Rank 0's parameters are broadcast to every rank now.

    Each call slices this rank's rows of the input, the gt and every
    ``seed_idx`` tensor.  Without ``seed_idx`` the step draws the global
    ``(B, 1)`` re-patch seeds itself, with ``generator`` in the serial
    step's order, and slices them: so a generator seeded alike on every
    rank gives the serial step's draws.  Every rank returns the global
    loss and, with ``with_pred``, the global ``(pred, gt patch)``.
    """
    params = list(net.parameters())
    sizes = [p.numel() for p in params]
    with torch.no_grad():
        flat = mesh.broadcast(torch.cat([p.detach().reshape(-1)
                                         for p in params]))
        for p, v in zip(params, flat.split(sizes)):
            p.copy_(v.view_as(p))

    def step(_net, _opt, input_patches: torch.Tensor,
             gt_patches: torch.Tensor, ratio: int,
             threshold: Optional[float] = None,
             weight_mode: str = "floored",
             generator: Optional[torch.Generator] = None,
             seed_idx: Optional[Sequence[torch.Tensor]] = None,
             with_pred: bool = False):
        if seed_idx is None:
            b, k, _ = input_patches.shape
            draw_on = (generator.device if generator is not None
                       else input_patches.device)
            seed_idx = [torch.randint(0, n, (b, 1), generator=generator,
                                      device=draw_on)
                        for n in repatch_sizes(k, ratio, net.step_ratio,
                                               net.max_num_point)]
        inp = batch_sharded(mesh, input_patches)
        gt = batch_sharded(mesh, gt_patches)
        seeds = [batch_sharded(mesh, s) for s in seed_idx]
        opt.zero_grad(set_to_none=True)
        weighted, cd, pred, gt_out = train_loss(net, inp, gt, ratio,
                                                threshold, weight_mode,
                                                seed_idx=seeds)
        weighted.backward()
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [cd.detach().reshape(1)])
        mesh.all_reduce(flat).div_(mesh.size)
        for p, g in zip(params, flat[:-1].split(sizes)):
            p.grad = g.view_as(p)
        opt.step()
        loss = flat[-1].clone()
        if not with_pred:
            return loss
        n = pred.shape[1]
        local = torch.cat([pred.detach(), gt_out.detach()], dim=1)
        both = mesh.all_gather(local.new_empty(
            (local.shape[0] * mesh.size,) + local.shape[1:]), local)
        return loss, (both[:, :n], both[:, n:])

    return step
