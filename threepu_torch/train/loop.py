"""The training loop over a file (port of ``threepu/train/loop.py``).

Epochs of ``300 * batch_size`` steps; each step's ratio and Chamfer
threshold follow the curriculum, a pure function of the step
(:mod:`threepu_torch.data.curriculum`), the ratio drawn by
``np.random.default_rng(seed * 1_000_003 + step)`` as in the JAX
package.  A :class:`~threepu_torch.data.Prefetcher` keeps two batches
issued ahead of the step.  Every other random draw of step ``s`` (the
batch's seed points, angles, noise and drop-out order, the train
cascade's re-patch seeds) comes from the CPU generator
:func:`~threepu_torch.data.step_generator` ``(seed, s)`` and reaches the
device through pinned memory: so a resumed run continues an unbroken one
(bit for bit on the CPU; on the GPU the backward's atomic sums round in
any order), and the card and the CPU draw alike.

The host reads the losses only every ``log_steps`` steps, in one stacked
copy, and replays the running means in order: no step between holds the
host to the device.  Checkpoints: ``model_<epoch>.npz`` with the
optimizer state (:func:`~threepu_torch.io.save_train_checkpoint`) or,
with ``ckpt_format="pth"``, the reference's ``model_<epoch>.pth``; every
``ckpt_epochs`` epochs and at the end of the run.

With ``TrainConfig.mesh`` (a :class:`threepu_torch.parallel.Mesh`) the
loop runs on the mesh's device and every rank draws the same global
batch; :func:`threepu_torch.parallel.make_sharded_train_step` trains on
each rank's rows and all-reduces the gradients and the loss, so every
rank's ``error_log`` is the serial one.  Rank 0 alone writes the
checkpoints; every rank restores ``ckpt``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from threepu_torch.data import DeviceDataset, Prefetcher, curriculum_state
from threepu_torch.data.h5_dataset import to_device
from threepu_torch.device import resolve_device
from threepu_torch.io import (import_pth, load_checkpoint, load_opt_state,
                              save_pth, save_train_checkpoint)
from threepu_torch.models import Net
from threepu_torch.train.model import loss_weight, make_optimizer, train_step
from threepu_torch.utils import logger


@dataclasses.dataclass
class TrainConfig:
    h5_data: str
    num_shape_point: int
    num_point: Optional[int] = None       # patch size (NUM_POINT)
    batch_size: int = 16
    up_ratio: int = 16
    step_ratio: int = 2
    knn: int = 32
    growth_rate: int = 12
    dense_n: int = 3
    fm_knn: int = 5
    max_num_point: int = 312
    lr_init: float = 5e-4
    max_epoch: int = 160
    stage_steps: int = 15000
    cd_threshold: float = 2.0
    jitter: bool = False
    jitter_sigma: float = 0.0025
    jitter_max: float = 0.005
    drop_out: float = 1.0
    ckpt: Optional[str] = None
    model_dir: str = "./model/demo"
    ckpt_epochs: int = 20
    log_steps: int = 50
    seed: int = 0
    weight_mode: str = "floored"
    mesh: Optional[object] = None         # threepu_torch.parallel.Mesh
    log_with_pred: bool = True            # log steps also return the
    #                                       prediction, for log_fn
    ckpt_format: str = "npz"              # "npz" | "pth"

    @property
    def patch_point(self) -> int:
        return self.num_point or int(self.num_shape_point * self.drop_out)


@dataclasses.dataclass
class TrainState:
    """What :func:`train_loop` trains: the net, its optimizer, the
    global step."""
    net: Net
    opt: torch.optim.Optimizer
    step: int


def build_net(cfg: TrainConfig) -> Net:
    return Net(max_up_ratio=cfg.up_ratio, step_ratio=cfg.step_ratio,
               knn=cfg.knn, growth_rate=cfg.growth_rate,
               dense_n=cfg.dense_n, fm_knn=cfg.fm_knn,
               max_num_point=cfg.max_num_point)


def repatch_sizes(num_point: int, ratio: int, step_ratio: int,
                  max_num_point: int) -> List[int]:
    """The point count each re-patching level of the train cascade draws
    its seed from, in order, for ``num_point``-point input patches at
    ``ratio`` (:meth:`threepu_torch.models.Net.forward`)."""
    max_np = min(num_point, max_num_point)
    n, sizes = num_point * step_ratio, []
    level = step_ratio
    while level < ratio:
        if n > max_np:
            sizes.append(n)
            n = max_np
        n *= step_ratio
        level *= step_ratio
    return sizes


def save_epoch_checkpoint(cfg: TrainConfig, state: TrainState, step: int,
                          epoch: int) -> str:
    """Write the epoch checkpoint, ``model_{epoch}.npz`` with the
    optimizer state, or ``model_{epoch}.pth`` with ``cfg.ckpt_format ==
    "pth"``, under ``cfg.model_dir``; returns its path."""
    if cfg.ckpt_format == "pth":
        return save_pth(cfg.model_dir, state.net, step=step, label="model",
                        epoch=epoch)
    path = os.path.join(cfg.model_dir, f"model_{epoch}.npz")
    save_train_checkpoint(path, state.net, state.opt, step=step)
    return path


def train_loop(cfg: TrainConfig, max_steps: Optional[int] = None,
               log_fn: Optional[Callable] = None,
               device: Optional[Union[str, torch.device]] = None):
    """Train; returns ``(state, error_log)``.

    The run is on ``device``: the card unless another device (``"cpu"``)
    is named.  With ``cfg.mesh`` the mesh decides it: ``device`` may be
    left out, and raises where it names another device than the mesh's;
    ``cfg.batch_size`` must divide by the mesh's size.  ``max_steps`` bounds the
    global step; ``log_fn(step, ratio, loss, state, batch, pred=, gt_out=,
    error=)`` is called every ``log_steps`` steps (the training monitor's
    hook).  A fresh net is initialized from ``cfg.seed``; ``cfg.ckpt``
    restores a ``.npz`` with its optimizer state where it holds one, or
    the parameters of a ``.pth``.
    """
    mesh = cfg.mesh
    if mesh is not None:
        if cfg.batch_size % mesh.size:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide "
                             f"over {mesh.size} ranks")
        if device is not None:
            named = torch.device(device)
            if named.type != mesh.device.type \
                    or named.index not in (None, mesh.device.index):
                raise ValueError(f"train_loop: device {named} is not the "
                                 f"mesh's {mesh.device}")
        device = mesh.device
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(cfg.seed)
        net = build_net(cfg)
    net = net.to(dev).train()
    opt = make_optimizer(net.parameters(), cfg.lr_init)
    dataset = DeviceDataset(
        cfg.h5_data, cfg.num_shape_point, cfg.patch_point,
        batch_size=cfg.batch_size, up_ratio=cfg.up_ratio,
        step_ratio=cfg.step_ratio, jitter=cfg.jitter,
        jitter_sigma=cfg.jitter_sigma, jitter_max=cfg.jitter_max,
        drop_out=cfg.drop_out, device=dev)

    step = 0
    if cfg.ckpt:
        pth = cfg.ckpt.endswith(".pth")
        restored, step = (import_pth if pth else load_checkpoint)(cfg.ckpt,
                                                                  net)
        net.load_state_dict(restored, strict=True)
        if not pth and load_opt_state(cfg.ckpt, net, opt) is not None:
            logger.info("restored optimizer state (exact resume)")
        logger.info(f"restored {cfg.ckpt} at step {step}")
    state = TrainState(net, opt, step)
    step_fn = train_step
    if mesh is not None:
        from threepu_torch.parallel import make_sharded_train_step
        step_fn = make_sharded_train_step(net, opt, mesh)

    def checkpoint(epoch: int, note: str = "") -> None:
        if mesh is None or mesh.rank == 0:
            path = save_epoch_checkpoint(cfg, state, step, epoch)
            logger.info(f"saved {path}{note}")
        if mesh is not None:
            mesh.barrier()

    num_point = cfg.patch_point
    if cfg.drop_out < 1.0:
        num_point = int(num_point * cfg.drop_out)

    def sample(s: int, ratio: int, generator):
        inp, gt = dataset.sample(s, ratio, generator)
        seeds = [to_device(torch.randint(0, n, (cfg.batch_size, 1),
                                         generator=generator), dev)
                 for n in repatch_sizes(num_point, ratio, cfg.step_ratio,
                                        cfg.max_num_point)]
        return inp, gt, seeds

    steps_per_epoch = 300 * cfg.batch_size
    start_epoch = step // steps_per_epoch
    error_log = defaultdict(float)
    # the losses stay on the device until a log step reads them in one
    # copy; their running means are then replayed in order
    pending = []                     # (key, weight, denom, device loss)

    def flush():
        if not pending:
            return None
        vals = torch.stack([p[3] for p in pending]).cpu().numpy()
        for (k, w, denom, _), v in zip(pending, vals):
            prev = error_log[k]
            error_log[k] = prev + (float(v) * w - prev) / denom
        pending.clear()
        return float(vals[-1])

    def ratio_for(s: int) -> int:
        st = curriculum_state(s, cfg.stage_steps, cfg.up_ratio,
                              cfg.step_ratio, cfg.cd_threshold)
        rng = np.random.default_rng(cfg.seed * 1_000_003 + s)
        return st.choose_ratio(rng)

    prefetch = Prefetcher(sample, ratio_for, cfg.seed, depth=2,
                          start_step=step)
    t0 = time.time()
    # epochs are labelled 1..max_epoch, the first checkpoint at epoch
    # ckpt_epochs
    for epoch in range(start_epoch + 1, cfg.max_epoch + 1):
        for _ in range(steps_per_epoch):
            if max_steps is not None and step >= max_steps:
                flush()
                return state, error_log
            (inp, gt, seeds), ratio, _ = next(prefetch)
            st = curriculum_state(step, cfg.stage_steps, cfg.up_ratio,
                                  cfg.step_ratio, cfg.cd_threshold)
            log_now = (log_fn is not None and cfg.log_with_pred
                       and (step + 1) % cfg.log_steps == 0)
            out = step_fn(net, opt, inp, gt, ratio, threshold=st.threshold,
                          weight_mode=cfg.weight_mode, seed_idx=seeds,
                          with_pred=log_now)
            cd, (pred, gt_out) = out if log_now else (out, (None, None))
            step += 1
            state.step = step
            w = loss_weight(ratio, cfg.up_ratio, cfg.step_ratio,
                            cfg.weight_mode)
            k = f"cd_loss_x{ratio}"
            # on the k-th step the running mean divides by k
            pending.append((k, w, step, cd))
            if step % cfg.log_steps == 0:
                last_cd = flush()
                if log_fn is not None:
                    log_fn(step, ratio, last_cd, state, (inp, gt),
                           pred=pred, gt_out=gt_out, error=error_log[k])

        flush()
        logger.info(
            f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.6f}" for k, v in sorted(error_log.items()))
            + f" ({(time.time() - t0):.1f}s)")
        if epoch % cfg.ckpt_epochs == 0:
            checkpoint(epoch)
    # the completed run is always saved, whatever ckpt_epochs
    if start_epoch < cfg.max_epoch and cfg.max_epoch % cfg.ckpt_epochs:
        checkpoint(cfg.max_epoch, " (final)")
    return state, error_log
