"""Optimizer and loss of a training step (port of
``threepu/train/model.py``).

- :func:`make_optimizer`: Adam(lr, 0.9, 0.999, eps 1e-8) whose every
  step first clips each gradient element to ``[-1, 1]`` — the JAX
  package's ``optax.chain(optax.clip(1.0), optax.adam(lr))``.
- :func:`loss_weight`: the per-ratio loss weight, ``"floored"`` (the
  default, ``max(1, log_step(max / r))``) or ``"reference"``.
- :func:`train_loss` / :func:`train_step`: the train-mode ``Net``
  forward, the Chamfer loss, backward and the clipped Adam update.
- :class:`Model`: the stateful wrapper with ``set_input`` /
  ``optimize`` / ``error_log``.  It puts the net on the card unless
  another device is named.

The training loop over files, with its checkpoints, is
:mod:`threepu_torch.train.loop`; the checkpoint formats are
:mod:`threepu_torch.io.checkpoint`.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from threepu_torch.device import resolve_device
from threepu_torch.losses import chamfer_loss
from threepu_torch.models import Net

#: element-wise gradient clip applied before every Adam step
CLIP = 1.0


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float = 5e-4) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8) that clips every gradient
    element to ``[-CLIP, CLIP]`` in place before each step.

    Like optax, it updates every parameter at every step: one that the
    loss did not reach (a level above the batch's ratio) gets a zero
    gradient, so its moments decay, its count advances and its momentum
    still moves it, where ``torch.optim.Adam`` would skip it."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def clip(optimizer, args, kwargs):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            torch.nn.utils.clip_grad_value_(group["params"], CLIP)

    opt.register_step_pre_hook(clip)
    return opt


def loss_weight(ratio: int, max_up_ratio: int, step_ratio: int,
                mode: str = "floored") -> float:
    """``log_step(max_up_ratio / ratio)``, floored at 1 in mode
    ``"floored"``: the reference's weight is 0 at the top ratio, so the
    top level would never learn."""
    w = math.log(max_up_ratio / ratio, step_ratio)
    if mode == "floored":
        return max(1.0, w)
    if mode == "reference":
        return w
    raise ValueError(f"unknown loss_weight mode {mode!r}")


def train_loss(net: Net, input_patches: torch.Tensor,
               gt_patches: torch.Tensor, ratio: int,
               threshold: Optional[float] = None,
               weight_mode: str = "floored",
               generator: Optional[torch.Generator] = None,
               seed_idx: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The train-mode forward and its loss: ``(weighted loss, unweighted
    Chamfer loss, pred, gt patch)``; the weighted loss is what the step
    differentiates."""
    pred, gt_out = net(input_patches, ratio, gt_patches, train=True,
                       generator=generator, seed_idx=seed_idx)
    cd = chamfer_loss(pred, gt_out, threshold=threshold)
    weight = loss_weight(ratio, net.max_up_ratio, net.step_ratio,
                         weight_mode)
    return cd * weight, cd, pred, gt_out


def train_step(net: Net, opt: torch.optim.Optimizer,
               input_patches: torch.Tensor, gt_patches: torch.Tensor,
               ratio: int, threshold: Optional[float] = None,
               weight_mode: str = "floored",
               generator: Optional[torch.Generator] = None,
               seed_idx: Optional[Sequence[torch.Tensor]] = None,
               with_pred: bool = False):
    """One optimization step: input ``(B, K, 3)``, gt ``(B, ratio*K, 3)``
    channels-last.  Returns the unweighted Chamfer loss (a 0-d tensor on
    the net's device), and ``(pred, gt patch)`` too with ``with_pred``."""
    opt.zero_grad(set_to_none=True)
    weighted, cd, pred, gt_out = train_loss(
        net, input_patches, gt_patches, ratio, threshold, weight_mode,
        generator, seed_idx)
    weighted.backward()
    opt.step()
    if with_pred:
        return cd.detach(), (pred.detach(), gt_out.detach())
    return cd.detach()


def _to_channels_last(x, device: torch.device) -> torch.Tensor:
    """A ``(B, 3, N)`` or ``(B, N, 3)`` array -> ``(B, N, 3)`` float32 on
    ``device``."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        dtype=torch.float32, device=device)
    if x.dim() == 3 and x.shape[1] == 3 and x.shape[2] != 3:
        x = x.transpose(1, 2)
    return x.contiguous()


class Model:
    """Stateful training wrapper (``threepu/train/model.py:109-196``):
    ``set_input`` / ``optimize`` / ``forward`` and the running-mean
    ``error_log``.

    The net moves to ``device``: the card unless another device
    (``"cpu"``) is named.  Re-patch seeds come from a generator on that
    device seeded with ``seed``.
    """

    def __init__(self, net: Net, lr_init: float = 5e-4, seed: int = 0,
                 weight_mode: str = "floored",
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.weight_mode = weight_mode
        self.error_log = defaultdict(float)
        #: the Chamfer loss's curriculum threshold (None: off)
        self.chamfer_threshold: Optional[float] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.opt = make_optimizer(self.net.parameters(), lr_init)
        self.step = 0
        self._input = self._gt = None
        self.up_ratio: Optional[int] = None
        self.predicted = None

    def set_input(self, input_pc, up_ratio: int, label_pc=None) -> None:
        """Takes the reference's ``(B, 3, N)`` layout or channels-last."""
        self._input = _to_channels_last(input_pc, self.device)
        self._gt = (_to_channels_last(label_pc, self.device)
                    if label_pc is not None else None)
        self.up_ratio = int(up_ratio)

    def optimize(self) -> float:
        """One :func:`train_step` on the current input; updates the
        running mean of the weighted loss and returns it."""
        self.net.train()
        cd = train_step(self.net, self.opt, self._input, self._gt,
                        self.up_ratio, threshold=self.chamfer_threshold,
                        weight_mode=self.weight_mode,
                        generator=self.generator)
        self.step += 1
        weighted = float(cd) * loss_weight(
            self.up_ratio, self.net.max_up_ratio, self.net.step_ratio,
            self.weight_mode)
        k = f"cd_loss_x{self.up_ratio}"
        self.error_log[k] += (weighted - self.error_log[k]) / self.step
        return weighted

    def forward(self) -> torch.Tensor:
        """Eval cascade on the current input."""
        self.predicted = self.net.upsample(self._input, self.up_ratio)
        return self.predicted
