"""Chamfer loss with the curriculum's outlier threshold (port of
``threepu/losses/chamfer_loss.py``).

- Bidirectional mean squared nearest-neighbour distance
  (:func:`threepu_torch.ops.chamfer.nn_distance`), the forward direction
  (pred to gt) weighted by ``forward_weight``.
- Optional outlier rejection: per cloud and per direction, distances not
  strictly below ``threshold * mean(distance)`` count as zero.

:func:`chamfer_loss` is the function; :class:`ChamferLoss` keeps the
threshold as state, as the curriculum drives it.
"""

from __future__ import annotations

from typing import Optional

import torch

from threepu_torch.ops.chamfer import nn_distance


def _to_points_last(x: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3)`` as it is, ``(B, 3, N)`` transposed to it."""
    if x.dim() != 3:
        raise ValueError(f"ChamferLoss needs a 3D tensor, got "
                         f"{tuple(x.shape)}")
    if x.shape[2] != 3:
        if x.shape[1] != 3:
            raise ValueError("ChamferLoss is implemented for 3D points")
        x = x.transpose(1, 2)
    return x


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor,
                 threshold: Optional[float] = None,
                 forward_weight: float = 1.0) -> torch.Tensor:
    """Scalar Chamfer loss of ``pred`` against ``gt``, each ``(B, N, 3)``
    or ``(B, 3, N)``."""
    pred2gt, _, gt2pred, _ = nn_distance(_to_points_last(pred),
                                         _to_points_last(gt))
    if threshold is not None:
        fwd_thr = torch.mean(pred2gt, dim=1, keepdim=True) * threshold
        bwd_thr = torch.mean(gt2pred, dim=1, keepdim=True) * threshold
        pred2gt = torch.where(pred2gt < fwd_thr, pred2gt,
                              torch.zeros_like(pred2gt))
        gt2pred = torch.where(gt2pred < bwd_thr, gt2pred,
                              torch.zeros_like(gt2pred))
    cd = (forward_weight * torch.mean(pred2gt, dim=1)
          + torch.mean(gt2pred, dim=1))
    return torch.mean(cd)


class ChamferLoss:
    """:func:`chamfer_loss` with the threshold held as state
    (``set_threshold`` / ``unset_threshold``)."""

    def __init__(self, threshold: Optional[float] = None,
                 forward_weight: float = 1.0):
        self.threshold = threshold
        self.forward_weight = forward_weight

    def set_threshold(self, value: float) -> None:
        self.threshold = value

    def unset_threshold(self) -> None:
        self.threshold = None

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return chamfer_loss(pred, gt, threshold=self.threshold,
                            forward_weight=self.forward_weight)
