"""Losses (port of :mod:`threepu.losses`)."""

from threepu_torch.losses.chamfer_loss import ChamferLoss, chamfer_loss

__all__ = ["ChamferLoss", "chamfer_loss"]
