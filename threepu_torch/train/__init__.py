"""Training (port of :mod:`threepu.train`, without the loop and
checkpoints)."""

from threepu_torch.train.model import (Model, loss_weight, make_optimizer,
                                       train_loss, train_step)

__all__ = ["Model", "loss_weight", "make_optimizer", "train_loss",
           "train_step"]
