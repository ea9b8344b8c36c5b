"""Training (port of :mod:`threepu.train`): the step, its optimizer and
loss, the stateful ``Model`` wrapper, and the loop over a file with its
checkpoints."""

from threepu_torch.train.loop import (TrainConfig, TrainState, build_net,
                                      save_epoch_checkpoint, train_loop)
from threepu_torch.train.model import (Model, loss_weight, make_optimizer,
                                       train_loss, train_step)

__all__ = ["Model", "TrainConfig", "TrainState", "build_net", "loss_weight",
           "make_optimizer", "save_epoch_checkpoint", "train_loop",
           "train_loss", "train_step"]
