"""Network modules (port of :mod:`threepu.models`)."""

from threepu_torch.models.layers import Conv1x1, DenseConv, DenseEdgeConv
from threepu_torch.models.upsampler import Level, Net, gen_1d_grid

__all__ = ["Conv1x1", "DenseConv", "DenseEdgeConv", "Level", "Net",
           "gen_1d_grid"]
