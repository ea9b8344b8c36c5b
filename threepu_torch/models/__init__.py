"""Network modules (port of :mod:`threepu.models`)."""

from threepu_torch.models.layers import (Conv1x1, DenseConv, DenseEdgeConv,
                                         SampledDenseEdgeConv)
from threepu_torch.models.punet import PUNet
from threepu_torch.models.pugan import PUGAN, gen_rect_grid
from threepu_torch.models.upsampler import (AdaptiveLevel, Level, Net,
                                            exponential_distance, gen_1d_grid,
                                            gen_grid, level_code, load_net)

__all__ = [
    "DenseConv", "DenseEdgeConv", "SampledDenseEdgeConv",
    "Level", "Net", "AdaptiveLevel",
    "exponential_distance", "gen_grid", "gen_1d_grid",
    # the port's own
    "Conv1x1", "level_code", "load_net", "PUNet", "PUGAN", "gen_rect_grid",
]
