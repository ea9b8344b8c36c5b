"""PU-Net's generator (Yu et al., "PU-Net: Point Cloud Upsampling Network",
CVPR 2018, arXiv:1801.06761; ``get_gen_model`` of github.com/yulequan/PU-Net)
on the port's eval path.

Layout is channels-last ``(P, N, 3)``; batch norm is off, the published
default.  With ``r = 4``:

- four PointNet++ set-abstraction levels: ``N / 2**(l-1)`` picks by FPS
  (SA1 picks all ``N``), a ball query of ``NSAMPLE`` points within
  ``RADII[l-1]``, the grouped ``[xyz - centre, features]`` through a
  shared MLP (ReLU after every layer) and a max over the ball;
- three feature-propagation layers (``fa_layer1..3``, from SA4, SA3 and
  SA2): inverse-distance 3-NN interpolation onto the ``N`` input points,
  then a 64-wide conv with ReLU;
- four expansion branches, each its own ``[up4, up3, up2, f1, xyz]`` (259)
  -> 256 -> 128, stacked branch-major into ``(P, 4N, 128)``;
- the coordinate regressor 128 -> 64 (ReLU) -> 3, absolute coordinates.

Row ``i`` of ``f1`` is SA1's ``i``-th FPS pick, while ``up4``, ``up3``,
``up2`` and ``xyz`` row ``i`` is input point ``i``: the published code
concatenates them row by row, and so does this one (a trained checkpoint
depends on it).

Parameters keep the published scopes: ``layer<l>.conv<j>``,
``fa_layer<k>.conv_0``, ``up_layer.fc_layer0_<i>``, ``up_layer.conv_<i>``,
``fc_layer1``, ``fc_layer2``; each a 1x1 conv's ``weight (out, in, 1, 1)``
and ``bias``.  On a card the 14 stages of a chunk (each SA level's FPS,
ball query and group MLP, the FP layers, the expansion) run as CUDA
graphs (:class:`~threepu_torch.models.graphs.Stages`), each under its
``punet.*`` span, once two calls in a row have asked for an input shape
(:meth:`~threepu_torch.models.graphs.GraphedNet.stages_for`).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from threepu_torch.models.graphs import GraphedNet
from threepu_torch.models.layers import Conv1x1, dense
from threepu_torch.ops.ball_query import ball_query
from threepu_torch.ops.fps import fps
from threepu_torch.ops.gather import batched_gather, gather_nd
from threepu_torch.ops.three_nn import three_interpolate, three_nn
from threepu_torch.utils.profiling import span

#: the published generator's sizes: each SA level's ball radius and
#: shared MLP, the samples of a ball, the FP conv, an expansion branch and
#: the coordinate regressor
RADII = (0.05, 0.1, 0.2, 0.3)
NSAMPLE = 32
SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
FP_MLP = (64,)
EXPAND_MLP = (256, 128)
COORD_MLP = (64, 3)


def _mlp(convs: Sequence[Conv1x1], x: torch.Tensor) -> torch.Tensor:
    for conv in convs:
        x = dense(conv, x)
    return x


class PUNet(GraphedNet):
    """PU-Net's generator at its published widths for patches of
    ``num_point`` points, 4x.  :meth:`upsample` is the chunk interface of
    :func:`threepu_torch.inference.upsample_point_cloud`."""

    def __init__(self, num_point: int = 1024, up_ratio: int = 4):
        super().__init__()
        if up_ratio != 4:
            raise ValueError(f"PUNet upsamples 4x, as published; got "
                             f"up_ratio {up_ratio}")
        if num_point % 2 ** (len(RADII) - 1):
            raise ValueError(f"PUNet: {num_point} points do not halve "
                             f"{len(RADII) - 1} times")
        self.num_point, self.up_ratio = num_point, up_ratio

        def convs(widths, c_in, fmt):
            out = {}
            for j, c in enumerate(widths):
                out[fmt.format(j)] = Conv1x1(c_in, c)
                c_in = c
            return nn.ModuleDict(out)

        c_feat = 0
        for l, widths in enumerate(SA_MLPS, start=1):
            setattr(self, f"layer{l}", convs(widths, 3 + c_feat, "conv{}"))
            c_feat = widths[-1]
        # fa_layer1 interpolates SA4's features, fa_layer3 SA2's
        for k in range(1, len(SA_MLPS)):
            setattr(self, f"fa_layer{k}", convs(
                FP_MLP, SA_MLPS[len(SA_MLPS) - k][-1], "conv_{}"))
        c_in = (len(SA_MLPS) - 1) * FP_MLP[-1] + SA_MLPS[0][-1] + 3
        a, b = EXPAND_MLP
        up = {}
        for i in range(up_ratio):
            up[f"fc_layer0_{i}"] = Conv1x1(c_in, a)
            up[f"conv_{i}"] = Conv1x1(a, b)
        self.up_layer = nn.ModuleDict(up)
        self.fc_layer1 = Conv1x1(b, COORD_MLP[0])
        self.fc_layer2 = Conv1x1(*COORD_MLP)

    def _sample(self, l: int, xyz: torch.Tensor):
        picks = fps(xyz, self.num_point // 2 ** (l - 1))
        return picks, gather_nd(xyz, picks)

    def _group_mlp(self, l: int, xyz: torch.Tensor, centres: torch.Tensor,
                   idx: torch.Tensor, feat: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        grouped = batched_gather(xyz, idx) - centres[:, :, None, :]
        if feat is not None:
            grouped = torch.cat([grouped, batched_gather(feat, idx)], -1)
        return torch.amax(_mlp(getattr(self, f"layer{l}").values(), grouped),
                          dim=2)

    def _propagate(self, xyz: torch.Tensor, *known_feat: torch.Tensor):
        """FP from SA4, SA3 and SA2 (``known_feat``: their points and
        features in that order) -> ``(nn_idx..., up...)``."""
        nn_idx, ups = [], []
        for k in range(1, len(RADII)):
            known, feat = known_feat[2 * k - 2], known_feat[2 * k - 1]
            d, idx = three_nn(xyz, known)
            nn_idx.append(idx)
            ups.append(_mlp(getattr(self, f"fa_layer{k}").values(),
                            three_interpolate(feat, idx, d)))
        return (*nn_idx, *ups)

    def _expand(self, xyz: torch.Tensor, f1: torch.Tensor,
                *ups: torch.Tensor):
        x = torch.cat([*ups, f1, xyz], dim=-1)
        branches = [_mlp([self.up_layer[f"fc_layer0_{i}"],
                          self.up_layer[f"conv_{i}"]], x)
                    for i in range(self.up_ratio)]
        feat = torch.cat(branches, dim=1)                 # (P, 4N, 128)
        return feat, dense(self.fc_layer2, dense(self.fc_layer1, feat),
                           relu=False)

    @torch.no_grad()
    def upsample(self, xyz: torch.Tensor, ratio: Optional[int] = None,
                 capture: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Normalized patches ``(P, num_point, 3)`` -> ``(P, 4 *
        num_point, 3)`` in the same frame.  ``capture``, when given,
        receives every stage's selections and features: ``sa<l>.picks``,
        ``.ball``, ``.xyz``, ``.features``; ``fp<l>.nn`` (3-NN indices
        into SA ``l``'s points), ``fp<l>.features``; ``expand.features``
        and ``coords``."""
        if ratio not in (None, self.up_ratio):
            raise ValueError(f"PUNet upsamples {self.up_ratio}x; asked for "
                             f"{ratio}x")
        p, n, _ = xyz.shape
        if n != self.num_point:
            raise ValueError(f"PUNet takes patches of {self.num_point} "
                             f"points; got {n}")
        xyz = xyz.to(torch.float32)
        run = self.stages_for(xyz)
        kept = {}
        sa = []
        l_xyz, l_feat = xyz, None
        for l in range(1, len(RADII) + 1):
            name = f"punet.sa{l}"
            with span(name, on=xyz):
                with span(name + ".fps"):
                    picks, centres = run(name + ".fps",
                                         partial(self._sample, l), l_xyz)
                with span(name + ".ball_query"):
                    idx = run(name + ".ball_query",
                              partial(ball_query, RADII[l - 1], NSAMPLE),
                              l_xyz, centres)
                with span(name + ".group_mlp"):
                    args = (l_xyz, centres, idx) + (
                        () if l_feat is None else (l_feat,))
                    l_feat = run(name + ".group_mlp",
                                 partial(self._group_mlp, l), *args)
            l_xyz = centres
            sa.append((l_xyz, l_feat))
            kept.update({f"sa{l}.picks": picks, f"sa{l}.ball": idx,
                         f"sa{l}.xyz": l_xyz, f"sa{l}.features": l_feat})
        with span("punet.fp", on=xyz):
            known_feat = [t for l in range(len(RADII), 1, -1)
                          for t in sa[l - 1]]
            fp = run("punet.fp", self._propagate, xyz, *known_feat)
        levels = range(len(RADII), 1, -1)
        kept.update({f"fp{l}.nn": t for l, t in zip(levels, fp[:3])})
        kept.update({f"fp{l}.features": t for l, t in zip(levels, fp[3:])})
        with span("punet.expand", on=xyz):
            feat, out = run("punet.expand", self._expand, xyz, sa[0][1],
                            *fp[3:])
        kept.update({"expand.features": feat, "coords": out})
        if capture is not None:
            capture.update({k: run.own(t) for k, t in kept.items()})
        return run.own(out)
