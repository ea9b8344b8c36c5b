"""PU-GAN's generator (Li, Li, Chen, Fu and Heng, "PU-GAN: a Point Cloud
Upsampling Adversarial Network", ICCV 2019, arXiv:1907.10844; ``Generator``
of github.com/liruihui/PU-GAN) on the port's eval path.

Layout is channels-last ``(P, N, 3)``; batch norm is off, as in the
published generator.  Every conv is a 1x1 shared MLP with a bias and a
ReLU unless "no act" says otherwise.  With ``r = 4``, ``r' = r + 2``
(the published ``more_up``) and ``M = r' N``:

- ``feature_extraction``: ``layer0`` 3 -> 24 (no act), then four of 3PU's
  dense edge convs (:class:`~threepu_torch.models.layers.DenseEdgeConv`,
  growth 24, 3 stages, k 16: edges ``[x, x_nn - x]`` over the
  feature-space kNN, stages with ReLU, ReLU, no act, a max over the
  neighbours, ``[g2, g1, g0, x]`` out), each but the first after a 48-wide
  ``layer<i>_prep`` conv, and each output put before its input features:
  24 -> 120 -> 240 -> 360 -> 480;
- ``up_projection_unit``: ``L = conv0(F)`` 480 -> 128, ``H0 = up_0(L)``,
  ``E0 = down_0(H0) - L``, ``H1 = up_1(E0)``, ``H = H0 + H1``;
- an up block: the features tiled ``r'`` times, row ``a N + i`` holding
  point ``i`` beside code point ``a`` of PU-GAN's grid
  (:func:`gen_rect_grid`, 3 x 2 at ``r' = 6``), so ``(M, 130)``;
  ``attention_unit``: ``f``, ``g`` 130 -> 32, ``h`` 130 -> 130, then
  ``gamma * softmax(g f^T) h + x``
  (:func:`~threepu_torch.ops.attention.attention`, unscaled); ``conv1``
  130 -> 256, ``conv2`` 256 -> 128;
- the down block: point ``i``'s ``r'`` rows concatenated copy-major (index
  ``a * 128 + c``), ``conv1`` over them with its published ``[1, r']``
  kernel, 768 -> 256, then ``conv2`` 256 -> 128;
- ``fc_layer1`` 128 -> 64, ``fc_layer2`` 64 -> 3 (no act): absolute
  coordinates of the ``M`` candidates, of which FPS from index 0 keeps
  ``r N``.

In every feature kNN a row that repeats an earlier input point ranks
behind every distinct row, judged once on the patch's points, as 3PU's
levels judge it (the published op computes that penalty and drops it;
on a patch without repeated points both pick alike).

Parameters keep the published scopes: ``feature_extraction.layer0``,
``.layer<i>_prep`` (a conv1d: ``weight (out, in, 1)``), ``.layer<i>``
(whose stage ``l<j>`` is ``mlps.<j>``, the name 3PU's port gives it),
``up_projection_unit.conv0``, ``.up_<j>.attention_unit.conv_f`` /
``conv_g`` / ``conv_h`` / ``gamma``, ``.up_<j>.conv1`` / ``conv2``,
``.down_0.conv1`` (``weight (256, 128, 1, r')``) / ``conv2``,
``fc_layer1``, ``fc_layer2``; the other convs' ``weight (out, in, 1,
1)``.  ``gamma`` starts at 0, as published.

On a card the stages of a chunk run as CUDA graphs
(:meth:`~threepu_torch.models.graphs.GraphedNet.stages_for`), each under
its span: ``pugan.extract``; ``pugan.up_down_up`` over ``conv0`` and
``pugan.up0``, ``pugan.down``, ``pugan.up1``, each up block's attention
product a stage of its own under ``pugan.up<j>.attention``;
``pugan.coords``; ``pugan.fps``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from threepu_torch.models.graphs import GraphedNet
from threepu_torch.models.layers import Conv1x1, DenseEdgeConv, dense
from threepu_torch.ops import edgeconv
from threepu_torch.ops.attention import attention
from threepu_torch.ops.distances import duplicate_mask
from threepu_torch.ops.fps import fps
from threepu_torch.ops.gather import gather_nd
from threepu_torch.utils.profiling import span

#: the published sizes: the extractor's first conv, growth rate, stages,
#: neighbours and prep width; the expansion's feature width and the up
#: block's hidden width (the attention's is a quarter of its input's);
#: the coordinate regressor; the ratio, and the copies made beyond it
#: before the FPS
LAYER0 = 24
GROWTH, DENSE_N, KNN, COMP = 24, 3, 16, 48
FEAT, UP_HIDDEN = 128, 256
COORD_MLP = (64, 3)
UP_RATIO, MORE_UP = 4, 2


def gen_rect_grid(num: int) -> np.ndarray:
    """``(num, 2)`` code grid of PU-GAN's ``gen_grid(up_ratio)``: ``num_x``
    the largest divisor of ``num`` up to ``int(sqrt(num)) + 1``, ``num_y =
    num // num_x``, linspace(-0.2, 0.2) on each axis and ``meshgrid`` in
    ``xy`` order, so row ``a`` is ``(gx[a % num_x], gy[a // num_x])``
    (``num`` 6: 3 x 2)."""
    num_x = next(i for i in range(int(math.sqrt(num)) + 1, 0, -1)
                 if num % i == 0)
    gx = np.linspace(-0.2, 0.2, num_x, dtype=np.float32)
    gy = np.linspace(-0.2, 0.2, num // num_x, dtype=np.float32)
    x, y = np.meshgrid(gx, gy, indexing="xy")
    return np.stack([x.reshape(-1), y.reshape(-1)], axis=-1)


class AttentionUnit(nn.Module):
    """``attention_unit``: ``gamma * softmax(g f^T) h + x`` over the rows
    of ``x (P, M, C)``, ``f`` and ``g`` ``C // 4`` wide, ``h`` ``C``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_f = Conv1x1(c, c // 4)
        self.conv_g = Conv1x1(c, c // 4)
        self.conv_h = Conv1x1(c, c)
        self.gamma = nn.Parameter(torch.zeros(1))


class UpBlock(nn.Module):
    """``up_block``: tile, code grid, attention, two convs."""

    def __init__(self, ratio: int):
        super().__init__()
        self.register_buffer("code", torch.from_numpy(gen_rect_grid(ratio)),
                             persistent=False)
        c = FEAT + self.code.shape[1]
        self.attention_unit = AttentionUnit(c)
        self.conv1 = Conv1x1(c, UP_HIDDEN)
        self.conv2 = Conv1x1(UP_HIDDEN, FEAT)

    def units(self, x: torch.Tensor):
        """``x (P, N, 128)`` -> the tiled rows ``(P, M, 130)`` and their
        ``f``, ``g``, ``h``."""
        p, n, c = x.shape
        r = self.code.shape[0]
        code = self.code[:, None, :].expand(r, n, -1).reshape(1, r * n, -1)
        x = torch.cat([x.repeat(1, r, 1), code.expand(p, -1, -1)], dim=-1)
        att = self.attention_unit
        return (x, dense(att.conv_f, x), dense(att.conv_g, x),
                dense(att.conv_h, x))

    def mlp(self, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The attention's output ``o`` added to its input ``x`` by
        ``gamma``, then ``conv1`` and ``conv2``."""
        y = self.attention_unit.gamma * o + x
        return dense(self.conv2, dense(self.conv1, y))


class CopyConv(nn.Module):
    """The down block's first conv: a kernel ``[1, r']`` over the ``r'``
    copies of each point, ``weight (out, in, 1, r')`` as published."""

    def __init__(self, in_features: int, out_features: int, ratio: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, 1, ratio))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.xavier_uniform_(self.weight)

    def matrix(self) -> torch.Tensor:
        """The ``(r' * in, out)`` kernel of the dense product over a
        point's copies concatenated copy-major (row ``a * in + c``)."""
        return self.weight[:, :, 0, :].permute(2, 1, 0).reshape(
            -1, self.weight.shape[0])


class DownBlock(nn.Module):
    """``down_block``: the ``r'`` rows of each point through one conv of
    kernel ``[1, r']``, then a 1x1 conv."""

    def __init__(self, ratio: int):
        super().__init__()
        self.ratio = ratio
        self.conv1 = CopyConv(FEAT, UP_HIDDEN, ratio)
        self.conv2 = Conv1x1(UP_HIDDEN, FEAT)

    def forward(self, h: torch.Tensor, n: int) -> torch.Tensor:
        """``h (P, r' N, C)``, row ``a N + i`` copy ``a`` of point ``i``
        -> ``(P, N, 128)``."""
        p, _, c = h.shape
        x = h.reshape(p, self.ratio, n, c).transpose(1, 2).reshape(
            p, n, self.ratio * c)
        return dense(self.conv2, dense(self.conv1, x))


class PUGAN(GraphedNet):
    """PU-GAN's generator at its published widths for patches of
    ``num_point`` points, 4x, expanding 6x before its FPS.
    :meth:`upsample` is the chunk interface of
    :func:`threepu_torch.inference.upsample_point_cloud`."""

    def __init__(self, num_point: int = 256, up_ratio: int = UP_RATIO):
        super().__init__()
        if up_ratio != UP_RATIO:
            raise ValueError(f"PUGAN upsamples {UP_RATIO}x, as published; "
                             f"got up_ratio {up_ratio}")
        if num_point <= KNN:
            raise ValueError(f"PUGAN: patches of {num_point} points; its "
                             f"edge convs need more than {KNN}")
        self.num_point, self.up_ratio = num_point, up_ratio
        expand = up_ratio + MORE_UP
        fe = {"layer0": Conv1x1(3, LAYER0)}
        feat = LAYER0
        for i in range(1, 5):
            c_in = LAYER0 if i == 1 else COMP
            if i > 1:
                fe[f"layer{i}_prep"] = Conv1x1(feat, COMP, ndim=1)
            fe[f"layer{i}"] = DenseEdgeConv(c_in, GROWTH, DENSE_N, KNN)
            feat += c_in + DENSE_N * GROWTH
        self.feature_extraction = nn.ModuleDict(fe)
        self.up_projection_unit = nn.ModuleDict(dict(
            conv0=Conv1x1(feat, FEAT), up_0=UpBlock(expand),
            down_0=DownBlock(expand), up_1=UpBlock(expand)))
        self.fc_layer1 = Conv1x1(FEAT, COORD_MLP[0])
        self.fc_layer2 = Conv1x1(*COORD_MLP)

    def _extract(self, chain_kernel: bool, xyz: torch.Tensor):
        """``(features (P, N, 480), each edge conv's kNN (P, N, k)...)``."""
        fe = self.feature_extraction
        dup = duplicate_mask(xyz)
        x = dense(fe["layer0"], xyz, relu=False)
        nn_idx = []
        for i in range(1, 5):
            inp = x if i == 1 else dense(fe[f"layer{i}_prep"], x)
            y, idx = fe[f"layer{i}"](inp, dup, chain_kernel)
            x = torch.cat([y, x], dim=-1)
            nn_idx.append(idx)
        return (x, *nn_idx)

    def _conv0(self, feat: torch.Tensor) -> torch.Tensor:
        return dense(self.up_projection_unit["conv0"], feat)

    def _down(self, h: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        return self.up_projection_unit["down_0"](h, low.shape[1]) - low

    def _coords(self, h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
        return dense(self.fc_layer2, dense(self.fc_layer1, h0 + h1),
                     relu=False)

    def _sample(self, coords: torch.Tensor):
        picks = fps(coords, self.num_point * self.up_ratio)
        return picks, gather_nd(coords, picks)

    def _up(self, run, j: int, x: torch.Tensor) -> torch.Tensor:
        block = self.up_projection_unit[f"up_{j}"]
        name = f"pugan.up{j}"
        with span(name):
            x, f, g, h = run(name + ".units", block.units, x)
            with span(name + ".attention"):
                o = run(name + ".attention", attention, g, f, h)
            return run(name + ".mlp", block.mlp, o, x)

    @torch.no_grad()
    def upsample(self, xyz: torch.Tensor, ratio: Optional[int] = None,
                 capture: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Normalized patches ``(P, num_point, 3)`` -> ``(P, up_ratio *
        num_point, 3)`` in the same frame.  The edge convs take the chain
        kernel where :func:`edgeconv.takes_kernel` says so.  ``capture``,
        when given, receives ``extract.nn<i>`` (edge conv ``i``'s kNN),
        ``extract.features``, ``up_down_up.features`` (``H``),
        ``coords`` (the ``M`` candidates) and ``fps.picks``."""
        if ratio not in (None, self.up_ratio):
            raise ValueError(f"PUGAN upsamples {self.up_ratio}x; asked for "
                             f"{ratio}x")
        p, n, _ = xyz.shape
        if n != self.num_point:
            raise ValueError(f"PUGAN takes patches of {self.num_point} "
                             f"points; got {n}")
        xyz = xyz.to(torch.float32)
        chain_kernel = edgeconv.takes_kernel(xyz, DENSE_N, GROWTH)
        run = self.stages_for(xyz)
        with span("pugan.extract", on=xyz):
            feat, *nn_idx = run("pugan.extract",
                                partial(self._extract, chain_kernel), xyz)
        with span("pugan.up_down_up", on=xyz):
            low = run("pugan.conv0", self._conv0, feat)
            h0 = self._up(run, 0, low)
            with span("pugan.down"):
                e0 = run("pugan.down", self._down, h0, low)
            h1 = self._up(run, 1, e0)
        with span("pugan.coords", on=xyz):
            coords = run("pugan.coords", self._coords, h0, h1)
        with span("pugan.fps", on=xyz):
            picks, out = run("pugan.fps", self._sample, coords)
        if capture is not None:
            kept = {f"extract.nn{i}": t for i, t in enumerate(nn_idx, 1)}
            kept.update({"extract.features": feat, "coords": coords,
                         "fps.picks": picks})
            capture.update({k: run.own(t) for k, t in kept.items()})
            capture["up_down_up.features"] = h0 + h1
        return run.own(out)
