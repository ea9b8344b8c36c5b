"""Network building blocks (port of ``threepu/models/layers.py``).

Parameters carry the reference's state-dict names and shapes: a 1x1
convolution's ``weight`` is ``(out, in, 1)`` for the ``*_prep`` layers
and ``(out, in, 1, 1)`` everywhere else, so trained weights converted by
:func:`threepu_torch.io.weights.state_dict_from_jax` load with
``strict=True``.  The convolutions are computed as channels-last dense
products ``x @ W^T + b``, not through cuDNN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from threepu_torch.ops.edgeconv import edge_conv_chain, edge_conv_chain_plain
from threepu_torch.ops.fps import fps_indices
from threepu_torch.ops.gather import gather_nd
from threepu_torch.ops.knn import knn_group


class Conv1x1(nn.Module):
    """The parameters of a reference 1x1 ``Conv1d`` (``ndim=1``) or
    ``Conv2d`` (``ndim=2``)."""

    def __init__(self, in_features: int, out_features: int, ndim: int = 2):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, *([1] * ndim)))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.xavier_uniform_(self.weight.view(out_features, in_features))

    def matrix(self) -> torch.Tensor:
        """The ``(in, out)`` kernel of the dense product."""
        return self.weight.reshape(self.weight.shape[0], -1).t()


class DenseConv(nn.Module):
    """1x1 convolution over channels-last ``(B, N, C)`` with an optional
    ReLU (the reference's ``Conv1d``/``Conv2d``)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: Optional[str] = None, ndim: int = 2):
        super().__init__()
        if activation not in (None, "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.conv = Conv1x1(in_features, out_features, ndim)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x @ self.conv.matrix() + self.conv.bias
        return torch.relu(x) if self.activation == "relu" else x


class DenseEdgeConv(nn.Module):
    """Densely connected edge convolution (``threepu/models/layers.py``,
    the fused decomposition ``_fused`` of the naive schedule).

    The graph is the feature-space kNN (``k + 1`` neighbours, unique,
    self dropped).  With ``edge = [x, x_nn - x]``, ``mlp_0(edge)`` splits
    into ``gather(x @ W_d) + x @ (W_c - W_d)``, so only ``growth``-wide
    tensors exist per neighbour.  Output: ``[max_k g_{n-1}, ..., max_k
    g_0, x]`` with ``in_features + n * growth`` channels.
    """

    def __init__(self, in_features: int, growth_rate: int, n: int, k: int):
        super().__init__()
        self.growth_rate, self.n, self.k = growth_rate, n, k
        ins = [2 * in_features] + [growth_rate * i + in_features
                                   for i in range(1, n)]
        self.mlps = nn.ModuleList(Conv1x1(i, growth_rate) for i in ins)

    def forward(self, x: torch.Tensor, dup_mask: Optional[torch.Tensor] = None,
                chain_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x (B, N, C)`` -> ``(features (B, N, C + n*growth),
        idx (B, N, k))``.

        ``chain_kernel`` sends everything per neighbour to the fused,
        forward-only :func:`~threepu_torch.ops.edgeconv.edge_conv_chain`
        (the JAX package's ``pallas=True``), else to its plain chain; only
        the per-point products stay here.  Eval paths set it."""
        g, c = self.growth_rate, x.shape[-1]
        idx = knn_group(x, x, self.k + 1, unique=True, dup_mask=dup_mask,
                        with_neighbors=False).idx[..., 1:]
        w = [mlp.matrix() for mlp in self.mlps]
        b = [mlp.bias for mlp in self.mlps]
        wc, wd = w[0][:c], w[0][c:]
        z = x @ wd                                           # (B, N, G)
        point_term = x @ (wc - wd) + b[0]                    # (B, N, G)
        # the per-point part of stages 1 .. n-1 (kernel rows [g_{i-1}, ...,
        # g_0, x])
        acc = [x @ w[i][g * i:] + b[i] for i in range(1, self.n)]
        # the chain blocks are views of the weights
        chain_w = [w[i][g * j:g * (j + 1)] for i in range(1, self.n)
                   for j in range(i)]
        chain = edge_conv_chain if chain_kernel else edge_conv_chain_plain
        pooled = chain(z, idx, [point_term, *acc], chain_w, self.n, g)
        return torch.cat([pooled, x], dim=-1), idx


class SampledDenseEdgeConv(nn.Module):
    """Edge convolution from sampled query points against the whole set
    (``threepu/models/layers.py:297-339``), as :class:`AdaptiveLevel`
    downsamples.

    ``nsample`` points of ``xyz`` are picked by FPS (one: the point
    nearest the centroid); around each, the ``k`` nearest feature rows
    (``k + 1``, unique, the first dropped) form edges ``[c, x_nn - c]``
    through the dense chain (``mlps_0`` with a ReLU and the tiled centre
    appended, then ``y = [mlp_i(y), y]``, ReLU on all but the last), and
    a max over the neighbours.  Output: ``in_features + n * growth``
    channels.
    """

    def __init__(self, in_features: int, growth_rate: int, n: int, k: int):
        super().__init__()
        self.n, self.k = n, k
        ins = [2 * in_features] + [growth_rate * i + in_features
                                   for i in range(1, n)]
        self.mlps = nn.ModuleList(Conv1x1(i, growth_rate) for i in ins)

    def forward(self, x: torch.Tensor, nsample: int, xyz: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x (B, N, C)`` features of the points ``xyz (B, N, 3)`` ->
        ``(y (B, nsample, C'), sampled xyz (B, nsample, 3), sampled idx
        (B, nsample) int32)``."""
        if nsample == 1:
            centroid = torch.mean(xyz, dim=-2, keepdim=True)
            res = knn_group(centroid, xyz, 1)
            sampled_xyz, sampled_idx = res.neighbors[..., 0, :], res.idx[..., 0]
        else:
            sampled_idx = fps_indices(xyz, nsample)
            sampled_xyz = gather_nd(xyz, sampled_idx)
        center = gather_nd(x, sampled_idx)[..., None, :]         # (B, S, 1, C)
        nbrs = knn_group(center[..., 0, :], x, self.k + 1,
                         unique=True).neighbors[..., 1:, :]      # (B, S, k, C)
        center = center.expand_as(nbrs)
        y = torch.cat([center, nbrs - center], dim=-1)
        for i, mlp in enumerate(self.mlps):
            out = y @ mlp.matrix() + mlp.bias
            if i == 0:
                y = torch.cat([torch.relu(out), center], dim=-1)
            else:
                y = torch.cat([out if i == self.n - 1 else torch.relu(out), y],
                              dim=-1)
        return torch.amax(y, dim=-2), sampled_xyz, sampled_idx
