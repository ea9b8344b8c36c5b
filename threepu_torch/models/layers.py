"""Network building blocks (port of ``threepu/models/layers.py``).

Parameters carry the reference's state-dict names and shapes: a 1x1
convolution's ``weight`` is ``(out, in, 1)`` for the ``*_prep`` layers
and ``(out, in, 1, 1)`` everywhere else, so trained weights converted by
:func:`threepu_torch.io.weights.state_dict_from_jax` load with
``strict=True``.  The convolutions are computed as channels-last dense
products ``x @ W^T + b``, not through cuDNN.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from threepu_torch.ops.edgeconv import edge_conv_chain
from threepu_torch.ops.gather import batched_gather
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
        (the JAX package's ``pallas=True``); only the per-point products
        stay here.  Eval paths set it, under ``torch.no_grad()``."""
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
        if chain_kernel:
            # the same products as below, so both paths see the same
            # per-point terms; the chain blocks are views of the weights
            chain_w = [w[i][g * j:g * (j + 1)] for i in range(1, self.n)
                       for j in range(i)]
            pooled = edge_conv_chain(z, idx, [point_term, *acc], chain_w,
                                     self.n, g)
            return torch.cat([pooled, x], dim=-1), idx
        zn = batched_gather(z, idx)                          # (B, N, k, G)
        gs: List[torch.Tensor] = [torch.relu(zn + point_term[..., None, :])]
        for i in range(1, self.n):
            per_k = None
            for j in range(i):
                term = gs[i - 1 - j] @ w[i][g * j:g * (j + 1)]
                per_k = term if per_k is None else per_k + term
            y = per_k + acc[i - 1][..., None, :]
            gs.append(y if i == self.n - 1 else torch.relu(y))
        pooled = [torch.amax(gi, dim=-2) for gi in reversed(gs)]
        return torch.cat(pooled + [x], dim=-1), idx
