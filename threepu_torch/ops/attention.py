"""Softmax attention over the rows of a patch: the product at the heart of
PU-GAN's ``attention_unit`` (Li et al., ICCV 2019, arXiv:1907.10844),
``softmax(q k^T) v`` over the last axis, unscaled.

This is the port's one attention.  It takes the plain route on every
device: a batched product, a softmax over the keys and a batched
product, in float32 with TF32 off (:mod:`threepu_torch.device`), so the
``(B, M, M)`` score matrix is written to device memory and read back.
A fused kernel that never holds it is left for later; the benchmark's
``pugan.attention_roofline`` counts the work of the result (``q``, ``k``,
``v`` in, the output out), whatever computes it.
"""

from __future__ import annotations

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """``q (B, M, D)``, ``k (B, L, D)``, ``v (B, L, E)`` ->
    ``softmax(q k^T, dim=-1) v``, ``(B, M, E)``, with no scaling of the
    scores."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(scores, dim=-1), v)
