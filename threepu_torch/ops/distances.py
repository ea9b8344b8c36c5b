"""Pairwise distance primitives (port of ``threepu/ops/distances.py``)."""

from __future__ import annotations

import torch

#: direct-comparison cutoff of :func:`duplicate_mask`, and its element
#: budget for the ``(B, N, N, C)`` comparison; larger calls sort instead
#: (the same split as the JAX package, so both take the same branch)
_DIRECT_MAX_N = 8192
_DIRECT_BUDGET = _DIRECT_MAX_N * _DIRECT_MAX_N * 3


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., N, M)`` between ``a (..., N, C)`` and
    ``b (..., M, C)`` in the matmul form ``|a|^2 - 2 a.b + |b|^2``.

    The product goes to ``torch.matmul`` in full float32 (TF32 off, see
    :mod:`threepu_torch.device`), as the JAX package leaves it to XLA
    at ``Precision.HIGHEST``.
    """
    r_a = torch.sum(a * a, dim=-1, keepdim=True)             # (..., N, 1)
    r_b = torch.sum(b * b, dim=-1, keepdim=True)             # (..., M, 1)
    inner = torch.matmul(a, b.transpose(-1, -2))
    return r_a - 2.0 * inner + r_b.transpose(-1, -2)


def direct_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., N, M)`` by direct subtraction: exact for
    equality (``d == 0`` iff the rows are equal).  Memory ``N*M*C``."""
    diff = a[..., :, None, :] - b[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def duplicate_mask(points: torch.Tensor) -> torch.Tensor:
    """``(..., N)`` bool: True where a row equals an EARLIER row — the
    keep-first semantics of ``np.unique(..., return_index=True)``.

    Small inputs compare all pairs directly.  Large ones sort the rows
    lexicographically with three stable sorts (last column first), so
    equal rows land next to each other in original-index order, and
    compare neighbours.
    """
    *batch, n, c = points.shape
    flat = points.reshape(-1, n, c).to(torch.float32)
    b = flat.shape[0]

    if n <= _DIRECT_MAX_N and b * n * n * c <= _DIRECT_BUDGET:
        eq = torch.all(flat[:, :, None, :] == flat[:, None, :, :], dim=-1)
        col = torch.arange(n, device=points.device)
        earlier = col[None, :] < col[:, None]
        return torch.any(eq & earlier, dim=-1).reshape(*batch, n)

    # + 0.0 turns -0.0 into +0.0: the sort keys then order equal values
    # as equal whatever the sort compares (value or bit pattern)
    rows = flat + 0.0
    order = torch.arange(n, device=points.device).expand(b, n)
    for col in range(c - 1, -1, -1):
        perm = torch.sort(rows[..., col], dim=-1, stable=True).indices
        order = torch.gather(order, 1, perm)
        rows = torch.gather(rows, 1, perm[..., None].expand(b, n, c))
    eq_prev = torch.all(rows[:, 1:] == rows[:, :-1], dim=-1)
    dup_sorted = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=points.device),
         eq_prev], dim=1)
    mask = torch.zeros((b, n), dtype=torch.bool, device=points.device)
    mask.scatter_(1, order, dup_sorted)
    return mask.reshape(*batch, n)
