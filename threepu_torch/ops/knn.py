"""k-nearest-neighbour grouping (port of ``threepu/ops/knn.py``).

Only the exact selection method is ported.  Selection is ordered by
distance, then index: every 1e30 penalty column ties, so the order among
ties is part of the result.  Small-k selections go to the selection
kernel (:func:`threepu_torch.ops.select.select`) under the same gate as
the JAX package's Pallas dispatch (``threepu/ops/knn.py:281-290``);
every other site takes a stable sort.  ``torch.topk`` is never used: it
does not promise the lowest-index-first order among ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from threepu_torch.ops.distances import duplicate_mask, pairwise_dist2
from threepu_torch.ops.gather import batched_gather
from threepu_torch.ops.select import MAX_K, select

#: rank given to duplicate and invalid columns
PENALTY = 1e30
#: the JAX gate's bound on ``M * ceil(N / 128) * 128`` per selection
_SELECT_MAX_BLOCK = 1 << 20
#: whether gated selections go to the selection kernel at all
EXACT_SELECT_KERNEL = True


def set_exact_select_kernel(enabled: bool) -> None:
    """Route gated exact selections through the selection kernel (the
    default), or every selection through the stable sort: the same
    results bit for bit (the JAX package's ``set_exact_select_pallas``)."""
    global EXACT_SELECT_KERNEL
    EXACT_SELECT_KERNEL = bool(enabled)


class KnnResult(NamedTuple):
    neighbors: Optional[torch.Tensor]  # (..., M, k, C) grouped neighbours
    idx: torch.Tensor                  # (..., M, k) int32 indices
    dist2: torch.Tensor                # (..., M, k) ranked distances, ascending


def exact_select(d: torch.Tensor, k: int):
    """``(values, int32 idx)`` of the k smallest per row of ``d (..., M, N)``."""
    m, n = d.shape[-2:]
    if (EXACT_SELECT_KERNEL and k <= MAX_K and m >= 8
            and m * (-(-n // 128) * 128) <= _SELECT_MAX_BLOCK):
        return select(d, k)
    values, idx = torch.sort(d, dim=-1, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def knn_group(query: torch.Tensor, points: torch.Tensor, k: int, *,
              unique: bool = False,
              valid_mask: Optional[torch.Tensor] = None,
              dup_mask: Optional[torch.Tensor] = None,
              with_neighbors: bool = True) -> KnnResult:
    """Group the ``k`` nearest ``points (..., N, C)`` around each
    ``query (..., M, C)``.

    ``unique`` ranks rows that repeat an earlier row behind every
    distinct one (``np.unique`` keep-first semantics; ``dup_mask`` may
    pass that mask precomputed).  ``valid_mask (..., N)`` ranks invalid
    points last.  Both rank by a 1e30 penalty written with ``where``.
    """
    n = points.shape[-2]
    if k > n:
        raise ValueError(f"k={k} exceeds point count {n}")
    d = pairwise_dist2(query, points)                      # (..., M, N)
    penalty = None
    if unique:
        penalty = duplicate_mask(points) if dup_mask is None else dup_mask
    if valid_mask is not None:
        penalty = ~valid_mask if penalty is None else (penalty | ~valid_mask)
    if penalty is not None:
        d = torch.where(penalty[..., None, :],
                        torch.tensor(PENALTY, dtype=d.dtype, device=d.device),
                        d)
    dist2, idx = exact_select(d, k)
    nbrs = batched_gather(points, idx) if with_neighbors else None
    return KnnResult(neighbors=nbrs, idx=idx, dist2=dist2)
