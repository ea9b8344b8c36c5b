"""The plain reference of the 3PU nets that the benchmark holds the
program to.

Plain PyTorch, float32, no kernels: a frozen copy of the algorithm the
program runs (the eval cascade with its static-shape masking, the
pipeline's seed grouping and hierarchical re-stitch, the train cascade,
the Chamfer loss and the clipped Adam step), written against the
parameters in the JAX checkpoint layout (``"level_1/layer0/conv"`` ->
``(kernel (in, out), bias)``).  It imports neither ``jax``, ``threepu``
nor ``threepu_torch``, and takes nothing the program made: it loads the
weights and the optimizer state from the ``.npz`` itself, or takes the
weights the benchmark made from the seed.

Every float32 matrix product goes through :meth:`Arith.mm`.  With
``tf32=True`` its operands are rounded to TF32 (10 mantissa bits, round
to nearest even) before a float32 product, as the tensor cores take
them: that is the control, the precision one step below the float32
(TF32 off) that the configurations state.

Where an order of operations decides a selection (kNN ranks, FPS picks,
nearest-neighbour argmins), the reference computes it as the program's
plain versions do, so that on the same inputs both pick alike; a
replayed selection (:class:`Arith` ``replay``) takes the program's
choice instead and counts how many of them equal its own.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PENALTY = 1e30
INIT_DIST = 1e10
INT32_MAX = 2**31 - 1
#: clouds above this many points take the hierarchical FPS
HIER_MAX_N = 480_000
#: the pipeline's re-stitch: G=8 groups from 16384 output points up
RESTITCH_GROUPS = 8
RESTITCH_MIN_OUT = 16384
#: duplicate test: direct comparison up to this size and budget
DIRECT_MAX_N = 8192
DIRECT_BUDGET = DIRECT_MAX_N * DIRECT_MAX_N * 3

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


# ------------------------------------------------------------ arithmetic
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even; finite values only."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        # undo broadcasting over leading axes
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        for i, (s, t) in enumerate(zip(ga.shape, a.shape)):
            if s != t:
                ga = ga.sum(i, keepdim=True)
        for i, (s, t) in enumerate(zip(gb.shape, b.shape)):
            if s != t:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


class Arith:
    """How the reference multiplies and selects.

    ``tf32``: products in TF32 (the control).  ``replay``: ``{site:
    iterator of index tensors}``; a selection at a replayed site takes the
    next recorded indices, and ``agree[site]`` counts ``[equal, total]``
    against the reference's own choice.  ``record``: ``{site: list}``
    that receives every index tensor the reference chooses itself.
    Sites: ``select`` (every k-smallest selection), ``interlevel`` (the
    skip's picks), ``chamfer`` (the argmins, forward then backward
    direction)."""

    def __init__(self, tf32: bool = False,
                 replay: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
                 record: Optional[Dict[str, list]] = None):
        self.tf32 = tf32
        self.replay = (None if replay is None
                       else {k: iter(v) for k, v in replay.items()})
        self.agree = {k: [0, 0] for k in (replay or {})}
        self.record = record

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32Matmul.apply(a, b)
        return torch.matmul(a, b)

    def decide(self, site: str, own: torch.Tensor) -> torch.Tensor:
        """``own`` (the reference's indices), or the replayed ones."""
        if self.record is not None:
            self.record.setdefault(site, []).append(own.detach())
        if self.replay is None or site not in self.replay:
            return own
        got = next(self.replay[site], None)
        if got is None or got.numel() != own.numel():
            raise ValueError(f"the replayed {site} decisions do not fit "
                             "this step")
        got = got.to(own.device).reshape(own.shape).to(own.dtype)
        self.agree[site][0] += int((got == own).sum())
        self.agree[site][1] += own.numel()
        return got

    def replay_left(self) -> List[str]:
        """Sites whose recorded decisions were not all taken."""
        if self.replay is None:
            return []
        return [k for k, it in self.replay.items()
                if next(it, None) is not None]


# ------------------------------------------------------------- geometry
def pairwise_dist2(A: Arith, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a|^2 - 2 a.b + |b|^2``, ``(..., N, M)``."""
    r_a = torch.sum(a * a, dim=-1, keepdim=True)
    r_b = torch.sum(b * b, dim=-1, keepdim=True)
    inner = A.mm(a, b.transpose(-1, -2))
    return r_a - 2.0 * inner + r_b.transpose(-1, -2)


def sq_dist3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(dx*dx + dy*dy) + dz*dz``, each product rounded on its own."""
    dx, dy, dz = (a - b).unbind(-1)
    return dx * dx + dy * dy + dz * dz


def duplicate_mask(points: torch.Tensor) -> torch.Tensor:
    """True where a row equals an earlier row (keep-first)."""
    *batch, n, c = points.shape
    flat = points.reshape(-1, n, c).to(torch.float32)
    b = flat.shape[0]
    if n <= DIRECT_MAX_N and b * n * n * c <= DIRECT_BUDGET:
        eq = torch.all(flat[:, :, None, :] == flat[:, None, :, :], dim=-1)
        col = torch.arange(n, device=points.device)
        earlier = col[None, :] < col[:, None]
        return torch.any(eq & earlier, dim=-1).reshape(*batch, n)
    rows = flat + 0.0
    order = torch.arange(n, device=points.device).expand(b, n)
    for col in range(c - 1, -1, -1):
        perm = torch.sort(rows[..., col], dim=-1, stable=True).indices
        order = torch.gather(order, 1, perm)
        rows = torch.gather(rows, 1, perm[..., None].expand(b, n, c))
    eq_prev = torch.all(rows[:, 1:] == rows[:, :-1], dim=-1)
    dup_sorted = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                        device=points.device), eq_prev], 1)
    mask = torch.zeros((b, n), dtype=torch.bool, device=points.device)
    mask.scatter_(1, order, dup_sorted)
    return mask.reshape(*batch, n)


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (..., M, C)``, ``idx (..., X...)`` -> ``(..., X..., C)``."""
    batch = points.shape[:-2]
    extra = idx.shape[len(batch):]
    c = points.shape[-1]
    flat = idx.reshape(*batch, -1).long()
    out = torch.gather(points, -2, flat[..., None].expand(*flat.shape, c))
    return out.reshape(*batch, *extra, c)


def normalize_batch(pc: torch.Tensor):
    centroid = torch.mean(pc, dim=-2, keepdim=True)
    pc = pc - centroid
    radius = torch.amax(torch.sqrt(torch.sum(pc * pc, dim=-1, keepdim=True)),
                        dim=-2, keepdim=True)
    return pc / radius, centroid, radius


def normalize_cloud(pc: np.ndarray):
    """numpy ``(N, 3)`` -> ``(normalized, centroid, furthest)``."""
    centroid = np.mean(pc, axis=0, keepdims=True)
    pc = pc - centroid
    furthest = np.amax(np.sqrt(np.sum(pc ** 2, axis=-1, keepdims=True)),
                       axis=0, keepdims=True)
    return pc / furthest, centroid, furthest


def select(A: Arith, d: torch.Tensor, k: int):
    """The k smallest of each row, ascending, ties to the lowest index."""
    values, idx = torch.sort(d, dim=-1, stable=True)
    idx = A.decide("select", idx[..., :k].to(torch.int32))
    return torch.gather(d, -1, idx.long()), idx


def knn(A: Arith, query, points, k: int, unique: bool = False,
        valid_mask=None, dup_mask=None, with_neighbors: bool = True):
    """``(neighbors or None, idx)`` of the k nearest ``points`` around
    each ``query``; duplicates (``unique``) and invalid points ranked
    last by a 1e30 penalty."""
    d = pairwise_dist2(A, query, points)
    penalty = None
    if unique:
        penalty = duplicate_mask(points) if dup_mask is None else dup_mask
    if valid_mask is not None:
        penalty = ~valid_mask if penalty is None else (penalty | ~valid_mask)
    if penalty is not None:
        d = d.masked_fill(penalty[..., None, :], PENALTY)
    _, idx = select(A, d, k)
    return (gather_rows(points, idx) if with_neighbors else None), idx


def fps(points: torch.Tensor, m: int, valid_mask=None) -> torch.Tensor:
    """``(B, N, 3)`` -> ``(B, m)`` int32 picks: first valid index, carry
    1e10, largest carry next (ties low), never a masked or non-finite
    point while a valid one is left."""
    b = points.shape[0]
    points = points.to(torch.float32)
    finite = torch.all(torch.isfinite(points), dim=-1)
    points = torch.where(finite[..., None], points, torch.zeros_like(points))
    mask = finite if valid_mask is None else (valid_mask & finite)
    rows = torch.arange(b, device=points.device)
    last = torch.argmax(mask.to(torch.int32), dim=-1)
    temp = torch.where(mask, torch.full_like(points[..., 0], INIT_DIST),
                       torch.full_like(points[..., 0], float("-inf")))
    picks = [last]
    for _ in range(m - 1):
        diff = points - points[rows, last][:, None, :]
        dx, dy, dz = diff.unbind(-1)
        temp = torch.minimum(temp, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(temp, dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def morton(points: torch.Tensor, valid_mask: torch.Tensor,
           bits: int = 10) -> torch.Tensor:
    m = valid_mask[..., None]
    inf = torch.tensor(float("inf"), device=points.device)
    lo = torch.amin(torch.where(m, points, inf), dim=-2, keepdim=True)
    hi = torch.amax(torch.where(m, points, -inf), dim=-2, keepdim=True)
    scale = torch.full_like(hi, 2**bits - 1) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((points - lo) * scale).to(torch.int32), 0, 2**bits - 1)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
            | (spread(q[..., 2]) << 2))


def _argsort(key):
    return torch.sort(key, dim=-1, stable=True).indices


def fps_hierarchical(points, m: int, valid_mask=None,
                     group_max: int = HIER_MAX_N) -> torch.Tensor:
    """Morton-sorted cloud spread over ``ceil(N / group_max)`` groups,
    FPS in each, picks interleaved round-robin, invalid picks last."""
    b, n, c = points.shape
    dev = points.device
    groups = -(-n // group_max)
    n_pad = -(-n // groups) * groups
    per = n_pad // groups
    m_per = -(-m // groups)
    pts = torch.nn.functional.pad(points, (0, 0, 0, n_pad - n))
    mask = (torch.arange(n_pad, device=dev) < n)[None, :]
    if valid_mask is not None:
        mask = mask & torch.nn.functional.pad(valid_mask, (0, n_pad - n))
    mask = mask.expand(b, n_pad)
    key = torch.where(mask, morton(pts, mask),
                      torch.tensor(INT32_MAX, dtype=torch.int32, device=dev))
    order = _argsort(key)
    mask_s = torch.gather(mask, 1, order)
    i = torch.arange(n_pad, device=dev)[None, :]
    n_valid = mask_s.sum(dim=-1, keepdim=True)
    vpg = torch.clamp(-(-n_valid // groups), min=1)
    g = torch.clamp(i // vpg, max=groups - 1)
    p_valid = g * per + (i - g * vpg)
    occupied = torch.zeros((b, n_pad), dtype=torch.int32, device=dev)
    occupied = occupied.scatter_reduce(
        1, torch.where(mask_s, p_valid, torch.zeros_like(p_valid)),
        mask_s.to(torch.int32), reduce="amax")
    free = _argsort(occupied)
    s = torch.clamp(i - n_valid, 0, n_pad - 1)
    dest = torch.where(mask_s, p_valid, torch.gather(free, 1, s))
    order = torch.zeros_like(order).scatter(1, dest, order)
    pts = torch.gather(pts, 1, order[..., None].expand(b, n_pad, c))
    mask = torch.gather(mask, 1, order)
    idx = fps(pts.reshape(b * groups, per, c), m_per,
              mask.reshape(b * groups, per))
    offset = (torch.arange(b * groups, device=dev) % groups) * per
    idx = (idx.long() + offset[:, None]).reshape(b, groups, m_per)
    idx = idx.transpose(1, 2).reshape(b, groups * m_per)
    picked_valid = torch.gather(mask, 1, idx)
    keep = _argsort((~picked_valid).to(torch.uint8))
    idx = torch.gather(idx, 1, keep)[:, :m]
    return torch.gather(order, 1, idx).to(torch.int32)


def fps_any(points, m: int, valid_mask=None) -> torch.Tensor:
    if points.shape[-2] > HIER_MAX_N:
        return fps_hierarchical(points, m, valid_mask)
    return fps(points, m, valid_mask)


def self_nn_dist2(A: Arith, points, chunk: int = 2048) -> torch.Tensor:
    n = points.shape[-2]
    cols = torch.arange(n, device=points.device)
    out = []
    for start in range(0, n, chunk):
        rows = points[:, start:start + chunk]
        d = pairwise_dist2(A, rows, points)
        ids = torch.arange(start, start + rows.shape[1], device=points.device)
        d = d.masked_fill(ids[:, None] == cols[None, :], float("inf"))
        out.append(torch.amin(d, dim=-1))
    return torch.cat(out, dim=1)


def nn_one_way(a, b, chunk: int = 1 << 24):
    """Per point of ``a``: ``(min d2, argmin)`` over ``b``, ties low."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    rows = max(1, chunk // max(1, bsz * m))
    dists, idxs = [], []
    for start in range(0, n, rows):
        d = sq_dist3(a[:, start:start + rows, None, :], b[:, None, :, :])
        v, i = torch.min(d, dim=-1)
        dists.append(v)
        idxs.append(i)
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


# ---------------------------------------------------------------- layers
def code_points(step_ratio: int) -> np.ndarray:
    """A level's code: a column linspace(-0.2, 0.2) below step ratio 4,
    else the 2-D grid of ``round(sqrt(r))**2`` points."""
    if step_ratio < 4:
        return np.linspace(-0.2, 0.2, step_ratio,
                           dtype=np.float32).reshape(step_ratio, 1)
    g = round(math.sqrt(round(math.sqrt(step_ratio)) ** 2))
    x = np.linspace(-0.2, 0.2, g, dtype=np.float32)
    gx, gy = np.meshgrid(x, x, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def dense(A: Arith, P: Params, name: str, x, relu: bool = False):
    w, b = P[name]
    y = A.mm(x, w) + b
    return torch.relu(y) if relu else y


def edge_conv(A: Arith, P: Params, name: str, x, dup, k: int, n: int,
              g: int):
    """Densely connected edge convolution on the feature-space kNN graph
    (k + 1 unique neighbours, self dropped): ``[max g_{n-1}, ..., max
    g_0, x]``; the first stage's edge product split by linearity."""
    c = x.shape[-1]
    _, idx = knn(A, x, x, k + 1, unique=True, dup_mask=dup,
                 with_neighbors=False)
    idx = idx[..., 1:]
    w = [P[f"{name}/mlps_{i}"][0] for i in range(n)]
    b = [P[f"{name}/mlps_{i}"][1] for i in range(n)]
    wc, wd = w[0][:c], w[0][c:]
    z = A.mm(x, wd)
    point_term = A.mm(x, wc - wd) + b[0]
    acc = [A.mm(x, w[i][g * i:]) + b[i] for i in range(1, n)]
    zn = gather_rows(z, idx)
    gs = [torch.relu(zn + point_term[..., None, :])]
    for i in range(1, n):
        per_k = None
        for j in range(i):
            term = A.mm(gs[i - 1 - j], w[i][g * j:g * (j + 1)])
            per_k = term if per_k is None else per_k + term
        y = per_k + acc[i - 1][..., None, :]
        gs.append(y if i == n - 1 else torch.relu(y))
    pooled = [torch.amax(gi, dim=-2) for gi in reversed(gs)]
    return torch.cat(pooled + [x], dim=-1)


def interlevel(A: Arith, q_xyz, xq, prev_xyz, prev_feat, prev_dup, k: int):
    """The skip: the k spatially nearest previous points of each query
    (direct squared distance, ``prev_dup`` ranked last), weights
    ``exp(-d_s/(h_s/2)) exp(-d_f/(h_f/2))`` normalized by ``sum(w +
    1e-5)`` with no gradient, ``sum w * feature``.  Only ``prev_feat``
    receives a gradient."""
    b, n, _ = q_xyz.shape
    p = prev_xyz.shape[0]
    c = prev_feat.shape[-1]
    with torch.no_grad():
        q = q_xyz.reshape(p, b // p * n, 1, 3)
        idx = []
        for t in range(p):
            d = sq_dist3(q[t], prev_xyz[t][None])
            d = d.masked_fill(prev_dup[t][None], PENALTY)
            idx.append(torch.sort(d, dim=-1, stable=True).indices[:, :k])
        idx = torch.stack(idx)
        idx = A.decide("interlevel",
                       idx.reshape(b, n, k).to(torch.int32)).reshape(p, -1, k)
        nbrs = gather_rows(prev_xyz, idx).reshape(b, n, k, 3)
        feats = gather_rows(prev_feat.detach(), idx).reshape(b, n, k, c)
        d_s = sq_dist3(q_xyz[:, :, None, :], nbrs)
        diff = xq[:, :, None, :] - feats
        d_f = torch.sum(diff * diff, dim=-1)
        h_s = torch.mean(torch.amin(d_s, dim=-1), dim=-1)[:, None, None]
        h_f = torch.mean(torch.amin(d_f, dim=-1), dim=-1)[:, None, None]
        w = torch.exp(-d_s / (h_s / 2.0)) * torch.exp(-d_f / (h_f / 2.0))
        w = w / torch.sum(w + 1e-5, dim=-1, keepdim=True)
    feats = gather_rows(prev_feat, idx).reshape(b, n, k, c)
    return torch.sum(w[..., None] * feats, dim=-2)


class NetSpec:
    """The sizes of one net (a configuration file's ``net``)."""

    def __init__(self, max_up_ratio=16, step_ratio=2, knn=32,
                 growth_rate=12, dense_n=3, max_num_point=312, fm_knn=5):
        self.max_up_ratio = max_up_ratio
        self.step_ratio = step_ratio
        self.knn = knn
        self.growth_rate = growth_rate
        self.dense_n = dense_n
        self.max_num_point = max_num_point
        self.fm_knn = fm_knn

    def levels(self, ratio: Optional[int] = None) -> int:
        return int(math.log(ratio or self.max_up_ratio, self.step_ratio))


def level_forward(A: Arith, P: Params, spec: NetSpec, l: int, xyz, xyz_n,
                  prev=None, prev_group: int = 1, prev_dup=None):
    """One level: ``(upsampled (B, N*r, 3) in the normalized frame,
    point features (B, N, C))``."""
    b, n, _ = xyz_n.shape
    name = f"level_{l}"
    dup = duplicate_mask(xyz_n)
    x = dense(A, P, f"{name}/layer0/conv", xyz_n)
    for i in (1, 2, 3, 4):
        inp = x if i == 1 else dense(A, P, f"{name}/layer{i}_prep/conv", x,
                                     relu=True)
        y = edge_conv(A, P, f"{name}/layer{i}", inp, dup, spec.knn,
                      spec.dense_n, spec.growth_rate)
        x = torch.cat([y, x], dim=-1)
    if prev is not None and spec.fm_knn > 0:
        prev_xyz, prev_feat = prev
        if prev_dup is None:
            prev_dup = duplicate_mask(prev_xyz)
        if prev_xyz.shape[0] * prev_group != b:
            raise ValueError("previous set batch times prev_group must "
                             "equal the batch")
        x = 0.2 * interlevel(A, xyz, x, prev_xyz, prev_feat, prev_dup,
                             spec.fm_knn) + x
    feats = x
    code = torch.from_numpy(code_points(spec.step_ratio)).to(x)
    r, c = code.shape[0], x.shape[-1]
    x = x[:, :, None, :].expand(b, n, r, c).reshape(b, n * r, c)
    x = torch.cat([x, code[None, None].expand(b, n, r, -1)
                   .reshape(b, n * r, -1)], dim=-1)
    x = dense(A, P, f"{name}/up_layer1/conv", x, relu=True)
    x = dense(A, P, f"{name}/up_layer2/conv", x, relu=True)
    x = dense(A, P, f"{name}/fc_layer1/conv", x, relu=True)
    x = dense(A, P, f"{name}/fc_layer2/conv", x)
    residual = xyz_n[:, :, None, :].expand(b, n, r, 3).reshape(b, n * r, 3)
    return x + residual, feats


# ------------------------------------------------------------- cascades
def eval_cascade(A: Arith, spec: NetSpec, xyz, ratio: int, level):
    """The eval cascade's glue on normalized patches ``xyz (P, N, 3)``:
    ``level(l, args, kwargs) -> (new_xyz, feats)`` runs each level (the
    reference's own :func:`level_forward`, or a replay of the
    program's).  Returns ``(P, N*ratio, 3)``."""
    num_levels = spec.levels(ratio)
    p, num_point, _ = xyz.shape
    max_np = min(num_point, spec.max_num_point)
    dev = xyz.device
    old_xyz = xyz
    xyz, old_feats = level(1, (xyz, xyz), {})
    prev_invalid = None
    for l in range(2, num_levels + 1):
        n_cur = xyz.shape[1]
        if n_cur <= max_np:
            norm, centroid, radius = normalize_batch(xyz)
            new_xyz, feats = level(l, (xyz, norm, (old_xyz, old_feats)), {})
            old_xyz, old_feats, prev_invalid = xyz, feats, None
            xyz = new_xyz * radius + centroid
            continue
        n_sub = int(n_cur / max_np * 5)
        closest = self_nn_dist2(A, xyz)
        mask = closest < 5.0 * torch.mean(closest, dim=-1, keepdim=True)
        n_valid = torch.sum(mask, dim=-1)
        true_sub = torch.clamp((n_valid * 5) // max_np, 1, n_sub)
        seeds = gather_rows(xyz, fps(xyz, n_sub, mask))
        sub, _ = knn(A, seeds, xyz, max_np, valid_mask=mask)
        flat = sub.reshape(p * n_sub, max_np, 3)
        norm, centroid, radius = normalize_batch(flat)
        prev_dup = duplicate_mask(old_xyz)
        if prev_invalid is not None:
            prev_dup = prev_dup | prev_invalid
        new_xyz, feats = level(l, (flat, norm, (old_xyz, old_feats)),
                               dict(prev_group=n_sub, prev_dup=prev_dup))
        new_xyz = new_xyz * radius + centroid
        patch_valid = (torch.arange(n_sub, device=dev)[None, :]
                       < true_sub[:, None])
        n_lvl = new_xyz.shape[1]
        merged = new_xyz.reshape(p, n_sub * n_lvl, 3)
        merge_valid = patch_valid[:, :, None].expand(
            p, n_sub, n_lvl).reshape(p, -1)
        sel = fps_any(merged, num_point * spec.step_ratio ** l, merge_valid)
        xyz = gather_rows(merged, sel)
        old_xyz = flat.reshape(p, n_sub * max_np, 3)
        old_feats = feats.reshape(p, n_sub * max_np, -1)
        prev_invalid = ~patch_valid[:, :, None].expand(
            p, n_sub, max_np).reshape(p, -1)
    return xyz


def plan_patches(n: int, num_point: int, patch_num_ratio: float,
                 chunk: Optional[int], n_dev: int = 1):
    num_patches = max(int(n / num_point * patch_num_ratio), 1)
    local = -(-num_patches // n_dev)
    if chunk is None or chunk >= local:
        chunk = local
    padded = -(-num_patches // (chunk * n_dev)) * chunk * n_dev
    return num_patches, padded, chunk


def seed_patches(A: Arith, data: torch.Tensor, num_point: int,
                 patch_num_ratio: float, chunk: Optional[int], n_dev: int = 1):
    """The pipeline's start on one normalized shape ``(N, 3)``: seed FPS,
    kNN grouping, padding to whole chunks, per-patch normalization.
    Returns ``(norm, centroid, radius, num_patches, padded, chunk)``."""
    num_patches, padded, chunk = plan_patches(
        data.shape[0], num_point, patch_num_ratio, chunk, n_dev)
    shape_b = data[None]
    seeds = gather_rows(shape_b, fps_any(shape_b, num_patches))
    patches = knn(A, seeds, shape_b, num_point)[0][0]
    if padded != num_patches:
        patches = torch.cat([patches, patches[:1].expand(
            padded - num_patches, -1, -1)], 0)
    norm, centroid, radius = normalize_batch(patches)
    return norm, centroid, radius, num_patches, padded, chunk


def restitch(up: torch.Tensor, num_patches: int, num_out: int) -> torch.Tensor:
    """The final re-stitch of the denormalized patches ``up (padded,
    M, 3)`` to ``(num_out, 3)``: padding patches masked out, G=8
    hierarchical FPS from 16384 output points up."""
    padded, per_patch, _ = up.shape
    merged = up.reshape(1, padded * per_patch, 3)
    valid = None
    if padded != num_patches:
        valid = torch.arange(padded, device=up.device)[:, None] < num_patches
        valid = valid.expand(padded, per_patch).reshape(1, -1)
    if num_out >= RESTITCH_MIN_OUT:
        group_max = min(-(-merged.shape[1] // RESTITCH_GROUPS), HIER_MAX_N)
        idx = fps_hierarchical(merged, num_out, valid, group_max)
    else:
        idx = fps_any(merged, num_out, valid)
    return gather_rows(merged, idx)[0]


def train_cascade(A: Arith, P: Params, spec: NetSpec, xyz, gt, ratio: int,
                  seed_idx: Sequence[torch.Tensor]):
    """The train cascade: re-patching to ``max_num_point`` points around
    the given seeds where a level's input grows past it.  Returns
    ``(pred, gt patch)``."""
    num_levels = spec.levels(ratio)
    max_np = min(xyz.shape[1], spec.max_num_point)
    seeds = list(seed_idx)
    old_xyz = xyz
    xyz, old_feats = level_forward(A, P, spec, 1, xyz, xyz)
    for l in range(2, num_levels + 1):
        patch_xyz = xyz
        if xyz.shape[1] > max_np:
            idx = seeds.pop(0).to(xyz.device)
            gt_k = max_np * ratio // spec.step_ratio ** l * spec.step_ratio
            centre = gather_rows(xyz, idx)
            patch_xyz = knn(A, centre, xyz, max_np)[0][:, 0]
            gt = knn(A, centre, gt, gt_k)[0][:, 0]
        norm, centroid, radius = normalize_batch(patch_xyz)
        new_xyz, feats = level_forward(A, P, spec, l, patch_xyz, norm,
                                       (old_xyz, old_feats))
        xyz = new_xyz * radius + centroid
        old_xyz, old_feats = patch_xyz, feats
    if seeds:
        raise ValueError("more re-patch seeds than re-patching levels")
    return xyz, gt


def chamfer_loss(A: Arith, pred, gt, threshold: Optional[float] = None):
    """Mean over clouds of the two directions' mean squared distance to
    the nearest point; with ``threshold``, distances not below
    ``threshold * mean`` count as zero."""
    with torch.no_grad():
        _, i1 = nn_one_way(pred.detach(), gt.detach())
        _, i2 = nn_one_way(gt.detach(), pred.detach())
    i1 = A.decide("chamfer", i1)
    i2 = A.decide("chamfer", i2)
    d1 = sq_dist3(pred, gather_rows(gt, i1))
    d2 = sq_dist3(gt, gather_rows(pred, i2))
    if threshold is not None:
        d1 = torch.where(d1 < torch.mean(d1, 1, keepdim=True) * threshold,
                         d1, torch.zeros_like(d1))
        d2 = torch.where(d2 < torch.mean(d2, 1, keepdim=True) * threshold,
                         d2, torch.zeros_like(d2))
    return torch.mean(torch.mean(d1, 1) + torch.mean(d2, 1))


def loss_weight(ratio: int, max_up_ratio: int, step_ratio: int) -> float:
    """``max(1, log_step(max / r))``: the floored per-ratio weight."""
    return max(1.0, math.log(max_up_ratio / ratio, step_ratio))


# ------------------------------------------------------------ optimizer
class Adam:
    """Adam (0.9, 0.999, eps 1e-8) after clipping every gradient element
    to [-1, 1]; every parameter steps, a zero gradient where the loss
    did not reach it.  ``m``, ``v``: per parameter; ``count``: steps
    taken."""

    def __init__(self, lr: float, m: Dict[str, torch.Tensor],
                 v: Dict[str, torch.Tensor], count: int):
        self.lr, self.m, self.v, self.count = lr, m, v, count

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, Optional[torch.Tensor]]) -> None:
        self.count += 1
        t = self.count
        bc1 = 1 - 0.9 ** t
        bc2 = 1 - 0.999 ** t
        with torch.no_grad():
            for k, p in params.items():
                g = grads.get(k)
                g = torch.zeros_like(p) if g is None else g.clamp(-1.0, 1.0)
                self.m[k].mul_(0.9).add_(g, alpha=0.1)
                self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(1e-8)
                p.addcdiv_(self.m[k], denom, value=-(self.lr / bc1))


def train_step(A: Arith, P: Dict[str, torch.Tensor], spec: NetSpec,
               opt: Adam, inp, gt, ratio: int, seed_idx,
               threshold: Optional[float] = None):
    """One step on the flat parameters ``P`` (``"<path>/kernel|bias"``
    leaves, updated in place): returns ``(unweighted loss, clipped
    gradients as the optimizer got them)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    pairs = {k[:-len("/kernel")]: (leaves[k], leaves[k[:-len("kernel")]
                                                      + "bias"])
             for k in leaves if k.endswith("/kernel")}
    pred, gt_out = train_cascade(A, pairs, spec, inp, gt, ratio, seed_idx)
    cd = chamfer_loss(A, pred, gt_out, threshold)
    weighted = cd * loss_weight(ratio, spec.max_up_ratio, spec.step_ratio)
    used = [k for k, v in leaves.items()]
    grads = torch.autograd.grad(weighted, [leaves[k] for k in used],
                                allow_unused=True)
    grads = dict(zip(used, grads))
    opt.step(P, grads)
    clipped = {k: (torch.zeros_like(P[k]) if g is None
                   else g.clamp(-1.0, 1.0)) for k, g in grads.items()}
    return cd.detach(), clipped


# ------------------------------------------------------------- loading
PARAM_PREFIX = "params/"
_LEAF = re.compile(r"^\[1\]\[0\]\.(count|mu|nu)((?:\['[^']*'\])*)$")


def load_params(path: str, device) -> Dict[str, torch.Tensor]:
    """``{"level_1/layer0/conv/kernel": tensor, ...}`` from a JAX-layout
    ``.npz``; kernels ``(in, out)``."""
    with np.load(path) as data:
        return {k[len(PARAM_PREFIX):]: torch.from_numpy(
                    np.asarray(data[k], np.float32)).to(device)
                for k in data.files if k.startswith(PARAM_PREFIX)}


def load_adam(path: str, device):
    """``(count, m, v)`` of the checkpoint's clipped-Adam state, keyed as
    :func:`load_params` keys the parameters."""
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k.startswith("opt/"))
        leaves = [data[k] for k in keys]
        fingerprint = str(data["opt_treedef"])
    count, m, v = 0, {}, {}
    for key, leaf in zip(fingerprint.split("|")[1:], leaves):
        hit = _LEAF.match(key)
        if hit is None:
            raise ValueError(f"{path}: optimizer leaf {key!r} is not Adam's")
        field = hit.group(1)
        name = "/".join(re.findall(r"\['([^']*)'\]", hit.group(2)))
        if field == "count":
            count = int(leaf)
        else:
            (m if field == "mu" else v)[name] = torch.from_numpy(
                np.asarray(leaf, np.float32)).to(device)
    return count, m, v


def pairs_of(flat: Dict[str, torch.Tensor]) -> Params:
    """``{"<path>/kernel": k, "<path>/bias": b}`` -> ``{path: (k, b)}``."""
    return {k[:-len("/kernel")]: (v, flat[k[:-len("kernel")] + "bias"])
            for k, v in flat.items() if k.endswith("/kernel")}
