"""The work the algorithm needs, counted from the shapes a cell runs, and
the card's published peaks: the numerators of the roofline shares and of
``mfu``.  Nothing here reads a kernel's launch arguments; every count
follows from a configuration's sizes and a traffic mix's.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s in float32 outside
the tensor cores, the precision the configurations state (TF32 off), and
3.35 TB/s of HBM.  A roofline share is the least time the card could
take, the larger of operations over the first and bytes over the second
(each input byte read once, each output byte written once), over the
device time of the kernels mapped to the operation.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

from portbench import reference as R

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: operations a candidate point costs the FPS scan (3 subtractions, 3
#: products, 2 sums, the running min and the argmax compare) and the
#: k-smallest selection (one compare)
FPS_OPS_PER_POINT = 10
SELECT_OPS_PER_CANDIDATE = 1
#: the interlevel skip: a candidate's direct distance and compare, and a
#: pick's feature distance (3 a channel) and weighted sum (2 a channel)
INTERLEVEL_OPS_PER_CANDIDATE = 9
INTERLEVEL_OPS_PER_PICK_CHANNEL = 5


class Bound(NamedTuple):
    seconds: float
    by: str           # "operations" or "bytes"
    ops: float
    nbytes: float


def bound(ops: float, nbytes: float) -> Bound:
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return Bound(max(t_ops, t_bytes),
                 "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def total(bounds: List[Bound]) -> Bound:
    """The bounds of several calls: their least times add; ``by`` names
    the bound of the largest share of that time."""
    if not bounds:
        return Bound(0.0, "operations", 0.0, 0.0)
    by_ops = sum(b.seconds for b in bounds if b.by == "operations")
    return Bound(sum(b.seconds for b in bounds),
                 "operations" if by_ops * 2 >= sum(b.seconds for b in bounds)
                 else "bytes",
                 sum(b.ops for b in bounds), sum(b.nbytes for b in bounds))


def fps_bound(b: int, n_valid: int, m: int) -> Bound:
    """FPS of ``m`` picks in ``b`` clouds of ``n_valid`` valid points:
    every pick after the first scans every valid point; the points
    (12 bytes) and their mask (1) in, the picks (4) out."""
    ops = float(b) * n_valid * max(m - 1, 0) * FPS_OPS_PER_POINT
    return bound(ops, b * n_valid * 13.0 + b * m * 4.0)


def select_bound(rows: int, n: int, k: int) -> Bound:
    """The k smallest of each of ``rows`` rows of ``n`` float32
    candidates: one compare a candidate; the matrix in, values and int32
    indices out."""
    return bound(float(rows) * n * SELECT_OPS_PER_CANDIDATE,
                 rows * n * 4.0 + rows * k * 8.0)


class Level(NamedTuple):
    """One level of a cascade as a cell runs it: ``b`` patches of ``n``
    points, ``m_prev`` candidates a query in the interlevel skip (0 on
    the first level), ``sub`` sub-patches a top patch (0: none)."""
    level: int
    b: int
    n: int
    m_prev: int
    sub: int
    n_cur: int        # points a top patch enters the level with


def eval_levels(net: dict, chunk: int, num_point: int, ratio: int
                ) -> List[Level]:
    """The eval cascade's levels for one chunk of ``chunk`` patches of
    ``num_point`` points (``Net.upsample``): a level whose input
    outgrows ``max_num_point`` runs ``int(n / max * 5)`` sub-patches of
    ``max_num_point`` points a top patch."""
    step = net["step_ratio"]
    max_np = min(num_point, net["max_num_point"])
    levels = [Level(1, chunk, num_point, 0, 0, num_point)]
    n_cur, prev = num_point * step, num_point
    for l in range(2, int(round(math.log(ratio, step))) + 1):
        if n_cur <= max_np:
            levels.append(Level(l, chunk, n_cur, prev, 0, n_cur))
            prev, n_cur = n_cur, n_cur * step
            continue
        sub = int(n_cur / max_np * 5)
        levels.append(Level(l, chunk * sub, max_np, prev, sub, n_cur))
        prev, n_cur = sub * max_np, num_point * step ** l
    return levels


def train_levels(net: dict, batch: int, num_point: int, ratio: int
                 ) -> List[Level]:
    """The train cascade's levels: every level past the first re-patches
    to ``max_num_point`` points around one seed."""
    step = net["step_ratio"]
    max_np = min(num_point, net["max_num_point"])
    levels = [Level(1, batch, num_point, 0, 0, num_point)]
    n_cur, prev = num_point * step, num_point
    for l in range(2, int(round(math.log(ratio, step))) + 1):
        n = min(n_cur, max_np)
        levels.append(Level(l, batch, n, prev, 0, n_cur))
        prev, n_cur = n, n * step
    return levels


def code_count(step_ratio: int) -> tuple:
    """``(points, channels)`` of a level's code grid."""
    if step_ratio < 4:
        return step_ratio, 1
    return round(math.sqrt(step_ratio)) ** 2, 2


def level_flops(net: dict, lv: Level) -> Dict[str, float]:
    """fp32 operations of one level's layer equations on ``lv.b``
    patches, by part: ``gemm`` (the dense and edge-conv products, the
    first edge stage split by linearity into per-point products),
    ``dist`` (the feature-space distance matrices of the kNN graphs),
    ``elem`` (biases, ReLUs, the per-edge sums and the max pooling) and
    ``skip`` (the interlevel skip: its candidate scan and weighted sum)."""
    g, n_st, k = net["growth_rate"], net["dense_n"], net["knn"]
    c0 = 24
    block = c0 + n_st * g
    r, code_ch = code_count(net["step_ratio"])
    n = lv.n
    gemm = 2.0 * n * 3 * c0
    elem = float(n * c0)
    dist = 0.0
    feat = c0
    for i in (1, 2, 3, 4):
        if i > 1:
            gemm += 2.0 * n * feat * c0
            elem += 2.0 * n * c0
        dist += 2.0 * n * n * c0 + 3.0 * n * n
        gemm += 2 * 2.0 * n * c0 * g + (n_st - 1) * 2.0 * n * c0 * g
        gemm += sum(s * 2.0 * n * k * g * g for s in range(1, n_st))
        elem += 2.0 * n * k * g + sum((s + 1) * n * k * g
                                      for s in range(1, n_st))
        elem += n_st * n * k * g
        feat += block
    skip = 0.0
    if lv.m_prev:
        skip = (n * lv.m_prev * INTERLEVEL_OPS_PER_CANDIDATE
                + n * net["fm_knn"] * feat * INTERLEVEL_OPS_PER_PICK_CHANNEL
                + 2.0 * n * feat)
    widths = [feat + code_ch, 128, 128, 64, 3]
    for a, b in zip(widths, widths[1:]):
        gemm += 2.0 * n * r * a * b
        elem += 2.0 * n * r * b
    return {key: val * lv.b for key, val in
            dict(gemm=gemm, dist=dist, elem=elem, skip=skip).items()}


def eval_chunk_flops(net: dict, chunk: int, num_point: int, ratio: int
                     ) -> float:
    """The layer equations' operations for one chunk's cascade."""
    return sum(sum(level_flops(net, lv).values())
               for lv in eval_levels(net, chunk, num_point, ratio))


def train_step_flops(net: dict, batch: int, num_point: int, ratio: int
                     ) -> float:
    """Forward and backward of the layer equations for one step: the
    backward of a product is two products (input and weight gradients),
    of an elementwise operation one, of the skip the scatter of its
    weighted picks (2 a channel of a pick); the distance matrices and the
    skip's scan only rank, and have none."""
    fc0 = net["fm_knn"]
    out = 0.0
    for lv in train_levels(net, batch, num_point, ratio):
        f = level_flops(net, lv)
        feat = 24 + 4 * (24 + net["dense_n"] * net["growth_rate"])
        skip_back = (2.0 * lv.b * lv.n * fc0 * feat) if lv.m_prev else 0.0
        out += sum(f.values()) + 2 * f["gemm"] + f["elem"] + skip_back
    return out


def eval_fps_bounds(net: dict, traffic: dict, world: int = 1) -> List[Bound]:
    """One shape's FPS calls on one rank: the seed picks, each chunk's
    sub-patch seeds and merges (every sub-patch real), the re-stitch
    over the valid merged points."""
    n_shape, num_point = traffic["points"], traffic["num_point"]
    ratio, chunk = traffic["ratio"], traffic["chunk"]
    num_patches, padded, chunk = R.plan_patches(
        n_shape, num_point, traffic["patch_num_ratio"], chunk, world)
    out = [fps_bound(1, n_shape, num_patches)]
    step = net["step_ratio"]
    for _ in range(padded // world // chunk):
        for lv in eval_levels(net, chunk, num_point, ratio):
            if lv.sub:
                out.append(fps_bound(chunk, lv.n_cur, lv.sub))
                out.append(fps_bound(chunk, lv.sub * lv.n * _code(net),
                                     num_point * step ** lv.level))
    num_out = n_shape * ratio
    per_patch = num_point * ratio
    groups = 1
    if num_out >= 16384:
        group_max = min(-(-padded * per_patch // 8), 480_000)
        groups = -(-padded * per_patch // group_max)
    valid = num_patches * per_patch
    m_per = -(-num_out // groups)
    out.append(fps_bound(groups, -(-valid // groups), m_per))
    return out


def _code(net: dict) -> int:
    return code_count(net["step_ratio"])[0]


def eval_select_bounds(net: dict, traffic: dict, world: int = 1
                       ) -> List[Bound]:
    """One shape's k-smallest selections at the conv sites on one rank:
    four edge convs a level, each over its patches' ``n x n`` feature
    distances, ``knn + 1`` picked."""
    _, padded, chunk = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"], world)
    out = []
    for _ in range(padded // world // chunk):
        for lv in eval_levels(net, chunk, traffic["num_point"],
                              traffic["ratio"]):
            out += [select_bound(lv.b * lv.n, lv.n, net["knn"] + 1)] * 4
    return out


def train_select_bounds(net: dict, traffic: dict) -> List[Bound]:
    """One step's selections at the conv sites."""
    out = []
    for lv in train_levels(net, traffic["batch_size"], traffic["num_point"],
                           traffic["ratio"]):
        out += [select_bound(lv.b * lv.n, lv.n, net["knn"] + 1)] * 4
    return out


def eval_shape_flops(net: dict, traffic: dict, world: int = 1) -> float:
    """The layer equations' operations of one whole shape over its real
    patches (all ranks; padding patches are not work the shape needs)."""
    num_patches, _, chunk = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"], world)
    return num_patches / chunk * eval_chunk_flops(net, chunk,
                                                  traffic["num_point"],
                                                  traffic["ratio"])
