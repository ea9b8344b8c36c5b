"""The work of a PU-GAN shape, counted from the configuration's widths and
the traffic's sizes, for ``mfu.pugan_eval``, ``pugan.attention_roofline``
and ``pugan.fps_roofline`` (the peaks and :func:`portbench.work.bound`
are :mod:`portbench.work`'s).

The layer equations' operations are the products, two a multiply-add, as
published: each dense edge conv's stages on every point's ``k`` edges
(stage 0 on ``[x, x_nn - x]``, 2C wide; stage ``j`` on ``[g_{j-1}, ...,
g_0, x]``), the prep convs, ``layer0`` and ``conv0`` on the ``N`` points;
in each up block ``f``, ``g``, ``h``, the attention's two products
(``2 M^2 (32 + 130)``) and the two convs on the ``M = r' N`` rows; the
down block on the ``N`` points; the coordinate regressor on the ``M``
candidates.  At the published widths and ``N = 256`` that is 2.48 GFLOP a
patch (extractor 0.21, ``conv0`` 0.03, each up block 1.04, down 0.12,
coordinates 0.03), counted over a shape's real patches, as
``work_punet.shape_flops`` counts PU-Net's: a padding patch is no work
the shape needs.

The attention's least time counts what any implementation must do: the
two products and the softmax (5 operations a score: a max, a
subtraction, an exponential, a sum and a division), ``f``, ``g`` and
``h`` read and the output written once; never the ``M x M`` scores.
Every patch that runs counts there, padding included, as
``work_punet.fps_bounds`` counts the FPS calls; so do the FPS calls here,
which are PU-Net's seed and re-stitch plus the net's own FPS a chunk.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import reference as R
from portbench import work, work_punet
from portbench.reference_pugan import param_shapes

#: operations of the softmax a score
SOFTMAX_OPS = 5


def rows(net: dict, num_point: int) -> int:
    """``M``: the rows an up block expands a patch to."""
    return (net["up_ratio"] + net["more_up"]) * num_point


def patch_flops(net: dict, num_point: int) -> Dict[str, float]:
    """Operations of one patch's layer equations, by stage."""
    m, k = rows(net, num_point), net["knn"]
    per_row = {"feature_extraction/layer0": ("extract", num_point),
               "/mlps/": ("extract", num_point * k),
               "_prep": ("extract", num_point),
               "conv0": ("conv0", num_point),
               "up_0/": ("up0", m), "up_1/": ("up1", m),
               "down_0/": ("down", num_point), "fc_layer": ("coords", m)}
    out: Dict[str, float] = {}
    for scope, (a, b) in param_shapes(net):
        stage, n = next(v for key, v in per_row.items() if key in scope)
        out[stage] = out.get(stage, 0.0) + 2.0 * n * a * b
    for up in ("up0", "up1"):
        out[up] += attention_products(net, num_point)
    return out


def attention_products(net: dict, num_point: int) -> float:
    """The two products of one attention unit on one patch."""
    m = rows(net, num_point)
    return 2.0 * m * m * (net["attention"] + net["attention_in"])


def shape_flops(net: dict, traffic: dict) -> float:
    num_patches, _, _ = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"])
    return num_patches * sum(patch_flops(net, traffic["num_point"]).values())


def attention_bound(net: dict, traffic: dict) -> work.Bound:
    """The least time of one shape's attention units: two a patch, every
    patch that runs."""
    _, padded, _ = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"])
    n = traffic["num_point"]
    m, d, e = rows(net, n), net["attention"], net["attention_in"]
    units = 2 * padded
    ops = units * (attention_products(net, n) + SOFTMAX_OPS * m * m)
    return work.bound(ops, units * m * (2 * d + 2 * e) * 4.0)


def fps_bounds(net: dict, traffic: dict) -> List[work.Bound]:
    """One shape's FPS launches: the seed picks and the G=8 re-stitch,
    which the pipeline runs as it does for PU-Net (``work_punet``'s, with
    no set-abstraction level), and every chunk's net FPS of ``r N`` of the
    ``M`` candidates, padding patches included, as they run."""
    _, padded, chunk = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"])
    n = traffic["num_point"]
    net_fps = work.fps_bound(chunk, rows(net, n), net["up_ratio"] * n)
    return (work_punet.fps_bounds(dict(sa_mlps=()), traffic)
            + [net_fps] * (padded // chunk))
