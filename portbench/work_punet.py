"""The work of a PU-Net shape, counted from the configuration's widths and
the traffic's sizes, for ``mfu.punet_eval`` and ``punet.fps_roofline``
(the peaks and :func:`portbench.work.fps_bound` are
:mod:`portbench.work`'s).

The layer equations' operations are the products of the shared MLPs and
convs, two a multiply-add: an SA level's MLP on each of its ``npoint``
balls of ``nsample`` points, the FP convs and the expansion on the ``N``
input points, the coordinate regressor on the ``rN`` outputs.  At the
published widths and ``N = 1024`` that is 4.98 GFLOP a patch (SA1 0.21,
SA2 0.54, SA3 1.08, SA4 2.15, FP 0.12, expansion 0.81, coordinates 0.07),
counted over a shape's real patches, as ``work.eval_shape_flops`` counts
3PU's: a padding patch is no work the shape needs.
"""

from __future__ import annotations

from typing import Dict, List

from portbench import reference as R
from portbench import work
from portbench.reference_punet import param_shapes


def patch_flops(net: dict, num_point: int) -> Dict[str, float]:
    """Operations of one patch's layer equations, by stage."""
    rows = {}
    for l in range(1, len(net["sa_mlps"]) + 1):
        rows[f"layer{l}"] = (f"sa{l}", num_point // 2 ** (l - 1)
                             * net["nsample"])
    rows.update(fa_layer=("fp", num_point), up_layer=("expand", num_point),
                fc_layer=("coords", num_point * net["up_ratio"]))
    out: Dict[str, float] = {}
    for scope, (a, b) in param_shapes(net):
        stage, n = next(v for k, v in rows.items() if scope.startswith(k))
        out[stage] = out.get(stage, 0.0) + 2.0 * n * a * b
    return out


def shape_flops(net: dict, traffic: dict) -> float:
    num_patches, _, _ = R.plan_patches(
        traffic["points"], traffic["num_point"], traffic["patch_num_ratio"],
        traffic["chunk"])
    return num_patches * sum(patch_flops(net, traffic["num_point"]).values())


def fps_bounds(net: dict, traffic: dict) -> List[work.Bound]:
    """One shape's FPS launches: the seed picks, every chunk's four SA
    levels (padding patches included, as they run), the G=8 re-stitch over
    the valid merged points."""
    n_shape, num_point = traffic["points"], traffic["num_point"]
    ratio = traffic["ratio"]
    num_patches, padded, chunk = R.plan_patches(
        n_shape, num_point, traffic["patch_num_ratio"], traffic["chunk"])
    out = [work.fps_bound(1, n_shape, num_patches)]
    for _ in range(padded // chunk):
        n = num_point
        for l in range(1, len(net["sa_mlps"]) + 1):
            m = num_point // 2 ** (l - 1)
            out.append(work.fps_bound(chunk, n, m))
            n = m
    num_out, per_patch = n_shape * ratio, num_point * ratio
    groups = 1
    if num_out >= R.RESTITCH_MIN_OUT:
        group_max = min(-(-padded * per_patch // R.RESTITCH_GROUPS),
                        R.HIER_MAX_N)
        groups = -(-padded * per_patch // group_max)
    out.append(work.fps_bound(groups, -(-num_patches * per_patch // groups),
                              -(-num_out // groups)))
    return out
