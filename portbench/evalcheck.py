"""The eval cells' correctness check: the program's answers for a sample
of the window's shapes, held to the plain reference
(:mod:`portbench.reference`).

FPS and kNN picks flip on near-ties under rounding, so a whole shape
recomputed apart from the program is another sample of the same surface
and cannot be compared point for point.  The check follows the program
step by step from its own state, and checks each step by itself:

- ``start``: the pipeline's seed FPS, grouping and normalization, from
  the shape, against the program's chunk inputs (max abs difference);
- ``glue``: for every chunk, the cascade between levels (outlier mask,
  sub-patch seeds and grouping, merge FPS, the chunk's output), each
  from the program's previous level's output, against the program's
  next inputs (max abs difference; a differing mask bit counts 1);
- ``level_rows``: for every chunk, each level on the program's own
  inputs: the share of output rows (points and point features) that
  differ from the reference's by more than 1e-4 (features: relative to
  the row's largest value, at least 1), the largest over the levels;
- ``restitch``: the final re-stitch from the program's merged patches
  against the program's output, in the shape's frame (max abs
  difference).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference as R

ROW_BAND = 1e-4


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool:
        return float((a != b).any())
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float().to(a.device)).abs().max())


def rows_off(got: torch.Tensor, want: torch.Tensor, relative: bool) -> float:
    """Share of rows (last axis) differing by more than :data:`ROW_BAND`."""
    if got.shape != want.shape:
        return 1.0
    diff = (got - want).abs().amax(-1)
    band = ROW_BAND
    if relative:
        band = ROW_BAND * torch.clamp(want.abs().amax(-1), min=1.0)
    return float((~(diff <= band)).float().mean())


def replay_chunk(A: R.Arith, P: R.Params, spec: R.NetSpec, chunk_in,
                 chunk_out, levels, ratio: int) -> Dict[str, float]:
    """The cascade of one chunk, level by level from the program's own
    state: ``levels`` is the program's ``[(l, args, kwargs, (new_xyz,
    feats))]`` in call order."""
    stats = {"glue": 0.0, "level_rows": 0.0}
    calls = iter(levels)

    def level(l, args, kw):
        got = next(calls, None)
        if got is None or got[0] != l:
            raise ValueError(f"the program's level calls do not follow the "
                             f"cascade at level {l}")
        _, pargs, pkw, (p_xyz, p_feat) = got
        glue = max(max_abs(args[0], pargs[0]), max_abs(args[1], pargs[1]))
        if len(args) > 2:
            glue = max(glue, max_abs(args[2][0], pargs[2][0]),
                       max_abs(args[2][1], pargs[2][1]))
        if kw.get("prev_dup") is not None:
            glue = max(glue, max_abs(kw["prev_dup"], pkw.get("prev_dup")),
                       float(kw["prev_group"] != pkw.get("prev_group")))
        stats["glue"] = max(stats["glue"], glue)
        prev = pargs[2] if len(pargs) > 2 else None
        r_xyz, r_feat = R.level_forward(
            A, P, spec, l, pargs[0], pargs[1], prev,
            prev_group=pkw.get("prev_group") or 1,
            prev_dup=pkw.get("prev_dup"))
        stats["level_rows"] = max(stats["level_rows"],
                                  rows_off(p_xyz, r_xyz, False),
                                  rows_off(p_feat, r_feat, True))
        return p_xyz, p_feat

    with torch.no_grad():
        out = R.eval_cascade(A, spec, chunk_in, ratio, level)
    stats["glue"] = max(stats["glue"], max_abs(out, chunk_out))
    if next(calls, None) is not None:
        stats["glue"] = float("inf")
    return stats


def check_shape(A: R.Arith, P: R.Params, spec: R.NetSpec, traffic: dict,
                points: np.ndarray, rec: dict, rank: int = 0,
                world: int = 1) -> Dict[str, float]:
    """Readings for one kept shape.  ``rec``: ``chunks`` (the program's
    ``(input, output)`` of each chunk on this rank), ``levels`` (each
    chunk's level calls),
    ``gathered`` (the merged patches after the all-gather, with a mesh)
    and ``output`` (the program's numpy result)."""
    dev = rec["chunks"][0][0].device
    ratio, num_point = traffic["ratio"], traffic["num_point"]
    with torch.no_grad():
        data, centroid, furthest = R.normalize_cloud(
            np.asarray(points, np.float32)[..., :3])
        norm, cen, rad, num_patches, padded, _ = R.seed_patches(
            A, torch.from_numpy(np.ascontiguousarray(data)).to(dev),
            num_point, traffic["patch_num_ratio"], traffic["chunk"], world)
        local = padded // world
        lo, hi = rank * local, (rank + 1) * local
        prog_in = torch.cat([c[0] for c in rec["chunks"]])
        out = {"start": max_abs(prog_in, norm[lo:hi]), "glue": 0.0,
               "level_rows": 0.0}
        if len(rec["levels"]) != len(rec["chunks"]):
            raise ValueError("a chunk's level calls were not recorded")
        for (c_in, c_out), calls in zip(rec["chunks"], rec["levels"]):
            got = replay_chunk(A, P, spec, c_in, c_out, calls, ratio)
            for k, v in got.items():
                out[k] = max(out[k], v)
        if rec.get("gathered") is not None:
            up = rec["gathered"]
        else:
            up = (torch.cat([x[1] for x in rec["chunks"]])
                  * rad[lo:hi] + cen[lo:hi])
        num_out = data.shape[0] * ratio
        final = R.restitch(up, num_patches, num_out).cpu().numpy()
        final = final * furthest + centroid
    got = rec["output"]
    out["restitch"] = (float(np.abs(got - final).max())
                       if got.shape == final.shape else float("inf"))
    return out


def check_or_fail(*args) -> Dict[str, float]:
    """:func:`check_shape`, or every reading infinite where the program's
    record does not fit the cascade at all (a level call missing, a
    shape that differs)."""
    try:
        return check_shape(*args)
    except (ValueError, RuntimeError, IndexError) as e:
        print(f"portbench: the check could not follow the program: {e}")
        return {k: float("inf") for k in
                ("start", "glue", "level_rows", "restitch")}


def reference_run(A: R.Arith, P: R.Params, spec: R.NetSpec, traffic: dict,
                  points: np.ndarray, device, rank: int = 0,
                  world: int = 1) -> dict:
    """The reference put in the program's place (the control): one shape
    through the whole pipeline, recorded as the harness records the
    program (this rank's chunks of a ``world``-rank layout)."""
    rec = {"chunks": [], "levels": [], "gathered": None}
    with torch.no_grad():
        data, centroid, furthest = R.normalize_cloud(
            np.asarray(points, np.float32)[..., :3])
        norm, cen, rad, num_patches, padded, chunk = R.seed_patches(
            A, torch.from_numpy(np.ascontiguousarray(data)).to(device),
            traffic["num_point"], traffic["patch_num_ratio"],
            traffic["chunk"], world)
        local = padded // world
        lo = rank * local
        outs = {}
        for s in range(0, padded, chunk):
            mine = lo <= s < lo + local
            calls = []

            def level(l, args, kw, _calls=calls):
                res = R.level_forward(A, P, spec, l, *args, **kw)
                _calls.append((l, args, kw, res))
                return res

            if not (mine or world > 1):
                continue
            x = norm[s:s + chunk]
            outs[s] = R.eval_cascade(A, spec, x, traffic["ratio"], level)
            if mine:
                rec["chunks"].append((x, outs[s]))
                rec["levels"].append(calls)
        # with a mesh, every rank's patches, as an exact all-gather brings
        # them
        up = torch.cat([outs[s] * rad[s:s + chunk] + cen[s:s + chunk]
                        for s in sorted(outs)])
        if world > 1:
            rec["gathered"] = up
        final = R.restitch(up, num_patches,
                           data.shape[0] * traffic["ratio"]).cpu().numpy()
        rec["output"] = final * furthest + centroid
    return rec


def worst(readings) -> Dict[str, float]:
    """The largest of each reading over several shapes."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out

