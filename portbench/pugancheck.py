"""The PU-GAN cell's correctness check: the program's answers for a sample
of the window's shapes, held to the plain reference
(:mod:`portbench.reference_pugan`), every chunk of each shape replayed from
the program's own selections (feature-kNN rows and FPS picks flip on
near-ties under rounding, as in :mod:`portbench.evalcheck`):

- ``start``: the pipeline's seed FPS, grouping and normalization, from
  the shape, against the program's chunk inputs (max abs difference);
- ``sel_rows``: over every chunk's four edge convs' feature kNN and its
  FPS of the candidates, the share of kNN rows and FPS picks where the
  reference's own choice, on the program's state, differs from the
  program's;
- ``coords``: each chunk's ``M`` candidate points before the net's FPS
  and its output after it, the reference following the program's
  selections (max abs difference);
- ``restitch``: the final re-stitch from the program's chunk outputs
  against the program's result, in the shape's frame (max abs
  difference).

The pipeline around the net is PU-Net's cell's (:mod:`portbench.punetcheck`):
the same seed, grouping, normalization and re-stitch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference as R
from portbench import reference_pugan as RG
from portbench.evalcheck import max_abs
from portbench.punetcheck import _finish, _seed
from portbench.reference_punet import Follow

READINGS = ("start", "sel_rows", "coords", "restitch")


def check_shape(A: R.Arith, P: R.Params, net: dict, traffic: dict,
                points: np.ndarray, rec: dict) -> Dict[str, float]:
    """Readings for one kept shape.  ``rec``: ``chunks``, the program's
    ``(input, output, capture)`` of each chunk, and ``output``, its numpy
    result."""
    dev = rec["chunks"][0][0].device
    with torch.no_grad():
        data, centroid, furthest, norm, cen, rad, num_patches, _ = _seed(
            A, traffic, points, dev)
        out = {"start": max_abs(torch.cat([c[0] for c in rec["chunks"]]),
                                norm),
               "coords": 0.0}
        off = rows = 0
        for x, y, capture in rec["chunks"]:
            follow, own = Follow(capture), {}
            got = RG.forward(A, P, net, x, follow=follow, record=own)
            out["coords"] = max(out["coords"], max_abs(y, got),
                                max_abs(capture["coords"], own["coords"]))
            off, rows = off + follow.off, rows + follow.rows
        out["sel_rows"] = off / rows
        final = _finish(torch.cat([c[1] for c in rec["chunks"]]), rad, cen,
                        num_patches, data, traffic["ratio"], furthest,
                        centroid)
    got = rec["output"]
    out["restitch"] = (float(np.abs(got - final).max())
                       if got.shape == final.shape else float("inf"))
    return out


def check_or_fail(*args) -> Dict[str, float]:
    """:func:`check_shape`, or every reading infinite where the program's
    record does not fit the net at all (a capture missing, a shape that
    differs)."""
    try:
        return check_shape(*args)
    except (ValueError, RuntimeError, IndexError, KeyError) as e:
        print(f"portbench: the check could not follow the program: {e}")
        return {k: float("inf") for k in READINGS}


def reference_run(A: R.Arith, P: R.Params, net: dict, traffic: dict,
                  points: np.ndarray, device) -> dict:
    """The reference put in the program's place (the control): one shape
    through the whole pipeline, recorded as the harness records the
    program."""
    rec = {"chunks": []}
    with torch.no_grad():
        data, centroid, furthest, norm, cen, rad, num_patches, chunk = \
            _seed(A, traffic, points, device)
        for s in range(0, norm.shape[0], chunk):
            x, capture = norm[s:s + chunk], {}
            rec["chunks"].append((x, RG.forward(A, P, net, x,
                                                record=capture), capture))
        rec["output"] = _finish(torch.cat([c[1] for c in rec["chunks"]]),
                                rad, cen, num_patches, data,
                                traffic["ratio"], furthest, centroid)
    return rec
