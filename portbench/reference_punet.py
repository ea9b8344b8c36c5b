"""The plain reference of PU-Net's generator that the benchmark holds the
program to: a frozen copy of ``threepu_torch/reference/punet.py`` (Yu et
al., CVPR 2018, arXiv:1801.06761; ``get_gen_model`` of
github.com/yulequan/PU-Net), written against the parameters the benchmark
makes, ``{"layer1/conv0": (kernel (in, out), bias), ...}`` under the
published scopes.

Plain PyTorch, float32, no kernels; it imports neither ``jax``,
``threepu`` nor ``threepu_torch``.  Every float32 matrix product goes
through :meth:`portbench.reference.Arith.mm`, so that ``Arith(tf32=True)``
is the control, one precision step below the configuration's.

Selections are computed as the program's plain versions compute them: FPS
from index 0 with a carry of 1e10 on direct squared distances, ties to
the lowest index; ball query and 3-NN ranking on the matmul form, ties to
the lowest index.  With a :class:`Follow` the reference takes the
program's selections in place of its own and counts the rows where its
own choice differs; an FPS step's own choice is the one that follows the
program's picks before it.

Departures from the published code: the ball query tests ``d < r**2`` on
the matmul-form squared distance in float32 (published: ``sqrt(d) < r``
on the direct one); the 3-NN ranks on the matmul form and weights by the
direct squared distance; the expansion's concatenation keeps the
published row order (row ``i`` of ``f1`` is SA1's ``i``-th pick, of
``up4``, ``up3``, ``up2`` and ``xyz`` input point ``i``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import reference as R

MIN_DIST2 = 1e-10


def param_shapes(net: dict) -> List[Tuple[str, Tuple[int, int]]]:
    """``[(published scope, kernel shape (in, out))]`` of the generator."""
    sa, fp = net["sa_mlps"], net["fp_mlp"]
    out, c_feat = [], 0
    for l, widths in enumerate(sa, start=1):
        c_in = 3 + c_feat
        for j, c in enumerate(widths):
            out.append((f"layer{l}/conv{j}", (c_in, c)))
            c_in = c
        c_feat = widths[-1]
    for k in range(1, len(sa)):
        c_in = sa[len(sa) - k][-1]
        for j, c in enumerate(fp):
            out.append((f"fa_layer{k}/conv_{j}", (c_in, c)))
            c_in = c
    c_in = (len(sa) - 1) * fp[-1] + sa[0][-1] + 3
    a, b = net["expand_mlp"]
    for i in range(net["up_ratio"]):
        out += [(f"up_layer/fc_layer0_{i}", (c_in, a)),
                (f"up_layer/conv_{i}", (a, b))]
    c1, c2 = net["coord_mlp"]
    return out + [("fc_layer1", (b, c1)), ("fc_layer2", (c1, c2))]


class Follow:
    """The program's selections of one chunk (its ``PUNet.upsample``
    capture), taken in the reference's place: ``off`` of ``rows`` rows
    (an FPS pick, a ball's or a 3-NN's row of indices) held another own
    choice."""

    def __init__(self, capture: Dict[str, torch.Tensor]):
        self.capture = capture
        self.off = self.rows = 0

    def taken(self, key: str, like: torch.Tensor) -> torch.Tensor:
        got = self.capture.get(key)
        if got is None or tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"the program's capture has no {key} of "
                             f"shape {tuple(like.shape)}")
        return got.to(like.device).long()

    def choose(self, key: str, own: torch.Tensor) -> torch.Tensor:
        got = self.taken(key, own)
        differ = (got != own.long()).reshape(*own.shape[:2], -1).any(-1)
        self.off += int(differ.sum())
        self.rows += differ.numel()
        return got


def fps(points: torch.Tensor, m: int,
        taken: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(B, N, 3)`` -> ``(B, m)`` picks; with ``taken`` (the program's),
    each step's own choice after the taken picks before it."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    last = torch.zeros(b, dtype=torch.long, device=points.device)
    carry = torch.full(points.shape[:2], R.INIT_DIST, device=points.device)
    own = [last]
    for j in range(1, m):
        prev = last if taken is None else taken[:, j - 1]
        carry = torch.minimum(carry, R.sq_dist3(
            points, points[rows, prev][:, None, :]))
        last = torch.argmax(carry, dim=-1)
        own.append(last)
    return torch.stack(own, dim=1)


def ball_query(A: R.Arith, radius: float, nsample: int, xyz: torch.Tensor,
               centres: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` points within ``radius`` of each centre in
    index order, the rest of the row the first of them (all zeros without
    one): ``(B, M, nsample)``."""
    r = np.float32(radius)
    within = R.pairwise_dist2(A, centres, xyz) < float(r * r)
    order = torch.sort((~within).to(torch.uint8), dim=-1, stable=True).indices
    if order.shape[-1] < nsample:
        order = torch.cat([order, order[..., :1].expand(
            *order.shape[:-1], nsample - order.shape[-1])], dim=-1)
    order = order[..., :nsample]
    count = within.sum(dim=-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    return torch.where(slot < count, order, order[..., :1])


def three_nn(A: R.Arith, xyz: torch.Tensor, known: torch.Tensor
             ) -> torch.Tensor:
    """The three nearest known points of each point, ``(B, N, 3)``."""
    d = R.pairwise_dist2(A, xyz, known)
    return torch.sort(d, dim=-1, stable=True).indices[..., :3]


def forward(A: R.Arith, P: R.Params, net: dict, xyz: torch.Tensor,
            follow: Optional[Follow] = None,
            record: Optional[dict] = None) -> torch.Tensor:
    """Patches ``(P, N, 3)`` -> ``(P, 4N, 3)``, the program's selections
    taken where ``follow`` is given; ``record`` receives the selections
    taken and the output under the program's capture keys."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {} if record is None else record

    def choose(key, own):
        got = own if follow is None else follow.choose(key, own)
        rec[key] = got.to(torch.int32)
        return got

    n = xyz.shape[1]
    l_xyz, l_feat, sa = xyz, None, []
    for l, radius in enumerate(net["radii"], start=1):
        m = n // 2 ** (l - 1)
        taken = None
        if follow is not None:
            taken = follow.taken(f"sa{l}.picks", xyz.new_empty(
                (xyz.shape[0], m)))
        picks = choose(f"sa{l}.picks", fps(l_xyz, m, taken))
        centres = R.gather_rows(l_xyz, picks)
        idx = choose(f"sa{l}.ball", ball_query(A, radius, net["nsample"],
                                               l_xyz, centres))
        x = R.gather_rows(l_xyz, idx) - centres[:, :, None, :]
        if l_feat is not None:
            x = torch.cat([x, R.gather_rows(l_feat, idx)], dim=-1)
        for j in range(len(net["sa_mlps"][l - 1])):
            x = R.dense(A, P, f"layer{l}/conv{j}", x, relu=True)
        l_xyz, l_feat = centres, torch.amax(x, dim=2)
        sa.append((l_xyz, l_feat))
    levels = len(net["radii"])
    ups = []
    for k in range(1, levels):
        l = levels + 1 - k
        known, feat = sa[l - 1]
        idx = choose(f"fp{l}.nn", three_nn(A, xyz, known))
        d = R.sq_dist3(xyz[..., None, :], R.gather_rows(known, idx))
        inv = 1.0 / torch.clamp(d, min=MIN_DIST2)
        w = inv / torch.sum(inv, dim=-1, keepdim=True)
        x = torch.sum(R.gather_rows(feat, idx) * w[..., None], dim=-2)
        for j in range(len(net["fp_mlp"])):
            x = R.dense(A, P, f"fa_layer{k}/conv_{j}", x, relu=True)
        ups.append(x)
    x = torch.cat(ups + [sa[0][1], xyz], dim=-1)
    branches = [R.dense(A, P, f"up_layer/conv_{i}",
                        R.dense(A, P, f"up_layer/fc_layer0_{i}", x, True),
                        True)
                for i in range(net["up_ratio"])]
    out = R.dense(A, P, "fc_layer2",
                  R.dense(A, P, "fc_layer1", torch.cat(branches, dim=1),
                          True))
    rec["coords"] = out
    return out
