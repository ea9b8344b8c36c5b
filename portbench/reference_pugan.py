"""The plain reference of PU-GAN's generator that the benchmark holds the
program to: a frozen copy of ``threepu_torch/reference/pugan.py`` (Li,
Li, Chen, Fu and Heng, ICCV 2019, arXiv:1907.10844; ``Generator`` of
github.com/liruihui/PU-GAN), written against the parameters the
benchmark makes, ``{"feature_extraction/layer0": (kernel (in, out),
bias), ...}`` under the published scopes, and each ``gamma`` as
``"<up block>/attention_unit/gamma": (gamma (1,), None)``.

Plain PyTorch, float32, no kernels; it imports neither ``jax``,
``threepu`` nor ``threepu_torch``.  Every float32 matrix product, the
attention's two included, goes through :meth:`portbench.reference.Arith.mm`,
so that ``Arith(tf32=True)`` is the control, one precision step below the
configuration's.

The layer equations, with ``r' = up_ratio + more_up`` copies and ``M =
r' N`` rows: ``layer0`` 3 -> 24 (no act); four dense edge convs (growth
24, 3 stages, k 16), each but the first after a 48-wide prep conv, each
output before its input (24 -> 120 -> 240 -> 360 -> 480); ``L = conv0``
480 -> 128; ``H0 = up_0(L)``, ``E0 = down_0(H0) - L``, ``H1 = up_1(E0)``;
an up block tiles its input ``r'`` times (row ``a N + i`` is point ``i``)
beside grid point ``a`` (PU-GAN's ``gen_grid``: 3 x 2 at ``r' = 6``,
``(gx[a % 3], gy[a // 3])``), then ``x + gamma * softmax(g f^T) h`` (``f``,
``g`` 130 -> 32, ``h`` 130 -> 130, all with ReLU, no scaling), then 130 ->
256 -> 128; the down block concatenates a point's ``r'`` rows copy-major
(row ``a * 128 + c`` of its ``[1, r']`` kernel) and runs 768 -> 256 ->
128; the coordinates ``H0 + H1`` -> 64 -> 3 (no act); FPS from index 0
keeps ``up_ratio * N`` of the ``M``.  Every other conv has a ReLU.

Selections are computed as the program's plain versions compute them: the
feature kNN on the matmul form, ties to the lowest index, rows that
repeat an earlier point of the patch ranked last; FPS from index 0 with
a carry of 1e10 on direct squared distances, ties to the lowest index.
With a :class:`~portbench.reference_punet.Follow` the reference takes the
program's selections (``extract.nn<i>``, ``fps.picks``) in place of its
own and counts the rows where its own choice differs; an FPS step's own
choice is the one that follows the program's picks before it.

Departures from the published code: a dense edge conv's first stage is
split by linearity, ``gather(x W_d) + x (W_c - W_d)``, and each later
stage sums its blocks' products in order (equal in exact arithmetic);
the kNN's penalty on repeated rows, which the published op computes and
drops; ``gamma`` drawn from the seed, not 0 (a zero would make the
attention arithmetic that any tolerance lets a program skip).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from portbench import reference as R
from portbench.reference_punet import Follow, fps

FE, PU = "feature_extraction", "up_projection_unit"


def param_shapes(net: dict) -> List[Tuple[str, Tuple[int, int]]]:
    """``[(published scope, kernel shape (in, out))]`` of the generator's
    convs; a dense conv's stage ``l<j>`` is ``<layer>/mlps/<j>``, the
    program's name."""
    g, n, comp, l0 = (net["growth_rate"], net["dense_n"], net["comp"],
                      net["layer0"])
    out = [(f"{FE}/layer0", (3, l0))]
    feat = l0
    for i in range(1, 5):
        c = l0 if i == 1 else comp
        if i > 1:
            out.append((f"{FE}/layer{i}_prep", (feat, comp)))
        out += [(f"{FE}/layer{i}/mlps/{j}", (2 * c if j == 0 else g * j + c,
                                               g)) for j in range(n)]
        feat += c + n * g
    f, c, hid = net["up_feat"], net["attention_in"], net["up_hidden"]
    r = net["up_ratio"] + net["more_up"]
    out.append((f"{PU}/conv0", (feat, f)))
    up = [("attention_unit/conv_f", (c, net["attention"])),
          ("attention_unit/conv_g", (c, net["attention"])),
          ("attention_unit/conv_h", (c, c)),
          ("conv1", (c, hid)), ("conv2", (hid, f))]
    out += [(f"{PU}/up_0/{s}", shape) for s, shape in up]
    out += [(f"{PU}/down_0/conv1", (r * f, hid)),
            (f"{PU}/down_0/conv2", (hid, f))]
    out += [(f"{PU}/up_1/{s}", shape) for s, shape in up]
    c1, c2 = net["coord_mlp"]
    return out + [("fc_layer1", (f, c1)), ("fc_layer2", (c1, c2))]


def gammas() -> List[str]:
    """The scopes of the two attention units' ``gamma``."""
    return [f"{PU}/up_{j}/attention_unit/gamma" for j in (0, 1)]


def grid(num: int) -> torch.Tensor:
    """PU-GAN's ``gen_grid(num)``: ``(num, 2)``."""
    num_x = next(i for i in range(int(math.sqrt(num)) + 1, 0, -1)
                 if num % i == 0)
    gx = np.linspace(-0.2, 0.2, num_x, dtype=np.float32)
    gy = np.linspace(-0.2, 0.2, num // num_x, dtype=np.float32)
    x, y = np.meshgrid(gx, gy)
    return torch.from_numpy(np.stack([x.reshape(-1), y.reshape(-1)], -1))


def repeats(points: torch.Tensor) -> torch.Tensor:
    """``(B, N)``: True where a row equals an earlier row."""
    eq = torch.all(points[:, :, None, :] == points[:, None, :, :], dim=-1)
    col = torch.arange(points.shape[1], device=points.device)
    return torch.any(eq & (col[None, :] < col[:, None]), dim=-1)


def dense_conv(A: R.Arith, P: R.Params, net: dict, name: str,
               x: torch.Tensor, dup: torch.Tensor,
               choose) -> torch.Tensor:
    """``[max g2, max g1, max g0, x]`` over the feature kNN (``choose``
    decides its rows)."""
    c, g, n = x.shape[-1], net["growth_rate"], net["dense_n"]
    d = R.pairwise_dist2(A, x, x).masked_fill(dup[:, None, :], R.PENALTY)
    own = torch.sort(d, dim=-1, stable=True).indices[..., 1:net["knn"] + 1]
    idx = choose(own)
    w = [P[f"{name}/mlps/{i}"][0] for i in range(n)]
    b = [P[f"{name}/mlps/{i}"][1] for i in range(n)]
    zn = R.gather_rows(A.mm(x, w[0][c:]), idx)
    point = A.mm(x, w[0][:c] - w[0][c:]) + b[0]
    gs = [torch.relu(zn + point[:, :, None, :])]
    for i in range(1, n):
        y = None
        for j in range(i):
            term = A.mm(gs[i - 1 - j], w[i][g * j:g * (j + 1)])
            y = term if y is None else y + term
        y = y + (A.mm(x, w[i][g * i:]) + b[i])[:, :, None, :]
        gs.append(y if i == n - 1 else torch.relu(y))
    return torch.cat([torch.amax(gi, dim=-2) for gi in reversed(gs)] + [x],
                     dim=-1)


def up_block(A: R.Arith, P: R.Params, net: dict, name: str,
             x: torch.Tensor) -> torch.Tensor:
    p, n, _ = x.shape
    r = net["up_ratio"] + net["more_up"]
    code = grid(r).to(x.device)[:, None, :].expand(r, n, 2).reshape(
        1, r * n, 2)
    x = torch.cat([x.repeat(1, r, 1), code.expand(p, -1, -1)], dim=-1)
    att = name + "/attention_unit"
    f, g, h = (R.dense(A, P, f"{att}/conv_{s}", x, relu=True) for s in "fgh")
    beta = torch.softmax(A.mm(g, f.transpose(-1, -2)), dim=-1)
    y = P[att + "/gamma"][0] * A.mm(beta, h) + x
    return R.dense(A, P, name + "/conv2",
                   R.dense(A, P, name + "/conv1", y, True), True)


def down_block(A: R.Arith, P: R.Params, name: str, h: torch.Tensor,
               n: int) -> torch.Tensor:
    p, _, c = h.shape
    x = h.reshape(p, -1, n, c).transpose(1, 2).reshape(p, n, -1)
    return R.dense(A, P, name + "/conv2",
                   R.dense(A, P, name + "/conv1", x, True), True)


def forward(A: R.Arith, P: R.Params, net: dict, xyz: torch.Tensor,
            follow: Optional[Follow] = None,
            record: Optional[dict] = None) -> torch.Tensor:
    """Patches ``(P, N, 3)`` -> ``(P, up_ratio N, 3)``, the program's
    selections taken where ``follow`` is given; ``record`` receives the
    selections taken and the candidates under the program's capture
    keys."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {} if record is None else record

    def choose(key):
        def pick(own):
            got = own if follow is None else follow.choose(key, own)
            rec[key] = got.to(torch.int32)
            return got.long()
        return pick

    n = xyz.shape[1]
    dup = repeats(xyz)
    x = R.dense(A, P, f"{FE}/layer0", xyz)
    for i in range(1, 5):
        inp = x if i == 1 else R.dense(A, P, f"{FE}/layer{i}_prep", x, True)
        y = dense_conv(A, P, net, f"{FE}/layer{i}", inp, dup,
                       choose(f"extract.nn{i}"))
        x = torch.cat([y, x], dim=-1)
    low = R.dense(A, P, f"{PU}/conv0", x, True)
    h0 = up_block(A, P, net, f"{PU}/up_0", low)
    e0 = down_block(A, P, f"{PU}/down_0", h0, n) - low
    h = h0 + up_block(A, P, net, f"{PU}/up_1", e0)
    coords = R.dense(A, P, "fc_layer2", R.dense(A, P, "fc_layer1", h, True))
    m = net["up_ratio"] * n
    taken = None
    if follow is not None:
        taken = follow.taken("fps.picks", coords.new_empty(
            (coords.shape[0], m)))
    picks = choose("fps.picks")(fps(coords, m, taken))
    rec["coords"] = coords
    return R.gather_rows(coords, picks)
