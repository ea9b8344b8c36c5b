"""The plain reference of PU-GAN's generator (Li, Li, Chen, Fu and Heng,
ICCV 2019, arXiv:1907.10844; ``Generator`` of github.com/liruihui/PU-GAN)
and of the whole-shape pipeline around it.

Plain ``torch`` in float32, TF32 off, no kernels and no batching tricks;
it imports neither ``jax``, ``threepu`` nor any ``threepu_torch`` module.
The weights are a state dict under the published scopes
(``feature_extraction.layer0.weight (out, in, 1, 1)``, ``.bias``, ...;
``up_projection_unit.down_0.conv1.weight (256, 128, 1, r')``).

The layer equations, with ``r' = r + 2`` copies and ``M = r' N`` rows:
``layer0`` 3 -> 24 (no act); four dense edge convs (growth 24, 3 stages,
k 16), each but the first after a 48-wide prep conv, each output before
its input (24 -> 120 -> 240 -> 360 -> 480); ``L = conv0`` 480 -> 128;
``H0 = up_0(L)``, ``E0 = down_0(H0) - L``, ``H1 = up_1(E0)``; an up block
tiles its input ``r'`` times (row ``a N + i`` is point ``i``) beside grid
point ``a`` (3 x 2, ``(gx[a % 3], gy[a // 3])``), then ``x + gamma *
softmax(g f^T) h`` (``f``, ``g`` 130 -> 32, ``h`` 130 -> 130, all with
ReLU, no scaling), then 130 -> 256 -> 128; the down block concatenates a
point's ``r'`` rows copy-major and runs 768 -> 256 -> 128; the
coordinates ``H0 + H1`` -> 64 -> 3 (no act); FPS keeps ``r N`` of them.
Every other conv has a ReLU.

Where an order of operations decides a selection, the reference computes
it as the port's plain versions do, so that on the same inputs both pick
alike: the feature kNN on the matmul form ``|a|^2 - 2 a.b + |b|^2``, ties
to the lowest index; FPS from index 0 with a carry of 1e10 on direct
squared distances ``(dx*dx + dy*dy) + dz*dz``, ties to the lowest index.

Departures from the published code:

- a dense edge conv's first stage is computed split by linearity,
  ``gather(x W_d) + x (W_c - W_d)`` for the edge ``[x, x_nn - x]``, and
  each later stage sums its blocks' products in order, as the port
  computes them (equal in exact arithmetic);
- in the feature kNN a row that repeats an earlier point of the patch
  ranks behind every distinct row (the published op computes this
  penalty and drops it; on a patch without repeated points both agree);
- ``gamma`` is a weight like any other (published: 0 at the start).

:func:`pipeline` is the shape-level flow for outputs below 16,384 points:
seed FPS, kNN patches, per-patch normalization, the net, denormalization
and one exact FPS re-stitch (the port's grouped re-stitch above that size
is held by the benchmark's check).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

INIT_DIST = 1e10
PENALTY = 1e30
GROWTH, DENSE_N, KNN = 24, 3, 16
UP_RATIO, MORE_UP = 4, 2

State = Dict[str, torch.Tensor]


def _fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points (B, M, C)``, ``idx (B, X...)`` -> ``(B, X..., C)``."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device).reshape(
        b, *[1] * (idx.dim() - 1))
    return points[rows, idx.long()]


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r_a = torch.sum(a * a, dim=-1, keepdim=True)
    r_b = torch.sum(b * b, dim=-1, keepdim=True)
    return r_a - 2.0 * torch.matmul(a, b.transpose(-1, -2)) \
        + r_b.transpose(-1, -2)


def repeats(points: torch.Tensor) -> torch.Tensor:
    """``(B, N)``: True where a row equals an earlier row."""
    eq = torch.all(points[:, :, None, :] == points[:, None, :, :], dim=-1)
    col = torch.arange(points.shape[1], device=points.device)
    return torch.any(eq & (col[None, :] < col[:, None]), dim=-1)


def fps(points: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, N, 3)`` -> ``(B, m)`` int32 picks."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    last = torch.zeros(b, dtype=torch.long, device=points.device)
    carry = torch.full(points.shape[:2], INIT_DIST, device=points.device)
    picks = [last]
    for _ in range(m - 1):
        dx, dy, dz = (points - points[rows, last][:, None, :]).unbind(-1)
        carry = torch.minimum(carry, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(carry, dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        dup: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 ``(B, M, k)``: the ``k`` nearest ``points`` of each query,
    rows where ``dup`` is set ranked last."""
    d = pairwise_dist2(query, points)
    if dup is not None:
        d = d.masked_fill(dup[:, None, :], PENALTY)
    return torch.sort(d, dim=-1, stable=True).indices[..., :k].to(
        torch.int32)


def kernel(state: State, name: str) -> torch.Tensor:
    """A conv's ``(in, out)`` kernel; a ``[1, r']`` kernel's rows copy-major
    (``a * in + c``)."""
    w = state[name + ".weight"]
    if w.dim() == 4 and w.shape[-1] > 1:
        return w[:, :, 0, :].permute(2, 1, 0).reshape(-1, w.shape[0])
    return w.reshape(w.shape[0], -1).t()


def conv(state: State, name: str, x: torch.Tensor,
         relu: bool = True) -> torch.Tensor:
    y = torch.matmul(x, kernel(state, name)) + state[name + ".bias"]
    return torch.relu(y) if relu else y


def dense_conv(state: State, name: str, x: torch.Tensor, dup: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[max g2, max g1, max g0, x]`` over the feature kNN, and the kNN."""
    c, g = x.shape[-1], GROWTH
    idx = knn(x, x, KNN + 1, dup)[..., 1:]
    w = [kernel(state, f"{name}.mlps.{i}") for i in range(DENSE_N)]
    b = [state[f"{name}.mlps.{i}.bias"] for i in range(DENSE_N)]
    zn = gather(torch.matmul(x, w[0][c:]), idx)
    gs = [torch.relu(zn + (torch.matmul(x, w[0][:c] - w[0][c:])
                           + b[0])[:, :, None, :])]
    for i in range(1, DENSE_N):
        y = None
        for j in range(i):
            term = torch.matmul(gs[i - 1 - j], w[i][g * j:g * (j + 1)])
            y = term if y is None else y + term
        y = y + (torch.matmul(x, w[i][g * i:]) + b[i])[:, :, None, :]
        gs.append(y if i == DENSE_N - 1 else torch.relu(y))
    pooled = [torch.amax(gi, dim=-2) for gi in reversed(gs)]
    return torch.cat(pooled + [x], dim=-1), idx


def grid(num: int) -> torch.Tensor:
    """PU-GAN's ``gen_grid(num)``: ``(num, 2)``."""
    num_x = next(i for i in range(int(math.sqrt(num)) + 1, 0, -1)
                 if num % i == 0)
    gx = np.linspace(-0.2, 0.2, num_x, dtype=np.float32)
    gy = np.linspace(-0.2, 0.2, num // num_x, dtype=np.float32)
    x, y = np.meshgrid(gx, gy)
    return torch.from_numpy(np.stack([x.reshape(-1), y.reshape(-1)], -1))


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T) v``, no scaling."""
    s = torch.matmul(q, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def up_block(state: State, name: str, x: torch.Tensor,
             record: dict) -> torch.Tensor:
    p, n, _ = x.shape
    r = UP_RATIO + MORE_UP
    code = grid(r).to(x.device)
    code = code[:, None, :].expand(r, n, 2).reshape(1, r * n, 2)
    x = torch.cat([x.repeat(1, r, 1), code.expand(p, -1, -1)], dim=-1)
    att = name + ".attention_unit"
    f, g, h = (conv(state, f"{att}.conv_{s}", x) for s in "fgh")
    o = attention(g, f, h)
    record[name + ".attention"] = o
    y = state[att + ".gamma"] * o + x
    return conv(state, name + ".conv2", conv(state, name + ".conv1", y))


def down_block(state: State, name: str, h: torch.Tensor,
               n: int) -> torch.Tensor:
    p, _, c = h.shape
    r = h.shape[1] // n
    x = h.reshape(p, r, n, c).transpose(1, 2).reshape(p, n, r * c)
    return conv(state, name + ".conv2", conv(state, name + ".conv1", x))


def forward(state: State, xyz: torch.Tensor,
            record: Optional[dict] = None) -> torch.Tensor:
    """Patches ``(P, N, 3)`` -> ``(P, 4N, 3)``.  ``record``, when given,
    receives the port's capture keys (``extract.nn<i>``,
    ``extract.features``, ``up_down_up.features``, ``coords``,
    ``fps.picks``) and each attention's output
    (``up_projection_unit.up_<j>.attention``)."""
    _fp32()
    rec = {} if record is None else record
    n = xyz.shape[1]
    fe = "feature_extraction"
    dup = repeats(xyz)
    x = conv(state, fe + ".layer0", xyz, relu=False)
    for i in range(1, 5):
        inp = x if i == 1 else conv(state, f"{fe}.layer{i}_prep", x)
        y, rec[f"extract.nn{i}"] = dense_conv(state, f"{fe}.layer{i}", inp,
                                              dup)
        x = torch.cat([y, x], dim=-1)
    rec["extract.features"] = x
    pu = "up_projection_unit"
    low = conv(state, pu + ".conv0", x)
    h0 = up_block(state, pu + ".up_0", low, rec)
    e0 = down_block(state, pu + ".down_0", h0, n) - low
    h = h0 + up_block(state, pu + ".up_1", e0, rec)
    rec["up_down_up.features"] = h
    coords = conv(state, "fc_layer2", conv(state, "fc_layer1", h),
                  relu=False)
    picks = fps(coords, UP_RATIO * n)
    rec.update({"coords": coords, "fps.picks": picks})
    return gather(coords, picks)


def normalize(pc: torch.Tensor):
    centroid = torch.mean(pc, dim=-2, keepdim=True)
    pc = pc - centroid
    radius = torch.amax(torch.sqrt(torch.sum(pc * pc, dim=-1, keepdim=True)),
                        dim=-2, keepdim=True)
    return pc / radius, centroid, radius


def pipeline(state: State, points: np.ndarray, num_point: int,
             patch_num_ratio: float = 3.0) -> Tuple[np.ndarray, list]:
    """One shape ``(n, 3)`` to ``(4n, 3)`` in its own frame, and each
    patch's forward record."""
    _fp32()
    pts = np.asarray(points, np.float32)[:, :3]
    centroid = np.mean(pts, axis=0, keepdims=True)
    data = pts - centroid
    furthest = np.amax(np.sqrt(np.sum(data ** 2, axis=-1, keepdims=True)),
                       axis=0, keepdims=True)
    data = data / furthest
    n = data.shape[0]
    num_out = n * UP_RATIO
    if num_out >= 16384:
        raise ValueError("the reference re-stitches by exact FPS below "
                         "16,384 output points only")
    num_patches = max(int(n / num_point * patch_num_ratio), 1)
    shape = torch.from_numpy(np.ascontiguousarray(data))[None]
    seeds = gather(shape, fps(shape, num_patches))
    near = torch.sort(pairwise_dist2(seeds, shape), dim=-1,
                      stable=True).indices[..., :num_point]
    patches = gather(shape, near)[0]
    norm, cen, rad = normalize(patches)
    records = [{} for _ in range(num_patches)]
    up = torch.cat([forward(state, norm[i:i + 1], record=records[i])
                    for i in range(num_patches)])
    merged = (up * rad + cen).reshape(1, -1, 3)
    final = gather(merged, fps(merged, num_out))[0].numpy()
    return final * furthest + centroid, records
