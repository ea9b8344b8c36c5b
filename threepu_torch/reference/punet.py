"""The plain reference of PU-Net's generator (Yu et al., CVPR 2018,
arXiv:1801.06761; ``get_gen_model`` of github.com/yulequan/PU-Net) and of
the whole-shape pipeline around it.

Plain ``torch`` in float32, TF32 off, no kernels and no batching tricks;
it imports neither ``jax``, ``threepu`` nor any ``threepu_torch`` module.
The weights are a state dict under the published scopes
(``layer1.conv0.weight (out, in, 1, 1)``, ``.bias``, ...).

Where an order of operations decides a selection, the reference computes
it as the port's plain versions do, so that on the same inputs both pick
alike: FPS from index 0 with a carry of 1e10, direct squared distances
``(dx*dx + dy*dy) + dz*dz``, ties to the lowest index; ball query and
3-NN ranking on the matmul form ``|a|^2 - 2 a.b + |b|^2``, ties to the
lowest index.

Departures from the published code:

- the ball query tests ``d < r**2`` on the squared matmul-form distance
  in float32; the published op tests ``sqrt(d) < r`` on the direct one;
- the 3-NN ranks on the matmul form; its weights take the direct squared
  distance, as the published ``three_nn`` returns it;
- none in the expansion: its concatenation keeps the published row order
  (row ``i`` of ``f1`` is SA1's ``i``-th FPS pick, row ``i`` of ``up4``,
  ``up3``, ``up2`` and ``xyz`` is input point ``i``).

:func:`pipeline` is the shape-level flow for outputs below 16,384 points:
seed FPS, kNN patches, per-patch normalization, the net, denormalization
and one exact FPS re-stitch (the port's grouped re-stitch above that size
is held by the benchmark's check).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

INIT_DIST = 1e10
MIN_DIST2 = 1e-10
RADII = (0.05, 0.1, 0.2, 0.3)
NSAMPLE = 32
UP_RATIO = 4

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


def direct_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx, dy, dz = (a - b).unbind(-1)
    return dx * dx + dy * dy + dz * dz


def fps(points: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, N, 3)`` -> ``(B, m)`` int32 picks."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    last = torch.zeros(b, dtype=torch.long, device=points.device)
    carry = torch.full(points.shape[:2], INIT_DIST, device=points.device)
    picks = [last]
    for _ in range(m - 1):
        carry = torch.minimum(carry, direct_dist2(
            points, points[rows, last][:, None, :]))
        last = torch.argmax(carry, dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centres: torch.Tensor) -> torch.Tensor:
    """The first ``nsample`` points within ``radius`` of each centre in
    index order, the rest of the row filled with the first of them (all
    zeros without one): int32 ``(B, M, nsample)``."""
    r = np.float32(radius)
    within = pairwise_dist2(centres, xyz) < float(r * r)
    order = torch.sort((~within).to(torch.uint8), dim=-1, stable=True).indices
    if order.shape[-1] < nsample:
        order = torch.cat([order, order[..., :1].expand(
            *order.shape[:-1], nsample - order.shape[-1])], dim=-1)
    order = order[..., :nsample]
    count = within.sum(dim=-1, keepdim=True)
    slot = torch.arange(nsample, device=xyz.device)
    return torch.where(slot < count, order, order[..., :1]).to(torch.int32)


def three_nn(xyz: torch.Tensor, known: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(direct squared distances, int32 idx)``, both ``(B, N, 3)``."""
    order = torch.sort(pairwise_dist2(xyz, known), dim=-1, stable=True)
    idx = order.indices[..., :3]
    return direct_dist2(xyz[..., None, :], gather(known, idx)), \
        idx.to(torch.int32)


def conv(state: State, name: str, x: torch.Tensor,
         relu: bool = True) -> torch.Tensor:
    w = state[name + ".weight"]
    y = torch.matmul(x, w.reshape(w.shape[0], -1).t()) + state[name + ".bias"]
    return torch.relu(y) if relu else y


def forward(state: State, xyz: torch.Tensor,
            record: Optional[dict] = None) -> torch.Tensor:
    """Patches ``(P, N, 3)`` -> ``(P, 4N, 3)``.  ``record``, when given,
    receives the selections and features under the keys the port's
    ``PUNet.upsample`` capture uses."""
    _fp32()
    rec = {} if record is None else record
    n = xyz.shape[1]
    l_xyz, l_feat, sa = xyz, None, []
    for l, radius in enumerate(RADII, start=1):
        picks = fps(l_xyz, n // 2 ** (l - 1))
        centres = gather(l_xyz, picks)
        idx = ball_query(radius, NSAMPLE, l_xyz, centres)
        x = gather(l_xyz, idx) - centres[:, :, None, :]
        if l_feat is not None:
            x = torch.cat([x, gather(l_feat, idx)], dim=-1)
        j = 0
        while f"layer{l}.conv{j}.weight" in state:
            x = conv(state, f"layer{l}.conv{j}", x)
            j += 1
        l_xyz, l_feat = centres, torch.amax(x, dim=2)
        sa.append((l_xyz, l_feat))
        rec.update({f"sa{l}.picks": picks, f"sa{l}.ball": idx,
                    f"sa{l}.xyz": l_xyz, f"sa{l}.features": l_feat})
    ups = []
    for k in range(1, len(RADII)):
        l = len(RADII) + 1 - k
        known, feat = sa[l - 1]
        d, nn_idx = three_nn(xyz, known)
        inv = 1.0 / torch.clamp(d, min=MIN_DIST2)
        w = inv / torch.sum(inv, dim=-1, keepdim=True)
        interp = torch.sum(gather(feat, nn_idx) * w[..., None], dim=-2)
        ups.append(conv(state, f"fa_layer{k}.conv_0", interp))
        rec.update({f"fp{l}.nn": nn_idx, f"fp{l}.features": ups[-1]})
    x = torch.cat(ups + [sa[0][1], xyz], dim=-1)
    branches = [conv(state, f"up_layer.conv_{i}",
                     conv(state, f"up_layer.fc_layer0_{i}", x))
                for i in range(UP_RATIO)]
    feat = torch.cat(branches, dim=1)
    out = conv(state, "fc_layer2", conv(state, "fc_layer1", feat), relu=False)
    rec.update({"expand.features": feat, "coords": out})
    return out


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
