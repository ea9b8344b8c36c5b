"""The progressive upsampling cascade (port of
``threepu/models/upsampler.py``: ``Level`` and ``Net``, train and eval).

Layout is channels-last ``(B, N, 3)``.  The train cascade cuts, at each
level whose input exceeds ``max_num_point``, one kNN patch around a
random seed point per batch element, with the matching gt patch.  The
eval cascade keeps the JAX
package's static-shape masking: outliers are masked out of sub-patch
seeding instead of dropped, sub-patches beyond the reference's dynamic
count (``true_sub``) are phantoms that never enter the merge and are
folded into the next level's ``prev_dup``, and each level's merge
re-stitches by FPS over the real sub-patches only.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from threepu_torch.device import resolve_device
from threepu_torch.io.weights import load_jax_checkpoint
from threepu_torch.models.layers import DenseConv, DenseEdgeConv
from threepu_torch.ops import edgeconv
from threepu_torch.ops.chamfer import self_nn_dist2
from threepu_torch.ops.distances import duplicate_mask
from threepu_torch.ops.fps import _dispatch_fps, fps
from threepu_torch.ops.gather import gather_nd
from threepu_torch.ops.interlevel import interlevel
from threepu_torch.ops.knn import knn_group
from threepu_torch.ops.normalize import normalize_point_batch_cl


def gen_1d_grid(num: int) -> np.ndarray:
    """``(num, 1)`` code column, linspace(-0.2, 0.2)."""
    return np.linspace(-0.2, 0.2, num, dtype=np.float32).reshape(num, 1)


class Level(nn.Module):
    """One ``step_ratio``-times upsampling unit.

    Channels with growth 12, dense_n 3: 3 -> 24 -> 84 -> 144 -> 204 ->
    264, then the code-grid expansion and the coordinate regressor
    128 -> 128 -> 64 -> 3 with a residual skip.
    """

    def __init__(self, dense_n: int = 3, growth_rate: int = 12,
                 knn: int = 16, fm_knn: int = 5, step_ratio: int = 2):
        super().__init__()
        self.fm_knn = fm_knn
        if step_ratio >= 4:
            raise NotImplementedError("only the 1-D code grid (step_ratio "
                                      "< 4) is ported")
        code = gen_1d_grid(step_ratio)
        self.register_buffer("code", torch.from_numpy(code),
                             persistent=False)
        block = 24 + dense_n * growth_rate      # channels an edge conv adds
        self.layer0 = DenseConv(3, 24)
        self.layer1 = DenseEdgeConv(24, growth_rate, dense_n, knn)
        feat = 24 + block
        for i in (2, 3, 4):
            setattr(self, f"layer{i}_prep", DenseConv(feat, 24, "relu", ndim=1))
            setattr(self, f"layer{i}",
                    DenseEdgeConv(24, growth_rate, dense_n, knn))
            feat += block
        self.up_layer = nn.Sequential(OrderedDict(
            up_layer1=DenseConv(feat + code.shape[1], 128, "relu"),
            up_layer2=DenseConv(128, 128, "relu")))
        self.fc_layer1 = DenseConv(128, 64, "relu")
        self.fc_layer2 = DenseConv(64, 3)

    def forward(self, xyz: torch.Tensor, xyz_normalized: torch.Tensor,
                previous_level4: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                prev_group: int = 1,
                prev_dup: Optional[torch.Tensor] = None,
                chain_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``xyz``/``xyz_normalized (B, N, 3)``: the input points, raw
        and normalized.  ``previous_level4 = (prev_xyz (B / prev_group,
        M, 3), prev_feat (B / prev_group, M, C))`` feeds the interlevel
        skip, where each run of ``prev_group`` consecutive batch elements
        shares one previous set; ``prev_dup (B / prev_group, M)`` marks
        previous points that must never be picked (computed here with
        :func:`duplicate_mask` when not given).  ``chain_kernel`` goes
        to the four edge convs (forward-only; eval paths).

        Returns ``(upsampled xyz (B, N*r, 3) in the normalized frame,
        point features (B, N, C))``.
        """
        b, n, _ = xyz_normalized.shape
        # identical points have identical features: one mask on xyz
        # serves every feature-space kNN of the level
        dup = duplicate_mask(xyz_normalized)
        x = self.layer0(xyz_normalized)
        y, _ = self.layer1(x, dup, chain_kernel)
        x = torch.cat([y, x], dim=-1)
        for i in (2, 3, 4):
            prep = getattr(self, f"layer{i}_prep")
            y, _ = getattr(self, f"layer{i}")(prep(x), dup, chain_kernel)
            x = torch.cat([y, x], dim=-1)

        if previous_level4 is not None and self.fm_knn > 0:
            prev_xyz, prev_feat = previous_level4
            if prev_dup is None:
                prev_dup = duplicate_mask(prev_xyz)
            if prev_xyz.shape[0] * prev_group != b:
                raise ValueError("previous set batch times prev_group must "
                                 "equal the batch")
            interp, _ = interlevel(xyz.contiguous(), x.contiguous(),
                                   prev_xyz.contiguous(),
                                   prev_feat.contiguous(),
                                   prev_dup.contiguous(), self.fm_knn)
            x = 0.2 * interp + x
        point_features = x

        # point-major expansion: output slot n*r + j holds point n, code j
        r, c = self.code.shape[0], x.shape[-1]
        x = x[:, :, None, :].expand(b, n, r, c).reshape(b, n * r, c)
        code = self.code.to(x.dtype)[None, None].expand(b, n, r, -1)
        x = torch.cat([x, code.reshape(b, n * r, -1)], dim=-1)
        x = self.fc_layer2(self.fc_layer1(self.up_layer(x)))
        residual = xyz_normalized[:, :, None, :].expand(b, n, r, 3)
        return x + residual.reshape(b, n * r, 3), point_features


class Net(nn.Module):
    """Progressive cascade of ``log_step(max_up_ratio)`` Levels, named
    ``levels.level_1 ...`` as in the reference.  :meth:`forward` runs the
    train cascade (or, with ``train=False``, :meth:`upsample`, the eval
    cascade)."""

    def __init__(self, max_up_ratio: int = 16, step_ratio: int = 2,
                 knn: int = 16, growth_rate: int = 12, dense_n: int = 3,
                 max_num_point: int = 312, fm_knn: int = 5):
        super().__init__()
        self.max_up_ratio = max_up_ratio
        self.step_ratio = step_ratio
        self.max_num_point = max_num_point
        num_levels = int(math.log(max_up_ratio, step_ratio))
        self.levels = nn.ModuleDict(
            (f"level_{l}", Level(dense_n, growth_rate, knn, fm_knn,
                                 step_ratio))
            for l in range(1, num_levels + 1))

    def forward(self, xyz: torch.Tensor, ratio: Optional[int] = None,
                gt: Optional[torch.Tensor] = None, train: bool = True,
                generator: Optional[torch.Generator] = None,
                seed_idx: Optional[Sequence[torch.Tensor]] = None):
        """Train cascade (``threepu/models/upsampler.py:294-336``):
        ``xyz (B, K, 3)`` and ``gt (B, ratio*K, 3)`` -> ``(pred, gt
        patch)``, both ``(B, min(K, max_num_point) * step_ratio, 3)`` once
        a level re-patches, else ``(B, ratio*K, 3)`` and ``gt``.

        Each re-patching level draws one seed point per element: from
        ``seed_idx`` (one ``(B, 1)`` integer tensor per re-patching level,
        in order) when given, else ``torch.randint`` with ``generator``.
        ``train=False`` returns :meth:`upsample`'s result.
        """
        ratio = ratio or self.max_up_ratio
        if not train:
            return self.upsample(xyz, ratio)
        if gt is None:
            raise ValueError("the train cascade needs gt")
        num_levels = int(math.log(ratio, self.step_ratio))
        max_np = min(xyz.shape[1], self.max_num_point)
        seeds = list(seed_idx) if seed_idx is not None else None

        old_xyz = xyz
        xyz, old_feats = self.levels["level_1"](xyz, xyz)
        for l in range(2, num_levels + 1):
            patch_xyz = xyz
            if xyz.shape[1] > max_np:
                b, n, _ = xyz.shape
                if seeds is None:
                    idx = torch.randint(0, n, (b, 1), generator=generator,
                                        device=xyz.device)
                elif seeds:
                    idx = seeds.pop(0).to(xyz.device)
                else:
                    raise ValueError("seed_idx holds fewer tensors than the "
                                     "cascade has re-patching levels")
                gt_k = max_np * ratio // self.step_ratio ** l * self.step_ratio
                patch_xyz, gt = self._extract_patch_train(xyz, max_np, gt,
                                                          gt_k, idx)
            norm, centroid, radius = normalize_point_batch_cl(patch_xyz)
            new_xyz, feats = self.levels[f"level_{l}"](
                patch_xyz, norm, (old_xyz, old_feats))
            xyz = new_xyz * radius + centroid
            old_xyz, old_feats = patch_xyz, feats
        if seeds:
            raise ValueError("seed_idx holds more tensors than the cascade "
                             "has re-patching levels")
        return xyz, gt

    @staticmethod
    def _extract_patch_train(xyz: torch.Tensor, k: int, gt: torch.Tensor,
                             gt_k: int, seed_idx: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``k`` points of ``xyz`` and the ``gt_k`` points of ``gt``
        nearest each element's seed point ``xyz[b, seed_idx[b, 0]]``."""
        seeds = gather_nd(xyz, seed_idx)                     # (B, 1, 3)
        patch = knn_group(seeds, xyz, k).neighbors[:, 0]
        gt_patch = knn_group(seeds, gt, gt_k).neighbors[:, 0]
        return patch, gt_patch

    @torch.no_grad()
    def upsample(self, xyz: torch.Tensor,
                 ratio: Optional[int] = None) -> torch.Tensor:
        """Eval cascade: normalized patches ``(P, N, 3)`` ->
        ``(P, N*ratio, 3)`` in the same frame.  The edge convs take the
        fused chain kernel when :func:`edgeconv.enabled_for` says so,
        read once per call."""
        ratio = ratio or self.max_up_ratio
        num_levels = int(math.log(ratio, self.step_ratio))
        p, num_point, _ = xyz.shape
        max_np = min(num_point, self.max_num_point)
        dev = xyz.device
        chain_kernel = edgeconv.enabled_for(xyz)

        old_xyz = xyz
        xyz, old_feats = self.levels["level_1"](xyz, xyz,
                                                chain_kernel=chain_kernel)
        prev_invalid = None
        for l in range(2, num_levels + 1):
            level = self.levels[f"level_{l}"]
            n_cur = xyz.shape[1]
            if n_cur <= max_np:
                norm, centroid, radius = normalize_point_batch_cl(xyz)
                new_xyz, feats = level(xyz, norm, (old_xyz, old_feats),
                                       chain_kernel=chain_kernel)
                old_xyz, old_feats, prev_invalid = xyz, feats, None
                xyz = new_xyz * radius + centroid
                continue

            n_sub = int(n_cur / max_np * 5)
            sub, true_sub = self._extract_patch_eval(xyz, max_np, n_sub)
            flat = sub.reshape(p * n_sub, max_np, 3)
            norm, centroid, radius = normalize_point_batch_cl(flat)
            # phantom previous rows must never be picked, like duplicates
            prev_dup = duplicate_mask(old_xyz)
            if prev_invalid is not None:
                prev_dup = prev_dup | prev_invalid
            new_xyz, feats = level(flat, norm, (old_xyz, old_feats),
                                   prev_group=n_sub, prev_dup=prev_dup,
                                   chain_kernel=chain_kernel)
            new_xyz = new_xyz * radius + centroid
            # merge the sub-patches of each top patch, then re-stitch by
            # FPS over the real sub-patches only
            patch_valid = (torch.arange(n_sub, device=dev)[None, :]
                           < true_sub[:, None])                # (p, n_sub)
            n_lvl = new_xyz.shape[1]
            merged = new_xyz.reshape(p, n_sub * n_lvl, 3)
            merge_valid = patch_valid[:, :, None].expand(
                p, n_sub, n_lvl).reshape(p, -1)
            sel = _dispatch_fps(merged, num_point * self.step_ratio ** l,
                                merge_valid)
            xyz = gather_nd(merged, sel)
            old_xyz = flat.reshape(p, n_sub * max_np, 3)
            old_feats = feats.reshape(p, n_sub * max_np, -1)
            prev_invalid = ~patch_valid[:, :, None].expand(
                p, n_sub, max_np).reshape(p, -1)
        return xyz

    def _extract_patch_eval(self, xyz: torch.Tensor, k: int, n_sub: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Static-shape sub-patch extraction: points whose NN distance is
        at least 5x the mean are masked out of FPS seeding and ranked
        last in grouping.  ``n_sub`` is the static upper bound; the
        returned ``true_sub (p,)`` is the reference's count from the
        filtered cloud.  Returns ``(patches (p, n_sub, k, 3), true_sub)``.
        """
        closest = self_nn_dist2(xyz)
        mask = closest < 5.0 * torch.mean(closest, dim=-1, keepdim=True)
        n_valid = torch.sum(mask, dim=-1)
        true_sub = torch.clamp((n_valid * 5) // k, 1, n_sub)
        seeds = gather_nd(xyz, fps(xyz.contiguous(), n_sub, mask))
        return knn_group(seeds, xyz, k, valid_mask=mask).neighbors, true_sub


def load_net(weights: Optional[str] = None,
             device: Optional[Union[str, torch.device]] = None,
             **cfg) -> Net:
    """``Net(**cfg)`` on ``device`` — the card unless another device
    (``"cpu"``) is named — with the JAX checkpoint ``weights`` (an
    ``.npz`` path) loaded strictly when given."""
    dev = resolve_device(device)
    net = Net(**cfg)
    if weights is not None:
        net.load_state_dict(load_jax_checkpoint(weights), strict=True)
    return net.to(dev)
