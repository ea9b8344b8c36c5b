"""The progressive upsampling cascade (port of
``threepu/models/upsampler.py``: ``Level`` and ``Net``, train and eval,
and ``AdaptiveLevel``).

Layout is channels-last ``(B, N, 3)``.  The train cascade cuts, at each
level whose input exceeds ``max_num_point``, one kNN patch around a
random seed point per batch element, with the matching gt patch.  The
eval cascade keeps the JAX
package's static-shape masking: outliers are masked out of sub-patch
seeding instead of dropped, sub-patches beyond the reference's dynamic
count (``true_sub``) are phantoms that never enter the merge and are
folded into the next level's ``prev_dup``, and each level's merge
re-stitches by FPS over the real sub-patches only.

A ``capture`` dict given to :meth:`Net.upsample` (or to a
:class:`Level`) receives each level's input points, layer features and
edge-conv kNN indices, keyed ``"level_<l>.<name>"`` as the JAX package's
flax ``intermediates`` collection holds them; without one nothing is
recorded.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from functools import partial
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from threepu_torch.device import resolve_device
from threepu_torch.io.weights import load_jax_checkpoint
from threepu_torch.models.graphs import EAGER, GraphedNet, Stages
from threepu_torch.models.layers import (DenseConv, DenseEdgeConv,
                                         SampledDenseEdgeConv)
from threepu_torch.models.punet import PUNet
from threepu_torch.ops import edgeconv
from threepu_torch.ops.chamfer import self_nn_dist2
from threepu_torch.ops.distances import duplicate_mask
from threepu_torch.ops.fps import _dispatch_fps, fps
from threepu_torch.ops.gather import batched_gather, gather_nd
from threepu_torch.ops.interlevel import interlevel
from threepu_torch.ops.knn import knn_group
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.utils.profiling import span


#: what a capture holds: ``{"level_<l>.<name>": tensor}``
Capture = Dict[str, torch.Tensor]


def exponential_distance(points: torch.Tensor, knn_points: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``points (B, N, C)``, ``knn_points (B, N, K, C)`` -> ``(d, w)``,
    both ``(B, N, K)`` and without gradient: squared distances and the
    interlevel skip's weights ``exp(-d / (h / 2))``, ``h`` the mean over
    the points of the min over ``K`` (the plain form of what
    :func:`~threepu_torch.ops.interlevel.interlevel` computes)."""
    diff = points[..., :, None, :] - knn_points
    d = torch.sum(diff * diff, dim=-1).detach()
    h = torch.mean(torch.amin(d, dim=-1, keepdim=True), dim=-2, keepdim=True)
    return d, torch.exp(-d / (h / 2.0))


def gen_1d_grid(num: int) -> np.ndarray:
    """``(num, 1)`` code column, linspace(-0.2, 0.2)."""
    return np.linspace(-0.2, 0.2, num, dtype=np.float32).reshape(num, 1)


def _square_grid(grid_size: int, extent: float) -> np.ndarray:
    """``(grid_size**2, 2)`` grid of linspace(-extent, extent) on both
    axes, the first axis slowest (``meshgrid(..., indexing="ij")``)."""
    x = np.linspace(-extent, extent, grid_size, dtype=np.float32)
    gx, gy = np.meshgrid(x, x, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def gen_grid(grid_size: int) -> np.ndarray:
    """``(grid_size**2, 2)`` code grid, linspace(-0.2, 0.2) on both axes."""
    return _square_grid(grid_size, 0.2)


def level_code(step_ratio: int) -> np.ndarray:
    """A Level's code points: the 1-D column below ``step_ratio`` 4, else
    the 2-D grid of ``round(sqrt(step_ratio))**2`` points (the JAX
    package's fix of the reference, whose grid holds that count squared
    and breaks its own cascade)."""
    if step_ratio < 4:
        return gen_1d_grid(step_ratio)
    expansion = round(math.sqrt(step_ratio)) ** 2
    return gen_grid(round(math.sqrt(expansion)))


class Level(nn.Module):
    """One ``step_ratio``-times upsampling unit.

    Channels with growth 12, dense_n 3: 3 -> 24 -> 84 -> 144 -> 204 ->
    264, then the code-grid expansion (:func:`level_code`: 1 code
    channel below ``step_ratio`` 4, else 2) and the coordinate regressor
    128 -> 128 -> 64 -> 3 with a residual skip.

    ``span_name`` names the level's stage (:meth:`forward`) and prefixes
    the names of the spans its work records
    (:func:`~threepu_torch.utils.profiling.span`) where it runs as
    written, not as a graph's replay: ``<span_name>.conv1`` ... ``.conv4``
    (each edge conv with its prep; ``conv1`` also the duplicate mask and
    ``layer0``), ``.interlevel`` and ``.head`` (the expansion and the
    coordinate regressor).
    """

    def __init__(self, dense_n: int = 3, growth_rate: int = 12,
                 knn: int = 16, fm_knn: int = 5, step_ratio: int = 2, *,
                 span_name: str):
        super().__init__()
        self.fm_knn = fm_knn
        self.span_name = span_name
        code = level_code(step_ratio)
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
                chain_kernel: bool = False,
                capture: Optional[Capture] = None,
                stages: Stages = EAGER
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``xyz``/``xyz_normalized (B, N, 3)``: the input points, raw
        and normalized.  ``previous_level4 = (prev_xyz (B / prev_group,
        M, 3), prev_feat (B / prev_group, M, C))`` feeds the interlevel
        skip, where each run of ``prev_group`` consecutive batch elements
        shares one previous set; ``prev_dup (B / prev_group, M)`` marks
        previous points that must never be picked (computed here with
        :func:`duplicate_mask` when not given).  ``chain_kernel`` goes
        to the four edge convs (forward-only; eval paths).  ``capture``
        receives ``xyz_in`` (``xyz``), ``layer_0`` ... ``layer_4`` (the
        features after each block) and ``nnIdx_layer_0`` ...
        ``nnIdx_layer_3`` (each edge conv's kNN indices).  ``stages``
        (:class:`~threepu_torch.models.graphs.Stages`) runs the level as
        one stage named ``span_name``, a CUDA graph under
        :meth:`Net.upsample` on a card: the arguments are copied into its
        static inputs and the results come back as copies, so a caller
        may keep both across later calls.

        Returns ``(upsampled xyz (B, N*r, 3) in the normalized frame,
        point features (B, N, C))``.
        """
        args = (xyz, xyz_normalized)
        if previous_level4 is not None:
            args += tuple(previous_level4)
            if prev_dup is not None:
                args += (prev_dup,)
        out, point_features = stages(
            self.span_name,
            partial(self._body, prev_group, chain_kernel, capture), *args)
        return stages.own(out), stages.own(point_features)

    def _body(self, prev_group: int, chain_kernel: bool,
              capture: Optional[Capture], xyz: torch.Tensor,
              xyz_normalized: torch.Tensor,
              prev_xyz: Optional[torch.Tensor] = None,
              prev_feat: Optional[torch.Tensor] = None,
              prev_dup: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward`'s work, with its arguments unpacked."""
        b, n, _ = xyz_normalized.shape
        name = self.span_name
        with span(f"{name}.conv1"):
            # identical points have identical features: one mask on xyz
            # serves every feature-space kNN of the level
            dup = duplicate_mask(xyz_normalized)
            x = self.layer0(xyz_normalized)
            if capture is not None:
                capture.update(xyz_in=xyz, layer_0=x)
            x = self._dense_block(1, x, x, dup, chain_kernel, capture)
        for i in (2, 3, 4):
            with span(f"{name}.conv{i}"):
                inp = getattr(self, f"layer{i}_prep")(x)
                x = self._dense_block(i, x, inp, dup, chain_kernel, capture)

        if prev_xyz is not None and self.fm_knn > 0:
            with span(f"{name}.interlevel"):
                if prev_dup is None:
                    prev_dup = duplicate_mask(prev_xyz)
                if prev_xyz.shape[0] * prev_group != b:
                    raise ValueError("previous set batch times prev_group "
                                     "must equal the batch")
                interp, _ = interlevel(xyz.contiguous(), x.contiguous(),
                                       prev_xyz.contiguous(),
                                       prev_feat.contiguous(),
                                       prev_dup.contiguous(), self.fm_knn)
                x = 0.2 * interp + x
        point_features = x

        with span(f"{name}.head"):
            # point-major expansion: output slot n*r + j holds point n,
            # code j
            r, c = self.code.shape[0], x.shape[-1]
            x = x[:, :, None, :].expand(b, n, r, c).reshape(b, n * r, c)
            code = self.code.to(x.dtype)[None, None].expand(b, n, r, -1)
            x = torch.cat([x, code.reshape(b, n * r, -1)], dim=-1)
            x = self.fc_layer2(self.fc_layer1(self.up_layer(x)))
            residual = xyz_normalized[:, :, None, :].expand(b, n, r, 3)
            return x + residual.reshape(b, n * r, 3), point_features

    def _dense_block(self, i: int, x: torch.Tensor, inp: torch.Tensor,
                     dup: torch.Tensor, chain_kernel: bool,
                     capture: Optional[Capture]) -> torch.Tensor:
        """Edge conv ``layer<i>`` on ``inp``, its output put before the
        features ``x``."""
        y, idx = getattr(self, f"layer{i}")(inp, dup, chain_kernel)
        x = torch.cat([y, x], dim=-1)
        if capture is not None:
            capture[f"layer_{i}"] = x
            capture[f"nnIdx_layer_{i - 1}"] = idx
        return x


class Net(GraphedNet):
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
        self.dense_n, self.growth_rate = dense_n, growth_rate
        num_levels = int(math.log(max_up_ratio, step_ratio))
        self.levels = nn.ModuleDict(
            (f"level_{l}", Level(dense_n, growth_rate, knn, fm_knn,
                                 step_ratio, span_name=f"level{l}"))
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
    def upsample(self, xyz: torch.Tensor, ratio: Optional[int] = None,
                 capture: Optional[Capture] = None) -> torch.Tensor:
        """Eval cascade: normalized patches ``(P, N, 3)`` ->
        ``(P, N*ratio, 3)`` in the same frame.  The edge convs take the
        fused chain kernel where :func:`edgeconv.takes_kernel` says so for
        ``xyz`` and the net's stages and growth rate, else the plain
        chain; decided once per call.  ``capture``, when given, receives
        every level's intermediates (:class:`Level`) under
        ``"level_<l>."``.

        On a CUDA tensor without a ``capture``, every stage of the
        cascade is a CUDA graph once two calls in a row have asked for its
        chunk shape, ratio and device
        (:meth:`~threepu_torch.models.graphs.GraphedNet.stages_for`).  The
        stages are each level (:class:`Level`) and each re-patching
        level's ``extract`` and ``merge_fps``.  Every level is still
        called on every chunk, with arguments and results that are the
        caller's own, as is the output, so callers may keep a level's
        inputs and outputs across chunks.
        """
        ratio = ratio or self.max_up_ratio
        num_levels = int(math.log(ratio, self.step_ratio))
        p, num_point, _ = xyz.shape
        max_np = min(num_point, self.max_num_point)
        chain_kernel = edgeconv.takes_kernel(xyz, self.dense_n,
                                             self.growth_rate)
        stages = EAGER if capture is not None else self.stages_for(xyz, ratio)

        def level(l, *args, **kw):
            level_capture = None if capture is None else {}
            out = self.levels[f"level_{l}"](*args, chain_kernel=chain_kernel,
                                            capture=level_capture,
                                            stages=stages, **kw)
            if capture is not None:
                capture.update((f"level_{l}.{name}", t)
                               for name, t in level_capture.items())
            return out

        # old_xyz / old_feats go to the next level; prev_xyz, the stages'
        # own old_xyz, and valid, which of the previous level's
        # sub-patches are real, go to the next extract
        old_xyz = prev_xyz = xyz
        with span("level1", on=xyz):
            xyz, old_feats = level(1, xyz, xyz)
        valid = None
        for l in range(2, num_levels + 1):
            n_cur = xyz.shape[1]
            n_sub = int(n_cur / max_np * 5)
            n_lvl = max_np * self.levels[f"level_{l}"].code.shape[0]
            with span(f"level{l}", on=xyz):
                with span(f"level{l}.extract"):
                    flat, norm, centroid, radius, prev_dup, valid, \
                        merge_valid = stages(
                            f"level{l}.extract",
                            partial(self._extract, max_np, n_sub, n_lvl),
                            xyz, prev_xyz,
                            *(() if valid is None else (valid,)))
                prev_xyz = flat.reshape(p, n_sub * max_np, 3)
                flat, norm = stages.own(flat), stages.own(norm)
                new_xyz, feats = level(l, flat, norm, (old_xyz, old_feats),
                                       prev_group=n_sub,
                                       prev_dup=stages.own(prev_dup))
                # the sub-patches' outputs in their patch's frame, merged
                # a patch
                merged = (new_xyz * radius + centroid).reshape(p, -1, 3)
                with span(f"level{l}.merge_fps"):
                    xyz = stages(f"level{l}.merge_fps",
                                 partial(self._merge,
                                         num_point * self.step_ratio ** l),
                                 merged, merge_valid)
                old_xyz = flat.reshape(p, n_sub * max_np, 3)
                old_feats = feats.reshape(p, n_sub * max_np, -1)
        return xyz if num_levels == 1 else stages.own(xyz)

    def _extract(self, k: int, n_sub: int, n_lvl: int, xyz: torch.Tensor,
                 prev_xyz: torch.Tensor,
                 prev_valid: Optional[torch.Tensor] = None):
        """A re-patching level's inputs from the last level's output
        ``xyz (p, n, 3)`` and input ``prev_xyz (p, M, 3)``: the
        sub-patches ``(p * n_sub, k, 3)`` (:meth:`_extract_patch_eval`),
        normalized, with their centroids and radii; ``prev_dup (p, M)``,
        duplicates of ``prev_xyz`` and rows of the sub-patches that
        ``prev_valid (p, M / k)`` marks as phantoms; which of the
        ``n_sub`` sub-patches are real, ``(p, n_sub)``, and which of
        their ``n_lvl`` outputs each enter the merge, ``(p, n_sub *
        n_lvl)``."""
        p = xyz.shape[0]
        sub, true_sub = self._extract_patch_eval(xyz, k, n_sub)
        flat = sub.reshape(p * n_sub, k, 3)
        norm, centroid, radius = normalize_point_batch_cl(flat)
        # phantom previous rows must never be picked, like duplicates
        prev_dup = duplicate_mask(prev_xyz)
        if prev_valid is not None:
            prev_dup = prev_dup | ~prev_valid[:, :, None].expand(
                p, prev_valid.shape[1], k).reshape(p, -1)
        valid = (torch.arange(n_sub, device=xyz.device)[None, :]
                 < true_sub[:, None])
        merge_valid = valid[:, :, None].expand(p, n_sub, n_lvl).reshape(p, -1)
        return flat, norm, centroid, radius, prev_dup, valid, merge_valid

    @staticmethod
    def _merge(m: int, merged: torch.Tensor, merge_valid: torch.Tensor
               ) -> torch.Tensor:
        """The merged sub-patches of each patch re-stitched to ``m``
        points by FPS over the real sub-patches only."""
        return gather_nd(merged, _dispatch_fps(merged, m, merge_valid))

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


class AdaptiveLevel(nn.Module):
    """Upsampling unit with a free output count
    (``threepu/models/upsampler.py:486-558``; the reference's ``main.py``
    never runs it).  Downsamples 48 -> 16 -> 1 points with
    :class:`SampledDenseEdgeConv` to one global feature, then decodes
    ``round(sqrt(target))**2`` points from a 2-D code grid in [-1, 1].

    ``layer4`` takes ``knn + 1`` neighbours among the 16 points ``layer3``
    leaves, so ``knn`` must stay below 16 (the reference's default 16
    raises there, in the JAX package and the reference alike).
    """

    def __init__(self, dense_n: int = 3, growth_rate: int = 12,
                 knn: int = 16, fm_knn: int = 5):
        super().__init__()
        self.fm_knn = fm_knn
        block = 24 + dense_n * growth_rate
        self.layer0 = DenseConv(3, 24)
        self.layer1 = DenseEdgeConv(24, growth_rate, dense_n, knn)
        feat = 24 + block
        for i in (2, 3, 4):
            setattr(self, f"layer{i}_prep", DenseConv(feat, 24, "relu", ndim=1))
            setattr(self, f"layer{i}",
                    SampledDenseEdgeConv(24, growth_rate, dense_n, knn))
            feat += block
        self.up_layer = nn.Sequential(OrderedDict(
            up_layer1=DenseConv(feat + 2, 128, "relu"),
            up_layer2=DenseConv(128, 128, "relu")))
        self.fc_layer1 = DenseConv(128, 64, "relu")
        self.fc_layer2 = DenseConv(64, 3)

    @staticmethod
    def gen_grid(grid_size: int) -> np.ndarray:
        """``(grid_size**2, 2)`` code grid, linspace(-1, 1) on both axes."""
        return _square_grid(grid_size, 1.0)

    def interpolate(self, prev_xyz: torch.Tensor, xyz: torch.Tensor,
                    prev_feat: torch.Tensor) -> torch.Tensor:
        """Features at ``xyz (B, S, 3)`` from the ``fm_knn`` nearest of
        ``prev_xyz`` (unique kNN): weights ``exp(-d / (h / 2))`` of the
        spatial squared distance alone, ``h`` the mean nearest distance
        plus 1e-5, normalized by ``sum(w + 1e-5)``; no gradient through
        them."""
        res = knn_group(xyz, prev_xyz, self.fm_knn, unique=True)
        feats = batched_gather(prev_feat, res.idx)
        diff = xyz[..., :, None, :] - res.neighbors
        d = torch.sum(diff * diff, dim=-1).detach()
        h = torch.mean(torch.amin(d, dim=-1, keepdim=True), dim=-2,
                       keepdim=True) + 1e-5
        w = torch.exp(-d / (h / 2.0))
        w = w / torch.sum(w + 1e-5, dim=-1, keepdim=True)
        return torch.sum(w[..., None] * feats, dim=-2)

    def forward(self, xyz: torch.Tensor, target_n_point: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``xyz (B, N, 3)`` -> ``(points (B, round(sqrt(target))**2, 3)``
        in ``xyz``'s frame, global features ``(B, 1, C))``."""
        b = xyz.shape[0]
        code = torch.from_numpy(self.gen_grid(round(math.sqrt(target_n_point)))
                                ).to(device=xyz.device, dtype=xyz.dtype)
        xyz_n, centroid, radius = normalize_point_batch_cl(xyz)
        x = self.layer0(xyz_n)
        y, _ = self.layer1(x)
        x = torch.cat([y, x], dim=-1)
        prev_xyz = xyz_n
        for i, nsample in ((2, 48), (3, 16), (4, 1)):
            prep = getattr(self, f"layer{i}_prep")
            y, s_xyz, _ = getattr(self, f"layer{i}")(prep(x), nsample, prev_xyz)
            x = torch.cat([y, self.interpolate(prev_xyz, s_xyz, x)], dim=-1)
            prev_xyz = s_xyz
        global_features = x                                   # (B, 1, C)
        t = code.shape[0]
        x = torch.cat([x.expand(b, t, x.shape[-1]), code[None].expand(b, t, 2)],
                      dim=-1)
        x = self.fc_layer2(self.fc_layer1(self.up_layer(x)))
        return x * radius.detach() + centroid.detach(), global_features


def load_net(weights: Optional[str] = None,
             device: Optional[Union[str, torch.device]] = None,
             arch: str = "3pu", **cfg) -> nn.Module:
    """The net of ``arch`` built from ``cfg`` on ``device`` — the card
    unless another device (``"cpu"``) is named — with ``weights`` loaded
    strictly when given: ``"3pu"``, ``Net(**cfg)`` and a JAX checkpoint
    (an ``.npz`` path); ``"punet"``, ``PUNet(**cfg)`` and the ``.pth``
    that ``torch.save(net.state_dict())`` wrote (the published scope
    names)."""
    dev = resolve_device(device)
    if arch == "punet":
        net = PUNet(**cfg)
        if weights is not None:
            net.load_state_dict(torch.load(weights, map_location="cpu",
                                           weights_only=True), strict=True)
        return net.to(dev)
    if arch != "3pu":
        raise ValueError(f"no net {arch!r}: '3pu' or 'punet'")
    net = Net(**cfg)
    if weights is not None:
        net.load_state_dict(load_jax_checkpoint(weights), strict=True)
    return net.to(dev)
