"""Whole-shape upsampling pipeline (port of ``threepu/inference.py``).

Seed FPS picks the patch centres, kNN grouping forms the patches, each
patch is normalized, the ``Net`` eval cascade runs over patch chunks,
the patches are denormalized and merged, and a final FPS re-stitches
the merge to ``num_out`` points.  Everything runs on the device of the
input tensor; the host touches the data to upload the shape and to
download the result.  On a CUDA device a rank's chunks run two at a
time, in turn on the two stream slots of
:class:`threepu_torch.models.graphs.SlotStreams`, each with the net's
graphs of its slot, so that one chunk's work fills the SMs that the
other's merge FPS leaves idle.  With a ``mesh``
(:class:`threepu_torch.parallel.Mesh`) the patches split over its ranks
and one all-gather merges them (:mod:`threepu_torch.parallel`).
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional, Protocol, Tuple, Union

import numpy as np
import torch

from threepu_torch.models.graphs import SLOTS, SlotStreams
from threepu_torch.ops.fps import PALLAS_MAX_N, _dispatch_fps, fps_hierarchical
from threepu_torch.ops.gather import gather_nd
from threepu_torch.ops.knn import knn_group
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.utils import pc_utils
from threepu_torch.utils.profiling import span

#: group count of the hierarchical final re-stitch, and the output size
#: from which it engages when ``restitch_groups`` is left unset (the JAX
#: package's defaults, chosen there at trained weights)
DEFAULT_RESTITCH_GROUPS = 8
RESTITCH_AUTO_MIN_OUT = 16384

#: chunks run by stream slot, where a rank's chunks ran two at a time:
#: how often the overlap engaged
SLOT_CHUNKS: collections.Counter = collections.Counter()


class Upsampler(Protocol):
    """A net of the eval path (``Net``, ``PUNet``, ``PUGAN``): normalized
    patches ``(P, N, 3)`` in, ``(P, N * ratio, 3)`` out, in the same
    frame."""

    def upsample(self, xyz: torch.Tensor, ratio: Optional[int] = None,
                 capture: Optional[dict] = None) -> torch.Tensor: ...

    def parameters(self) -> Iterator[torch.nn.Parameter]: ...


def plan_patches(num_shape_point: int, num_point: int,
                 patch_num_ratio: float = 3.0,
                 chunk: Optional[int] = None,
                 n_dev: int = 1) -> Tuple[int, int, int]:
    """``(num_patches, padded_num_patches, chunk)``: the reference's
    patch count ``int(N / num_point * patch_num_ratio)``, padded up to a
    whole number of chunks on each of ``n_dev`` ranks (the chunk capped
    at a rank's share)."""
    num_patches = max(int(num_shape_point / num_point * patch_num_ratio), 1)
    local = -(-num_patches // n_dev)
    if chunk is None or chunk >= local:
        chunk = local
    padded = -(-num_patches // (chunk * n_dev)) * chunk * n_dev
    return num_patches, padded, chunk


def cut_patches(shape_b: torch.Tensor, num_patches: int, num_point: int,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``num_point`` points of ``shape_b (1, N, 3)`` nearest each of
    ``num_patches`` FPS seeds, ``(num_patches, num_point, 3)``; points
    outside ``valid_mask (1, N)`` are neither seeds nor picked first."""
    seeds = gather_nd(shape_b, _dispatch_fps(shape_b, num_patches,
                                             valid_mask))
    return knn_group(seeds, shape_b, num_point,
                     valid_mask=valid_mask).neighbors[0]


def resolve_restitch_groups(requested: Optional[int], num_out: int) -> int:
    """``restitch_groups`` argument -> group count (``None`` = auto)."""
    if requested is not None:
        return requested
    return DEFAULT_RESTITCH_GROUPS if num_out >= RESTITCH_AUTO_MIN_OUT else 1


@torch.no_grad()
def upsample_point_cloud(net: Upsampler, xyz: torch.Tensor, ratio: int,
                         num_point: int, num_out: int,
                         patch_num_ratio: float = 3.0,
                         chunk: Optional[int] = None,
                         valid_n: Optional[Union[int, torch.Tensor]] = None,
                         valid_patches: Optional[Union[int,
                                                       torch.Tensor]] = None,
                         restitch_groups: Optional[int] = None,
                         mesh=None) -> torch.Tensor:
    """Upsample one shape ``xyz (N, 3)``, already normalized to the unit
    sphere, to ``(num_out, 3)`` in the same frame.

    ``valid_n``: only the first ``valid_n`` rows of ``xyz`` are real (the
    rest are padding, masked out of seed FPS, grouping and the final
    FPS).  ``valid_patches``: the patch count of the real size; seeds
    beyond it are masked out of the merge.  ``restitch_groups``: ``None``
    = G=8 hierarchical final FPS from 16384 output points up and exact
    FPS below; 1 = exact everywhere; G > 1 = Morton-stratified FPS over
    G groups.

    ``mesh`` (a :class:`threepu_torch.parallel.Mesh`; ``xyz`` and the net
    on its device): every rank runs the seed FPS, grouping and
    normalization, the cascade over its own contiguous ``padded / size``
    patches, one all-gather of the denormalized patches and the final
    FPS, in which the padding patches are masked; every rank returns the
    whole output.
    """
    n = xyz.shape[0]
    dev = xyz.device
    num_patches, padded, chunk = plan_patches(
        n, num_point, patch_num_ratio, chunk,
        1 if mesh is None else mesh.size)
    with span("seed", on=xyz):
        shape_b = xyz[None]                                   # (1, N, 3)
        n_mask = None
        if valid_n is not None:
            n_mask = (torch.arange(n, device=dev) < valid_n)[None]
        patches = cut_patches(shape_b, num_patches, num_point, n_mask)
        if padded != num_patches:
            pad = patches[:1].expand(padded - num_patches, -1, -1)
            patches = torch.cat([patches, pad], dim=0)
        norm, centroid, radius = normalize_point_batch_cl(patches)

    lo, hi = 0, padded                  # this rank's patches
    if mesh is not None:
        local = padded // mesh.size
        lo, hi = mesh.rank * local, (mesh.rank + 1) * local
    starts = range(lo, hi, chunk)
    ups = []
    with span("cascades", on=xyz):
        if len(starts) > 1 and SlotStreams.streamed(xyz):
            # the chunks in turn on the two slots' streams, which wait for
            # the seed; norm outlives the join, so no slot reads it freed
            slots = SlotStreams.of(dev)
            slots.fork()
            for j, i in enumerate(starts):
                with slots.run(j % SLOTS), span("cascade", on=xyz):
                    ups.append(net.upsample(norm[i:i + chunk], ratio))
                SLOT_CHUNKS[j % SLOTS] += 1
            slots.join(ups)
        else:
            for i in starts:
                with span("cascade", on=xyz):
                    ups.append(net.upsample(norm[i:i + chunk], ratio))
    up = torch.cat(ups, dim=0)
    up = up * radius[lo:hi] + centroid[lo:hi]                 # denormalize
    if mesh is not None:
        # the one collective of a shape: no FPS pick loop or cascade runs
        # one, and the re-stitch runs on every rank
        up = mesh.all_gather(up.new_empty((padded,) + up.shape[1:]), up)
    merged = up.reshape(1, padded * num_point * ratio, 3)

    valid = None
    patch_limit = valid_patches
    if patch_limit is None and padded != num_patches:
        patch_limit = num_patches
    if patch_limit is not None:
        valid = torch.arange(padded, device=dev)[:, None] < patch_limit
        valid = valid.expand(padded, num_point * ratio).reshape(1, -1)
    groups = resolve_restitch_groups(restitch_groups, num_out)
    with span("restitch", on=xyz):
        if groups > 1:
            # restitch_groups is a lower bound on the grouping: no group
            # may outgrow what the FPS kernel's callers expect of one cloud
            group_max = min(-(-merged.shape[1] // groups), PALLAS_MAX_N)
            final_idx = fps_hierarchical(merged, num_out, valid_mask=valid,
                                         group_max=group_max)
        else:
            final_idx = _dispatch_fps(merged, num_out, valid)
        return gather_nd(merged, final_idx)[0]


def bucket_size(n: int, quantum: int = 1024) -> int:
    """``n`` rounded up to the next multiple of ``quantum``."""
    return -(-n // quantum) * quantum


def upsample_shape(net: Upsampler, points: np.ndarray, ratio: int,
                   num_point: int = 312, patch_num_ratio: float = 3.0,
                   chunk: Optional[int] = 8,
                   num_shape_point: Optional[int] = None,
                   jitter: bool = False, jitter_sigma: float = 0.0025,
                   jitter_max: float = 0.005, drop_out: float = 1.0,
                   seed: int = 0, bucket: Optional[int] = None,
                   restitch_groups: Optional[int] = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing flow of the reference's ``test()``: optional FPS
    drop-out to ``num_shape_point * drop_out`` points, normalize,
    optional jitter (numpy, seeded by ``seed``), the device pipeline,
    denormalize.  Runs on the device that holds ``net``.

    ``bucket`` (a point-count quantum, such as 1024) zero-pads the shape
    to the next multiple and masks the padding out of seed FPS, grouping
    and the final FPS, so that every size of a bucket runs at one set of
    tensor shapes.  FPS picks are prefix-consistent and masked points
    cannot be picked, so the result has the selection semantics of the
    exact size: bit-identical on the CPU; on the card the padded
    distance matrices may round apart and flip near-ties, and the
    outputs then agree as point sets.

    ``mesh``: the patches split over its ranks, as in
    :func:`upsample_point_cloud`; every rank returns the whole result.

    Returns ``(input points as processed, upsampled points)``, both in
    the original frame.
    """
    dev = next(net.parameters()).device
    points = np.asarray(points, np.float32)[..., :3]
    n_keep = int((num_shape_point or points.shape[0]) * drop_out)
    num_out = n_keep * ratio
    kwargs = dict(patch_num_ratio=patch_num_ratio, chunk=chunk,
                  restitch_groups=restitch_groups, mesh=mesh)
    with span("shape", on=dev):
        with span("prepare"):
            if drop_out < 1.0:
                pts_b = torch.from_numpy(points[None]).to(dev)
                idx = _dispatch_fps(pts_b, n_keep)
                points = gather_nd(pts_b, idx)[0].cpu().numpy()

            data, centroid, furthest = pc_utils.normalize_point_cloud(points)
            if jitter:
                is_2d = bool(np.all(data[:, 2] == 0))
                data = pc_utils.jitter_perturbation_point_cloud(
                    data[None], np.random.default_rng(seed),
                    sigma=jitter_sigma, clip=jitter_max, is_2D=is_2d)[0]
            n_real = data.shape[0]
            bucketed = (bucket is not None
                        and bucket_size(n_real, bucket) != n_real)
            if bucketed:
                n_b = bucket_size(n_real, bucket)
                padded = np.zeros((n_b, 3), np.float32)
                padded[:n_real] = data
                xyz = torch.from_numpy(padded).to(dev)
                kwargs.update(valid_n=n_real, valid_patches=plan_patches(
                    n_real, num_point, patch_num_ratio)[0])
            else:
                xyz = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        up = upsample_point_cloud(
            net, xyz, ratio, num_point,
            xyz.shape[0] * ratio if bucketed else num_out, **kwargs)
        if bucketed:
            up = up[:num_out]
        with span("finish"):
            with span("finish.download"):
                up = up.cpu().numpy()
            with span("finish.host"):
                return data * furthest + centroid, up * furthest + centroid
