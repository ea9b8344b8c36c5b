#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``threepu_torch``) on one GPU.

    python3 chip_smoke.py [--profile STEPS]

Phases, in order; any failure ends the script with a non-zero exit and
no result line:

1. Device: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions; exits non-zero when no GPU is visible.
2. Build: compiles ``threepu_torch/csrc/*.cu`` for sm_90a with nvcc.
3. Kernels against their plain PyTorch versions, at the shapes of the
   16x pipeline: select (k=33 over (320, 312, 312), injected ties and
   1e30 penalty columns) and FPS (the level-4 merge, 8 x 24960 -> 4992,
   and the final re-stitch, 8 x 29952 -> 10000, with a mask and
   non-finite points) must match exactly;
   interlevel (P=8, group 40, M=6240 and group 20, M=3120, C=264, k=5)
   must pick the same indices and agree to 1e-5, and so must, at the
   train step's shape (B = P = 16, M = 312), its weights output and the
   ``prev_feat`` gradient of its backward; the one-way nearest
   neighbour of the Chamfer loss ((16, 624) x (16, 624), the train
   loss, and the JAX package's 80k output against the 80k ground truth)
   must match exactly, values and indices.  Each kernel's time is
   printed beside its plain version's, the time of one PyTorch call
   computing the same function where there is one (``torch.topk`` for
   select, ``torch.cdist(...).min(-1)`` for the Chamfer kernel), and its
   bound: the least time an H100 SXM could take, the larger of the
   operations over 67 TFLOP/s fp32 and the bytes over 3.35 TB/s.
4. End to end, with the trained weights of
   ``artifacts/prod_clean_final.npz`` and the JAX package's results
   frozen in ``tests/fixtures/torch_port_ref.npz``:

   a. Cascade replay: the 16x cascade of one 312-point patch, each step
      fed JAX's own input for it, so that no FPS near-tie can flip
      between the two.  At every level, at least 99% of the output
      rows must lie within 1e-4 of JAX's (a flipped near-tie in a
      feature-space kNN moves a few), the sub-patches must hold at
      least 99% of JAX's points, and their real counts must be JAX's.
   b. The pipeline: held-out shape 0 (5000 points) upsampled 16x to
      80,000 points, chunk 8, G=8 re-stitch.  The launch counts of all
      three kernels must be above zero for that run, the output finite
      and (80000, 3), its Chamfer distance to the ground truth within
      5% of the JAX package's, and its Chamfer distance to the JAX
      output no larger than the JAX package's distance to itself when
      its input is perturbed by 1e-6 (relative): float rounding flips
      near-ties of the re-stitch FPS, so this band holds the port to
      the surface, and (a) to the numbers.

5. Training, at full width with the trained weights and the JAX
   package's results frozen in ``tests/fixtures/torch_train_ref.npz``:

   a. Batches 16 x 312 at ratio 2 and 16 cut from shape 0 by
      ``sample_batch`` with the fixture's seed points and angles: at
      least 99.9% of their points must coincide with JAX's batches
      (kNN boundaries rank in matmul form, so a near-tie may swap a
      point).  Then ``train_loss`` and backward on JAX's batches with
      JAX's re-patch seeds: at ratio 2 (no re-patching) the loss within
      1e-5 of JAX's (relative), every gradient tensor within a relative
      L2 error of 0.1 and all gradients together within the fixture's
      float-noise control; at ratio 16 the loss and all gradients
      together within the float-noise control (JAX against itself with
      the batch scaled by 1 + 1e-6 N(0, 1), the largest change over 64
      noise seeds): kNN re-patching and nearest-neighbour assignments
      flip under rounding, so this band holds the port to JAX's own
      sensitivity.  The tight check at ratio 16: the same step of the
      port on the CPU, fed every decision of the card's step (each
      k-smallest selection, interlevel pick and Chamfer argmin, the
      discrete choices that flip under rounding), must give the card's
      loss within 1e-5 (relative), all gradients together within 5e-3
      and every gradient tensor within 4e-2 (relative L2), and at least
      99.9% of each kind of decision must be the one the CPU would have
      made itself.
   b. Five clipped-Adam steps at ratio 16 with the fixture's re-patch
      seeds: every loss finite, and the select, interlevel and Chamfer
      kernels launched in every step; the losses print beside JAX's.
   c. Warm milliseconds per step at ratio 16: the median of 10 steps
      after 2 warm-up steps, each ending in a device sync.  With
      ``--profile STEPS``, that many more steps run under
      ``torch.profiler``: device time per step by kind of kernel, the
      device's idle share of the unprofiled step, the top kernels.

The last two lines of standard output are one JSON object per kernel
(launches on the checked runs of phases 4b and 5b, error, times, bound)
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from collections import defaultdict
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_ref.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_train_ref.npz")
WEIGHTS = os.path.join(ROOT, "artifacts", "prod_clean_final.npz")
NET = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12, dense_n=3,
           max_num_point=312, fm_knn=5)
SEED = 0
# phase 3 shapes: (B, N) of the conv-site distance matrices (k=33); FPS
# (clouds, points, picks); interlevel (P, sub-patches per top patch, M)
SELECT_CASE = (320, 312)
FPS_CASES = ((8, 24960, 4992), (8, 29952, 10000))
INTERLEVEL_CASES = ((8, 20, 3120), (8, 40, 6240))
#: the train step's interlevel shape: B = P = 16, one sub-patch, M = 312
INTERLEVEL_TRAIN_CASE = (16, 1, 312)
#: interlevel values, weights and gradient against the plain version (max
#: abs): the kernel's exp and sums round apart from PyTorch's
INTERLEVEL_BAND = 1e-5
#: the train loss's nearest-neighbour shape (B, N) x (B, N)
CHAMFER_TRAIN_CASE = (16, 624)
#: H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores,
#: and device memory
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: phase 5 bands (see the module docstring): the share of sampled points
#: that must coincide with JAX's batch, the ratio-2 loss (relative) and
#: per-tensor gradient (relative L2) errors.  The per-tensor band: the
#: port on the CPU reads at most 0.032 (a bias whose gradient sums a few
#: hundred terms that nearest-neighbour flips move), all gradients
#: together 0.0057 (tests/fixtures/make_torch_train_ref.py).
BATCH_BAND = 0.999
R2_LOSS_BAND = 1e-5
R2_TENSOR_BAND = 0.1
#: phase 5a at ratio 16, the card against the port on the CPU with the
#: card's decisions replayed: the loss (relative), all gradients together
#: and each gradient tensor (relative L2), and the share of each site's
#: decisions the CPU would have made alike.  An H100 read 3.8e-7, 5.4e-4,
#: 4.2e-3 (a level-2 conv weight) and 0.99966 (the selections; the
#: interlevel picks and Chamfer argmins all shared): the bands leave
#: about ten times the rounding, and three times the selections' flips
PIN_LOSS_BAND = 1e-5
PIN_GRAD_BAND = 5e-3
PIN_TENSOR_BAND = 4e-2
DECISION_BAND = 0.999
TRAIN_BATCH, TRAIN_POINTS, TRAIN_LR = 16, 312, 5e-4


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chamfer(a, b, chunk: int = 4096) -> float:
    """Mean squared NN distance a->b plus b->a, float64 on a's device."""
    import torch
    a = a.to(torch.float64)
    b = b.to(torch.float64)

    def one_way(x, y):
        y2 = (y * y).sum(-1)
        mins = [torch.clamp((r * r).sum(-1)[:, None] - 2.0 * r @ y.T
                            + y2[None, :], min=0.0).amin(-1)
                for r in x.split(chunk)]
        return torch.cat(mins).mean()

    return float(one_way(a, b) + one_way(b, a))


# ------------------------------------------------------------ phase 3
def select_inputs(dev, g, b=320, n=312):
    import torch
    d = torch.randint(0, 40, (b, n, n), generator=g, device=dev).float()
    pen = torch.randperm(n, generator=g, device=dev)[:64]
    d[..., pen] = 1e30                         # duplicate-penalty columns
    d[0, :, :n - 22] = 1e30                    # rows with < k real columns
    return d


def fps_inputs(dev, g, b, n):
    import torch
    pts = torch.randn((b, n, 3), generator=g, device=dev)
    pts = pts / pts.norm(dim=-1, keepdim=True)
    valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    valid[:, n - n // 10:] = False             # phantom sub-patches
    pts[:, 7::997] = float("nan")              # non-finite points
    return pts, valid


def interlevel_inputs(dev, g, p, group, m, n=312, c=264):
    import torch
    from threepu_torch.ops.distances import duplicate_mask
    prev = torch.randn((p, m, 3), generator=g, device=dev) * 0.3
    prev[:, 1::50] = prev[:, 0::50][:, :prev[:, 1::50].shape[1]]
    pick = torch.randint(0, m, (p, group * n), generator=g, device=dev)
    q = torch.gather(prev, 1, pick[..., None].expand(-1, -1, 3))
    q = q + 0.01 * torch.randn(q.shape, generator=g, device=dev)
    q = q.reshape(p * group, n, 3).contiguous()
    xq = torch.randn((p * group, n, c), generator=g, device=dev)
    feat = torch.randn((p, m, c), generator=g, device=dev)
    dup = duplicate_mask(prev)
    dup[:, m - m // 10:] = True                # phantom previous rows
    return q, xq, prev, feat, dup


def bound(ops: float, nbytes: float) -> dict:
    """The least milliseconds an H100 SXM could take for ``ops`` fp32
    operations moving ``nbytes`` bytes, and which of the two bounds it."""
    t_ops = ops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def interlevel_bound(args, with_w: bool = False) -> dict:
    """The interlevel skip's bound on ``args`` (as
    :func:`interlevel_inputs` returns them), with the weights written as
    a third output when ``with_w``."""
    (p, m, _), (bq, nq, c) = args[2].shape, args[1].shape
    # candidates: distance (8) and a compare; picks: feature distance
    # (3 per channel) and the weighted sum (2 per channel)
    ops = bq * nq * m * 9.0 + bq * nq * 5 * c * 5.0
    nbytes = (4 * (bq * nq * 3 + 2 * bq * nq * c + p * m * 3 + p * m * c
                   + bq * nq * 5 * (2 if with_w else 1)) + p * m)
    return bound(ops, nbytes)


def check_interlevel_train(dev, g, card: str) -> None:
    """The interlevel kernel at the train step's shape (B = P = 16, one
    sub-patch per previous set, N = M = 312, C = 264, k = 5) with the
    weights output the backward reads: its ``(out, idx, w)`` against the
    plain version's, and the ``prev_feat`` gradient of both for one
    cotangent.  Picks exact; values and gradient within
    ``INTERLEVEL_BAND`` (the card's backward sums with atomics)."""
    import torch
    import threepu_torch.ops.interlevel as il_mod
    p, group, m = INTERLEVEL_TRAIN_CASE
    args = interlevel_inputs(dev, g, p, group, m)
    got = il_mod._launch(*args, 5, with_w=True)
    want = il_mod._plain(*args, 5)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        first = (got[1] != want[1]).nonzero()[0].tolist()
        raise AssertionError(f"interlevel train shape: picks differ first at "
                             f"{first}")
    errs = {"out": float((got[0] - want[0]).abs().max()),
            "w": float((got[2] - want[2]).abs().max())}
    cot = torch.randn(got[0].shape, generator=g, device=dev)
    grads = []
    for fn in (il_mod.interlevel, il_mod.interlevel_plain):
        feat = args[3].clone().requires_grad_()
        out, _ = fn(args[0], args[1], args[2], feat, args[4], 5)
        out.backward(cot)
        grads.append(feat.grad)
    errs["grad"] = float((grads[0] - grads[1]).abs().max())
    print(f"interlevel train shape B=P={p} M={m} C=264 k=5: picks exact, max "
          f"abs err out {errs['out']:.3e}, w {errs['w']:.3e}, prev_feat "
          f"gradient {errs['grad']:.3e} [{card}]", flush=True)
    for name, err in errs.items():
        if not err <= INTERLEVEL_BAND:
            raise AssertionError(f"interlevel train shape: {name} max abs "
                                 f"error {err} > {INTERLEVEL_BAND}")
    ms = cuda_ms(lambda: il_mod._launch(*args, 5, with_w=True), 20)
    plain_ms = cuda_ms(lambda: il_mod._plain(*args, 5), 5)
    b = interlevel_bound(args, with_w=True)
    print(f"interlevel train shape with w: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) [{card}]", flush=True)


def chamfer_inputs(dev, g, b, n):
    """Two clouds with duplicate points and exact zero distances."""
    import torch
    a = torch.randn((b, n, 3), generator=g, device=dev)
    r = torch.randn((b, n, 3), generator=g, device=dev)
    r[:, 1::7] = r[:, 0::7][:, :r[:, 1::7].shape[1]]
    a[:, :n // 10] = r[:, n // 2:n // 2 + n // 10]
    return a, r


def check_chamfer(a, b, card: str, reps: int) -> dict:
    """The nearest-neighbour kernel against its plain version on ``a``
    and ``b``; exact, or raises.  Returns its error, times and bound."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    got = ch_mod.nn_one_way(a, b)
    want = ch_mod.nn_one_way_plain(a, b)
    torch.cuda.synchronize()
    shape = f"{tuple(a.shape)} x {tuple(b.shape)}"
    if not torch.equal(got[1], want[1]):
        first = (got[1] != want[1]).nonzero()[0].tolist()
        raise AssertionError(f"chamfer {shape}: indices differ first at "
                             f"{first}")
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"chamfer {shape}: distances differ")
    del got, want
    ms = cuda_ms(lambda: ch_mod.nn_one_way(a, b), reps)
    plain_ms = cuda_ms(lambda: ch_mod.nn_one_way_plain(a, b), 1)
    library_ms = cuda_ms(lambda: torch.cdist(
        a, b, compute_mode="donot_use_mm_for_euclid_dist").min(-1), 1)
    torch.cuda.empty_cache()
    bsz, n, _ = a.shape
    m = b.shape[1]
    rep = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(8.0 * bsz * n * m, bsz * (n + m) * 12 + bsz * n * 8))
    print(f"chamfer {shape}: exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.cdist+min {library_ms:.4f} ms, bound "
          f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}) [{card}]",
          flush=True)
    return rep


def check_kernels(dev, card: str, fx) -> dict:
    """Phase 3: each kernel against its plain version; returns, per
    kernel, the error, times and bound at its headline shape."""
    import torch
    import threepu_torch.ops.fps as fps_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.select as sel_mod

    g = torch.Generator(device=dev).manual_seed(SEED)
    report = {}

    d = select_inputs(dev, g, *SELECT_CASE)
    v, i = sel_mod.select(d, 33)
    pv, pi = sel_mod.select_plain(d, 33)
    torch.cuda.synchronize()
    if not (torch.equal(v, pv) and torch.equal(i, pi)):
        raise AssertionError("select: kernel and plain version differ")
    ms = cuda_ms(lambda: sel_mod.select(d, 33), 20)
    plain_ms = cuda_ms(lambda: sel_mod.select_plain(d, 33), 5)
    # torch.topk computes the same k smallest, but with no promise on the
    # order among ties: a yardstick only
    library_ms = cuda_ms(lambda: torch.topk(d, 33, dim=-1, largest=False), 5)
    rows, n = d.numel() // d.shape[-1], d.shape[-1]
    report["select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms,
                            **bound(rows * n, rows * n * 4 + rows * 33 * 8))
    print(f"select {tuple(d.shape)} k=33: exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
          f"{report['select']['bound_ms']:.4f} ms "
          f"({report['select']['bound_by']}) [{card}]", flush=True)

    for b, n, m in FPS_CASES:
        pts, valid = fps_inputs(dev, g, b, n)
        got = fps_mod.fps(pts, m, valid)
        want = fps_mod.fps_plain(pts, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            first = (got != want).nonzero()[0].tolist()
            raise AssertionError(f"fps ({b}, {n}) -> {m}: kernel and plain "
                                 f"version differ first at {first}")
        ms = cuda_ms(lambda: fps_mod.fps(pts, m, valid), 3)
        plain_ms = cuda_ms(lambda: fps_mod.fps_plain(pts, m, valid), 1)
        # each pick updates every point: distance (8), min, argmax compare
        report["fps"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                             library_ms=None,
                             **bound(10.0 * b * m * n,
                                     b * n * 13 + b * m * 4))
        print(f"fps ({b}, {n}) -> {m}: exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {report['fps']['bound_ms']:.4f} ms "
              f"({report['fps']['bound_by']}) [{card}]", flush=True)

    for p, group, m in INTERLEVEL_CASES:
        args = interlevel_inputs(dev, g, p, group, m)
        out, idx = il_mod.interlevel(*args, 5)
        pout, pidx = il_mod.interlevel_plain(*args, 5)
        torch.cuda.synchronize()
        if not torch.equal(idx, pidx):
            first = (idx != pidx).nonzero()[0].tolist()
            raise AssertionError(f"interlevel group {group}, M {m}: picks "
                                 f"differ first at {first}")
        err = float((out - pout).abs().max())
        if not err <= INTERLEVEL_BAND:
            raise AssertionError(f"interlevel group {group}, M {m}: max abs "
                                 f"error {err} > {INTERLEVEL_BAND}")
        ms = cuda_ms(lambda: il_mod.interlevel(*args, 5), 10)
        plain_ms = cuda_ms(lambda: il_mod.interlevel_plain(*args, 5), 2)
        report["interlevel"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=None,
                                    **interlevel_bound(args))
        print(f"interlevel P={p} group={group} M={m} C=264 k=5: picks exact, "
              f"max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound "
              f"{report['interlevel']['bound_ms']:.4f} ms "
              f"({report['interlevel']['bound_by']}) [{card}]", flush=True)
    check_interlevel_train(dev, g, card)

    big = [torch.from_numpy(fx[k][None]).to(dev) for k in ("jax_out", "gt")]
    check_chamfer(*big, card, 10)
    del big
    report["chamfer"] = check_chamfer(
        *chamfer_inputs(dev, g, *CHAMFER_TRAIN_CASE), card, 50)
    return report


# ------------------------------------------------------------ phase 4
def replay_cascade(net, fx, dev) -> list:
    """Phase 4a: ``net``'s eval cascade on the fixture's patch, each
    step fed JAX's input for it (``cascade_*`` of the fixture), as
    ``Net.upsample`` runs the steps.  Returns, per level, the share of
    output rows within 1e-4 of JAX's, the largest row error, and for the
    sub-patching levels the share of JAX's sub-patch points that the
    port's sub-patches hold and both real sub-patch counts."""
    import torch
    from threepu_torch.ops.distances import duplicate_mask
    from threepu_torch.ops.normalize import normalize_point_batch_cl

    def jax_(key):
        return torch.from_numpy(fx[key]).to(dev)

    def rows(got, key):
        err = (got - jax_(key)).abs().amax(-1).reshape(-1)
        return dict(rows_1e4=float((err <= 1e-4).double().mean()),
                    max_abs_err=float(err.max()))

    stats = []
    with torch.no_grad():
        xyz = jax_("cascade_in")
        out, feats = net.levels["level_1"](xyz, xyz)
        stats.append(dict(level=1, **rows(out, "cascade_out_1")))
        old_xyz, old_feats, prev_invalid = xyz, feats, None
        for l in range(2, len(net.levels) + 1):
            flat = jax_(f"cascade_sub_{l}")
            true_sub = jax_(f"cascade_true_sub_{l}").long()
            n_sub, k, _ = flat.shape
            sub, port_true_sub = net._extract_patch_eval(
                jax_(f"cascade_xyz_{l}"), k, n_sub)
            same = (flat[:, :, None, :] == sub.reshape(flat.shape)[:, None]
                    ).all(-1).any(-1)
            norm, _, _ = normalize_point_batch_cl(flat)
            prev_dup = duplicate_mask(old_xyz)
            if prev_invalid is not None:
                prev_dup = prev_dup | prev_invalid
            out, feats = net.levels[f"level_{l}"](
                flat, norm, (old_xyz, old_feats), prev_group=n_sub,
                prev_dup=prev_dup)
            stats.append(dict(level=l, **rows(out, f"cascade_out_{l}"),
                              sub_points=float(same.double().mean()),
                              true_sub=int(port_true_sub[0]),
                              jax_true_sub=int(true_sub[0])))
            old_xyz = flat.reshape(1, n_sub * k, 3)
            old_feats = feats.reshape(1, n_sub * k, -1)
            valid = torch.arange(n_sub, device=dev) < true_sub[:, None]
            prev_invalid = ~valid[:, :, None].expand(1, n_sub, k).reshape(
                1, -1)
    return stats


def check_replay(stats: list) -> None:
    """Phase 4a's bands; raises on the first level outside them."""
    for st in stats:
        l = st["level"]
        if not st["rows_1e4"] >= 0.99:
            raise AssertionError(f"cascade replay level {l}: only "
                                 f"{st['rows_1e4']:.5f} of the rows lie "
                                 "within 1e-4 of JAX's")
        if l > 1 and not (st["sub_points"] >= 0.99
                          and st["true_sub"] == st["jax_true_sub"]):
            raise AssertionError(f"cascade replay level {l}: sub-patches "
                                 f"differ from JAX's: {st}")


def end_to_end(net, fx, card: str, kernels: dict) -> dict:
    """Phase 4b: the 16x pipeline on held-out shape 0; returns the
    launch count of each kernel in the checked run."""
    import torch
    from threepu_torch.inference import upsample_shape

    dev = next(net.parameters()).device
    ratio, num_point, chunk = (int(fx["ratio"]), int(fx["num_point"]),
                               int(fx["chunk"]))

    def run():
        out = upsample_shape(net, fx["input"], ratio, num_point=num_point,
                             chunk=chunk)[1]
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()                                            # first run: warm-up
    first_s = time.perf_counter() - t0
    for k in kernels.values():
        k.launches = 0
    out = run()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"main-path launches: {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the pipeline never launched {name}")
    n_out = fx["input"].shape[0] * ratio
    if out.shape != (n_out, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad output: shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)

    o = torch.from_numpy(out).to(dev)
    cd_gt = chamfer(o, torch.from_numpy(fx["gt"]).to(dev))
    cd_jax = chamfer(o, torch.from_numpy(fx["jax_out"]).to(dev))
    jax_cd_gt = float(fx["jax_cd_gt"])
    control = float(np.max(fx["jax_pert_cd"]))
    print(f"16x {fx['input'].shape[0]} -> {n_out}: chamfer to gt {cd_gt:.6e} "
          f"(JAX {jax_cd_gt:.6e}, ratio {cd_gt / jax_cd_gt:.4f}); chamfer "
          f"to JAX output {cd_jax:.6e} ({cd_jax / jax_cd_gt:.4f} of JAX's "
          f"distance to gt; JAX against itself under 1e-6 input noise: "
          f"{control:.6e}, {control / jax_cd_gt:.4f})", flush=True)
    print(f"16x {fx['input'].shape[0]} -> {n_out}: first run {first_s:.3f} s, "
          f"warm s/shape {best:.4f} (runs {[round(t, 4) for t in times]}), "
          f"{n_out / best:.1f} points/s [{card}]", flush=True)
    if abs(cd_gt - jax_cd_gt) > 0.05 * jax_cd_gt:
        raise AssertionError("chamfer to gt is not within 5% of JAX's")
    # float rounding flips near-ties of the re-stitch FPS, so outputs that
    # differ only by rounding are different samples of one surface: the
    # port must lie no farther from JAX than JAX lies from itself
    if cd_jax > control:
        raise AssertionError("chamfer to the JAX output exceeds the JAX "
                             "float-noise control")
    return launches


# ------------------------------------------------------------ phase 5
def normalize_by_input(inp, *labels):
    """Every resolution of one shape by the input's centroid and furthest
    distance (arrays ``(1, N, 3)``), as the JAX package's ``load_h5_data``
    normalizes training data."""
    centroid = np.mean(inp, axis=1, keepdims=True)
    data = inp - centroid
    furthest = np.amax(np.sqrt(np.sum(data ** 2, axis=-1)), axis=1,
                       keepdims=True)[..., None]
    return (data / furthest,
            *[(lab - centroid) / furthest for lab in labels])


def coincide(got, want) -> float:
    """Share of the points of ``got (B, N, 3)`` that lie within 1e-5 of a
    point of the same batch element of ``want``."""
    from threepu_torch.ops.chamfer import nn_one_way
    d, _ = nn_one_way(got.contiguous(), want.contiguous())
    return float((d <= 1e-10).double().mean())


def check_batches(fx, tfx, dev, card: str) -> None:
    """Phase 5a, first half: ``sample_batch`` on the card with the
    fixture's draws against the JAX package's batches."""
    import torch
    from threepu_torch.data import sample_batch
    shape, lab2, lab16 = normalize_by_input(
        fx["input"][None], tfx["label_2"][None], fx["gt"][None])
    for ratio, label in ((2, lab2), (16, lab16)):
        x, gt = sample_batch(
            torch.from_numpy(shape[0]).to(dev),
            torch.from_numpy(label[0]).to(dev), ratio, TRAIN_BATCH,
            TRAIN_POINTS,
            seed_idx=torch.from_numpy(tfx[f"sample_seed_{ratio}"]).to(dev),
            angles=torch.from_numpy(tfx[f"angles_{ratio}"]).to(dev))
        shares = [coincide(got, torch.from_numpy(tfx[f"{k}_{ratio}"]).to(dev))
                  for got, k in ((x, "input"), (gt, "gt"))]
        print(f"train batch ratio {ratio}: {tuple(x.shape)} / "
              f"{tuple(gt.shape)}, points coinciding with JAX's batch: "
              f"input {shares[0]:.6f}, gt {shares[1]:.6f} [{card}]",
              flush=True)
        if not min(shares) >= BATCH_BAND:
            raise AssertionError(f"ratio {ratio}: sampled batch differs from "
                                 "JAX's")


def step_grads(net, x, gt, ratio: int, seed_idx) -> tuple:
    """``train_loss`` and backward of ``net`` on one batch: the unweighted
    loss and every parameter's gradient (zeros where none reached it)."""
    import torch
    from threepu_torch.train import train_loss
    net.zero_grad(set_to_none=True)
    weighted, cd, _, _ = train_loss(net, x, gt, ratio, seed_idx=seed_idx)
    weighted.backward()
    return float(cd.detach()), {
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in net.named_parameters()}


def compare_grads(loss: float, grads: dict, ref_loss: float,
                  ref_grads: dict) -> dict:
    """The loss's relative error against ``ref_loss``, each gradient
    tensor's relative L2 error against ``ref_grads`` (same names), and all
    gradients together's.  Raises where a reference gradient is zero and
    the other is not."""
    per, num, den = {}, 0.0, 0.0
    for name, g in grads.items():
        w = ref_grads[name].to(g.device)
        e2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        num, den = num + e2, den + w2
        if w2 > 0:
            per[name] = (e2 / w2) ** 0.5
        elif e2 > 0:
            raise AssertionError(f"{name} has a gradient where the "
                                 "reference's is zero")
    worst = max(per, key=per.get)
    return dict(loss=loss, ref_loss=ref_loss,
                loss_err=abs(loss - ref_loss) / ref_loss,
                grad_err=(num / den) ** 0.5, worst=worst,
                worst_err=per[worst])


def grad_errors(net, tfx, ratio: int, dev) -> dict:
    """``train_loss`` and backward on the fixture's ratio-``ratio`` batch
    with JAX's re-patch seeds, against JAX's loss and gradients
    (:func:`compare_grads`).  The gradients stay in ``net``."""
    import torch
    from threepu_torch.io.weights import state_dict_from_jax

    def arr(key):
        return torch.from_numpy(tfx[key]).to(dev)

    loss, grads = step_grads(net, arr(f"input_{ratio}"), arr(f"gt_{ratio}"),
                             ratio, list(arr(f"repatch_{ratio}")))
    prefix = f"grad_{ratio}/"
    want = state_dict_from_jax({k[len(prefix):]: tfx[k] for k in tfx.files
                                if k.startswith(prefix)})
    return compare_grads(loss, grads, float(tfx[f"loss_{ratio}"]), want)


def decision_sites() -> dict:
    """Where a train step makes its discrete choices, as ``{name: (module,
    function)}``: every k-smallest selection (the edge convs' kNN, the
    re-patch and gt-patch picks), the interlevel picks and the Chamfer
    argmins.  Each function returns ``(values, int32 indices)``."""
    import threepu_torch.models.upsampler as up_mod
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.knn as knn_mod
    return {"select": (knn_mod, "exact_select"),
            "interlevel": (up_mod, "interlevel"),
            "chamfer": (ch_mod, "nn_one_way")}


@contextlib.contextmanager
def recorded_decisions():
    """Yields ``{site: [indices, ...]}``, filled in call order with the
    indices every :func:`decision_sites` function returns inside."""
    rec = {name: [] for name in decision_sites()}
    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in decision_sites().items():
            def record(*args, _orig=getattr(mod, attr), _name=name):
                out = _orig(*args)
                rec[_name].append(out[1].detach())
                return out
            stack.enter_context(mock.patch.object(mod, attr, record))
        yield rec


@contextlib.contextmanager
def replayed_decisions(rec: dict):
    """Inside, the train cascade takes the decisions ``rec`` recorded
    (:func:`recorded_decisions`) in call order, on its own device, and
    computes its values from them as the plain versions do: a gather of
    the selected distances, the interlevel skip from the given picks, the
    Chamfer distances to the given points.  So only rounding parts the
    run from the recorded one.  Yields ``{site: [equal, total]}``: how
    many of the replayed indices equal those the run would have chosen
    itself."""
    import torch
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.knn as knn_mod
    from threepu_torch.ops.distances import sq_dist3
    from threepu_torch.ops.gather import batched_gather

    its = {name: iter(v) for name, v in rec.items()}
    agree = {name: [0, 0] for name in rec}

    def take(name, own):
        idx = next(its[name], None)
        if idx is None or idx.numel() != own.numel():
            raise ValueError(f"the replayed {name} decisions do not fit "
                             "this step")
        idx = idx.to(own.device).reshape(own.shape).to(own.dtype)
        agree[name][0] += int((idx == own).sum())
        agree[name][1] += own.numel()
        return idx

    select, nn_one_way, picks = (knn_mod.exact_select, ch_mod.nn_one_way,
                                 il_mod._plain_picks)

    def replay_select(d, k):
        idx = take("select", select(d, k)[1])
        return torch.gather(d, -1, idx.long()), idx

    def replay_nn(a, b):
        idx = take("chamfer", nn_one_way(a, b)[1])
        return sq_dist3(a, batched_gather(b, idx)), idx

    def replay_picks(q_xyz, prev_xyz, prev_dup, k):
        return take("interlevel", picks(q_xyz, prev_xyz, prev_dup, k))

    with mock.patch.object(knn_mod, "exact_select", replay_select), \
            mock.patch.object(ch_mod, "nn_one_way", replay_nn), \
            mock.patch.object(il_mod, "_plain_picks", replay_picks):
        yield agree
    left = [name for name, it in its.items() if next(it, None) is not None]
    if left:
        raise ValueError(f"the step made fewer {left} decisions than were "
                         "recorded")


def pinned_errors(net, tfx, ratio: int, loss: float, rec: dict) -> dict:
    """The loss and gradients ``net`` holds from its ratio-``ratio`` step
    on the fixture's batch (:func:`grad_errors`) against the same step of
    the port on the CPU, on the same weights, fed that step's decisions
    ``rec`` (:func:`compare_grads`; ``agree``: per site, the share of the
    decisions the CPU would have made itself that equal the card's)."""
    import torch
    from threepu_torch.models import load_net
    cpu = load_net(device="cpu", **NET)
    cpu.load_state_dict(net.state_dict())
    grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
             for name, p in net.named_parameters()}
    with replayed_decisions(rec) as agree:
        ref_loss, ref_grads = step_grads(
            cpu, torch.from_numpy(tfx[f"input_{ratio}"]),
            torch.from_numpy(tfx[f"gt_{ratio}"]), ratio,
            list(torch.from_numpy(tfx[f"repatch_{ratio}"])))
    return dict(compare_grads(loss, grads, ref_loss, ref_grads),
                agree={k: eq / max(1, n) for k, (eq, n) in agree.items()})


def check_pinned(st: dict) -> None:
    """Phase 5a's bands for the card against the CPU with the card's
    decisions replayed; raises on the first reading outside them."""
    for key, band in (("loss_err", PIN_LOSS_BAND), ("grad_err", PIN_GRAD_BAND),
                      ("worst_err", PIN_TENSOR_BAND)):
        if not st[key] <= band:
            raise AssertionError(f"ratio 16, decisions pinned: {key} "
                                 f"{st[key]:.3e} outside {band:.1e} "
                                 f"(worst tensor {st['worst']})")
    for site, share in st["agree"].items():
        if not share >= DECISION_BAND:
            raise AssertionError(f"ratio 16: only {share:.5f} of the {site} "
                                 "decisions of the card are the CPU's")


#: kinds of device work for the profile, first match wins (lower-cased
#: kernel names)
KINDS = (("select kernel", ("select_kernel",)),
         ("interlevel kernel", ("interlevel_kernel",)),
         ("chamfer kernel", ("nn_kernel",)),
         ("cuBLAS GEMM", ("gemm", "xmma", "cutlass")),
         ("sorts", ("sort",)),
         ("memcpy, memset", ("memcpy", "memset")),
         ("gathers, scatters, index_add", ("gather", "scatter", "index")),
         ("reductions", ("reduce",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other elementwise"


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_steps(step, steps: int, step_ms: float, card: str) -> None:
    """``steps`` calls of ``step`` under ``torch.profiler``: device time
    per step by kind of kernel, the device-busy time (the union of all
    device intervals), its idle share against ``step_ms`` (the unprofiled
    step) and the ten kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_kind = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(float)
    intervals = []
    for ev in prof.events():
        # a user annotation (such as Adam.step's) spans kernels it holds
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        by_kind[kind_of(ev.name)][0] += 1
        by_kind[kind_of(ev.name)][1] += e - s
        by_name[ev.name] += e - s
    if not intervals:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = union_us(intervals) / 1e3 / steps
    print(f"profile, {steps} train steps: device busy {busy_ms:.3f} ms/step, "
          f"idle share {1 - busy_ms / step_ms:.4f} of the unprofiled "
          f"{step_ms:.3f} ms/step [{card}]", flush=True)
    print("| Device time per step | ops | ms | share of busy |")
    print("| --- | --- | --- | --- |")
    for kind, (n, us) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / steps
        print(f"| {kind} | {n / steps:.0f} | {ms:.3f} | {ms / busy_ms:.1%} |")
    print("top kernels (ms/step):")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / steps:9.3f}  {kname[:110]}", flush=True)


def train_checks(fx, tfx, card: str, kernels: dict,
                 profile: int = 0) -> dict:
    """Phase 5: returns the launch count of each kernel in the five
    checked Adam steps.  With ``profile`` > 0, that many more steps run
    under ``torch.profiler`` after the timed ones."""
    import torch
    from threepu_torch.models import load_net
    from threepu_torch.train import make_optimizer, train_step

    net = load_net(WEIGHTS, **NET)          # the card is the default device
    dev = next(net.parameters()).device
    check_batches(fx, tfx, dev, card)

    for ratio in (2, 16):
        with recorded_decisions() as rec:
            st = grad_errors(net, tfx, ratio, dev)
        ctl_loss = float(np.max(tfx[f"control_loss_{ratio}"]))
        ctl_grad = float(np.max(tfx[f"control_grad_{ratio}"]))
        print(f"train ratio {ratio}: loss {st['loss']:.9e} (JAX "
              f"{st['ref_loss']:.9e}, rel err {st['loss_err']:.3e}; control "
              f"{ctl_loss:.3e}); gradients rel L2 {st['grad_err']:.3e} "
              f"(control {ctl_grad:.3e}), worst tensor {st['worst_err']:.3e} "
              f"({st['worst']}) [{card}]", flush=True)
        loss_band = R2_LOSS_BAND if ratio == 2 else ctl_loss
        if not st["loss_err"] <= loss_band:
            raise AssertionError(f"ratio {ratio}: loss outside its band "
                                 f"{loss_band:.3e}")
        if not st["grad_err"] <= ctl_grad:
            raise AssertionError(f"ratio {ratio}: gradients outside the "
                                 "float-noise control")
        if ratio == 2 and not st["worst_err"] <= R2_TENSOR_BAND:
            raise AssertionError(f"ratio 2: {st['worst']} outside "
                                 f"{R2_TENSOR_BAND}")
        if ratio == 16:
            t0 = time.perf_counter()
            pin = pinned_errors(net, tfx, ratio, st["loss"], rec)
            print(f"train ratio 16 against the port on the CPU, decisions "
                  f"pinned: loss rel err {pin['loss_err']:.3e}, gradients "
                  f"rel L2 {pin['grad_err']:.3e}, worst tensor "
                  f"{pin['worst_err']:.3e} ({pin['worst']}); decisions the "
                  f"CPU shares {pin['agree']}; CPU step "
                  f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
            check_pinned(pin)

    opt = make_optimizer(net.parameters(), TRAIN_LR)
    x = torch.from_numpy(tfx["input_16"]).to(dev)
    gt = torch.from_numpy(tfx["gt_16"]).to(dev)
    train_kernels = {k: kernels[k] for k in ("select", "interlevel",
                                             "chamfer")}
    for k in kernels.values():
        k.launches = 0
    losses = []
    for seeds in tfx["adam_repatch"]:
        before = {name: k.launches for name, k in train_kernels.items()}
        losses.append(float(train_step(
            net, opt, x, gt, 16,
            seed_idx=list(torch.from_numpy(seeds).to(dev)))))
        for name, k in train_kernels.items():
            if k.launches <= before[name]:
                raise AssertionError(f"a train step never launched {name}")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"train-path launches (5 steps): {launches}", flush=True)
    jax_losses = [float(v) for v in tfx["adam_loss"]]
    print(f"adam ratio 16, 5 steps: losses {losses}; JAX {jax_losses}; rel "
          f"diff {[round(abs(a - b) / b, 6) for a, b in zip(losses, jax_losses)]}"
          f" [{card}]", flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        train_step(net, opt, x, gt, 16, generator=gen)

    times = []
    for i in range(12):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    print(f"train step ratio 16, batch {TRAIN_BATCH} x {TRAIN_POINTS}: warm "
          f"{step_ms:.3f} ms/step (median of 10; "
          f"{[round(t, 3) for t in times]}) [{card}]", flush=True)
    if profile:
        profile_steps(step, profile, step_ms, card)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="also profile this many warm train steps (phase 5c)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from threepu_torch import _build, require_cuda
    from threepu_torch.device import card_line
    import threepu_torch.ops.chamfer as ch_mod
    import threepu_torch.ops.fps as fps_mod
    import threepu_torch.ops.interlevel as il_mod
    import threepu_torch.ops.select as sel_mod

    # 1. device
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    dev = require_cuda()

    # 2. build
    t0 = time.perf_counter()
    _build.build(ptxas_verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    kernels = {"select": sel_mod.KERNEL, "fps": fps_mod.KERNEL,
               "interlevel": il_mod.KERNEL, "chamfer": ch_mod.KERNEL}
    fx = np.load(FIXTURE)
    report = check_kernels(dev, card, fx)

    # 4. end to end
    from threepu_torch.models import load_net
    net = load_net(WEIGHTS, **NET).eval()
    stats = replay_cascade(net, fx, dev)
    for st in stats:
        print(f"cascade replay {st} [{card}]", flush=True)
    check_replay(stats)
    eval_launches = end_to_end(net, fx, card, {
        k: kernels[k] for k in ("select", "fps", "interlevel")})

    # 5. training
    train_launches = train_checks(fx, np.load(TRAIN_FIXTURE), card, kernels,
                                  args.profile)

    by_path = {name: {"eval": eval_launches.get(name, 0),
                      "train": train_launches[name]} for name in kernels}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k.source, replaces=k.replaces,
             launches=sum(by_path[name].values()),
             launches_by_path=by_path[name], **report[name])
        for name, k in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
