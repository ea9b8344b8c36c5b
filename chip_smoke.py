#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``threepu_torch``) on one GPU.

    python3 chip_smoke.py

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
   must pick the same indices and agree to 1e-5.  Both times are printed.
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

The last two lines of standard output are one JSON object per kernel
(launches, error, times) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_ref.npz")
WEIGHTS = os.path.join(ROOT, "artifacts", "prod_clean_final.npz")
NET = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12, dense_n=3,
           max_num_point=312, fm_knn=5)
SEED = 0
# phase 3 shapes: (B, N) of the conv-site distance matrices (k=33); FPS
# (clouds, points, picks); interlevel (P, sub-patches per top patch, M)
SELECT_CASE = (320, 312)
FPS_CASES = ((8, 24960, 4992), (8, 29952, 10000))
INTERLEVEL_CASES = ((8, 20, 3120), (8, 40, 6240))


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0]


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


def check_kernels(dev, card: str) -> dict:
    """Phase 3: each kernel against its plain version; returns, per
    kernel, the error and times at its headline shape."""
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
    print(f"select {tuple(d.shape)} k=33: exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms [{card}]", flush=True)
    report["select"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)

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
        print(f"fps ({b}, {n}) -> {m}: exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms [{card}]", flush=True)
        report["fps"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)

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
        if not err <= 1e-5:
            raise AssertionError(f"interlevel group {group}, M {m}: max abs "
                                 f"error {err} > 1e-5")
        ms = cuda_ms(lambda: il_mod.interlevel(*args, 5), 10)
        plain_ms = cuda_ms(lambda: il_mod.interlevel_plain(*args, 5), 2)
        print(f"interlevel P={p} group={group} M={m} C=264 k=5: picks exact, "
              f"max abs err {err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms [{card}]", flush=True)
        report["interlevel"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from threepu_torch import _build, require_cuda
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
               "interlevel": il_mod.KERNEL}
    report = check_kernels(dev, card)

    # 4. end to end
    from threepu_torch.io.weights import load_jax_checkpoint
    from threepu_torch.models import Net
    fx = np.load(FIXTURE)
    net = Net(**NET).to(dev).eval()
    net.load_state_dict(load_jax_checkpoint(WEIGHTS), strict=True)
    stats = replay_cascade(net, fx, dev)
    for st in stats:
        print(f"cascade replay {st} [{card}]", flush=True)
    check_replay(stats)
    launches = end_to_end(net, fx, card, kernels)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k.source, replaces=k.replaces,
             launches=launches[name], **report[name])
        for name, k in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
