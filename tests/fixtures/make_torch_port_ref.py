"""Make ``tests/fixtures/torch_port_ref.npz``: the JAX package's 16x
output on a held-out shape, for the PyTorch port's end-to-end check.

The port runs where neither JAX nor h5py is installed, so this script
freezes what that check needs into one small archive:

- ``input``: ``poisson_5000[0]`` of ``artifacts/held.hdf5``;
- ``gt``: ``poisson_80000[0]``, the ground-truth dense shape;
- ``jax_out``: :func:`threepu.inference.upsample_shape` of ``input`` at
  16x with ``artifacts/prod_clean_final.npz`` (312-point patches,
  chunk 8, the default G=8 hierarchical re-stitch);
- ``jax_cd_gt``: the Chamfer distance (mean squared NN distance both
  ways, :func:`threepu.losses.chamfer_loss`) of ``jax_out`` to ``gt``;
- ``jax_pert_cd``: the float-noise control — for two seeds, the
  Chamfer distance between ``jax_out`` and the JAX output for ``input``
  times ``1 + 1e-6 * N(0, 1)`` (per coordinate).  Near-ties of the
  re-stitch FPS flip under noise of that size, so two runs that differ
  only in float rounding produce different, equally good samples of the
  same surface; this is how far apart such samples lie;
- ``jax_seconds``: the wall time of the first JAX run on the machine
  that made the file (CPU, compile included);
- ``cascade_*``: JAX's eval cascade (``Net.upsample`` at 16x) on the
  first 312-point patch of that run's pipeline, normalized, step by
  step: ``cascade_in (1, 312, 3)``, ``cascade_out_1 (1, 624, 3)``, and
  for each sub-patching level ``l`` = 2, 3, 4 its input
  ``cascade_xyz_{l}``, its sub-patches ``cascade_sub_{l}``, their real
  count ``cascade_true_sub_{l}`` and the Level's output
  ``cascade_out_{l}`` (normalized frame).  A replay that feeds each
  step JAX's inputs compares the port with JAX where no FPS near-tie can
  flip between the two.

JAX runs on the CPU with float32 matmuls at full precision, which is
what the port computes.  Run from the repository root:

    python tests/fixtures/make_torch_port_ref.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import h5py
import jax
import numpy as np
from scipy.spatial import cKDTree

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_ref.npz")
RATIO = 16
NUM_POINT = 312
CHUNK = 8


def cascade_trace(net, params, patch):
    """``Net.upsample`` of one normalized patch ``(1, N, 3)`` at
    ``RATIO``, step by step as its eval loop runs them; returns the
    ``cascade_*`` arrays, and the cascade's output under ``"last"``."""
    import jax.numpy as jnp

    from threepu.ops import duplicate_mask, gather_nd
    from threepu.ops.fps import _dispatch_fps
    from threepu.ops.normalize import normalize_point_batch_cl

    v = {"params": params}

    def level(l, *args, **kw):
        return jax.jit(lambda v, *a: net.apply(
            v, *a, method=lambda m, *x: m.levels[l - 1](*x, **kw)))(v, *args)

    step = net.step_ratio
    xyz, feats = level(1, patch, patch, None)
    rec = {"cascade_in": patch, "cascade_out_1": xyz}
    old_xyz, old_feats, prev_invalid = patch, feats, None
    for l in range(2, int(np.log2(RATIO)) + 1):
        n_sub = int(xyz.shape[1] / NUM_POINT * 5)
        sub, true_sub = jax.jit(lambda v, x: net.apply(
            v, x, NUM_POINT, n_sub, method="_extract_patch_eval"))(v, xyz)
        flat = sub.reshape(n_sub, NUM_POINT, 3)
        norm, centroid, radius = normalize_point_batch_cl(flat)
        prev_dup = duplicate_mask(old_xyz)
        if prev_invalid is not None:
            prev_dup = prev_dup | prev_invalid
        new_xyz, feats = level(l, flat, norm, (old_xyz, old_feats),
                               prev_group=n_sub, prev_dup=prev_dup)
        rec.update({f"cascade_xyz_{l}": xyz, f"cascade_sub_{l}": flat,
                    f"cascade_true_sub_{l}": true_sub,
                    f"cascade_out_{l}": new_xyz})
        valid = jnp.broadcast_to(
            (jnp.arange(n_sub)[None, :] < true_sub[:, None])[:, :, None],
            (1, n_sub, NUM_POINT))
        merged = (new_xyz * radius + centroid).reshape(1, -1, 3)
        merge_valid = jnp.repeat(valid, step, axis=2).reshape(1, -1)
        xyz = gather_nd(merged, _dispatch_fps(
            merged, NUM_POINT * step ** l, merge_valid, None))
        old_xyz = flat.reshape(1, n_sub * NUM_POINT, 3)
        old_feats = feats.reshape(1, n_sub * NUM_POINT, -1)
        prev_invalid = ~valid.reshape(1, -1)
    rec = {k: np.asarray(a) for k, a in rec.items()}
    rec["last"] = xyz
    return rec


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from threepu.inference import upsample_shape
    from threepu.io import load_checkpoint
    from threepu.losses import chamfer_loss
    from threepu.models import Net
    from threepu.ops import gather_nd, knn_group
    from threepu.ops.fps import _dispatch_fps
    from threepu.ops.normalize import normalize_point_batch_cl
    from threepu.utils import pc_utils

    with h5py.File(os.path.join(ROOT, "artifacts", "held.hdf5"), "r") as f:
        inp = f["poisson_5000"][0].astype(np.float32)
        gt = f["poisson_80000"][0].astype(np.float32)

    net = Net(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12,
              dense_n=3, max_num_point=NUM_POINT, fm_knn=5)
    params = load_checkpoint(os.path.join(
        ROOT, "artifacts", "prod_clean_final.npz"))[0]["params"]

    t0 = time.time()
    _, out = upsample_shape(net, params, inp, RATIO, num_point=NUM_POINT,
                            chunk=CHUNK)
    seconds = time.time() - t0
    out = np.asarray(out, np.float32)

    def chamfer(a, b):
        return float(chamfer_loss(jnp.asarray(a)[None], jnp.asarray(b)[None]))

    cd = chamfer(out, gt)
    print(f"jax 16x {inp.shape[0]} -> {out.shape[0]}: chamfer to gt "
          f"{cd:.6e}, {seconds:.1f} s", flush=True)
    pert_cd = []
    for seed in (1, 2):
        noise = np.random.default_rng(seed).standard_normal(inp.shape)
        pert = (inp * (1.0 + 1e-6 * noise)).astype(np.float32)
        _, out_p = upsample_shape(net, params, pert, RATIO,
                                  num_point=NUM_POINT, chunk=CHUNK)
        pert_cd.append(chamfer(np.asarray(out_p, np.float32), out))
        print(f"control seed {seed}: chamfer to jax_out {pert_cd[-1]:.6e} "
              f"({pert_cd[-1] / cd:.4f} of the chamfer to gt)", flush=True)

    shape_b = jnp.asarray(pc_utils.normalize_point_cloud(inp)[0])[None]
    num_patches = int(inp.shape[0] / NUM_POINT * 3.0)
    seeds = gather_nd(shape_b, _dispatch_fps(shape_b, num_patches, None,
                                             None))
    patch = normalize_point_batch_cl(
        knn_group(seeds, shape_b, NUM_POINT).neighbors[0][:1])[0]
    cascade = cascade_trace(net, params, patch)
    whole = jax.jit(lambda p, x: net.apply({"params": p}, x, RATIO,
                                           train=False))(params, patch)
    d = cKDTree(np.asarray(whole[0])).query(np.asarray(cascade.pop("last"))[0])
    print(f"cascade step by step vs Net.upsample in one jit: "
          f"{(d[0] ** 2 < 1e-10).mean():.4f} of the points coincide",
          flush=True)
    np.savez_compressed(OUT, input=inp, gt=gt, jax_out=out,
                        jax_cd_gt=np.float64(cd),
                        jax_pert_cd=np.asarray(pert_cd, np.float64),
                        jax_seconds=np.float64(seconds),
                        ratio=np.int64(RATIO),
                        num_point=np.int64(NUM_POINT),
                        chunk=np.int64(CHUNK), **cascade)
    print("wrote", OUT, os.path.getsize(OUT), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
