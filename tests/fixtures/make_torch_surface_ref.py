"""Make ``tests/fixtures/torch_surface_ref.npz``: the JAX package's results
on the paths of the port's one-GPU surface that the other fixtures do not
cover, for ``chip_smoke.py`` phase 7 (the card's machine has no JAX).

- **The step-4 net** ``Net(16, step_ratio=4, knn 32, growth 12, dense 3,
  312 points, fm_knn 5)`` at full width: ``step4_params/<path>``, its
  initial parameters as ``threepu.cli`` builds them without ``--ckpt``
  (``_load_params``: ``Net.init`` from ``PRNGKey(0)``; no trained weights
  for it exist).
- **Its cascade, step by step** (7a), on ``cascade_in`` of
  ``torch_port_ref.npz`` (the first 312-point patch of held-out shape 0):
  ``step4_cascade_out_1 (1, 1248, 3)``, and for level 2 its input
  ``step4_cascade_xyz_2``, its 20 sub-patches ``step4_cascade_sub_2``,
  their real count ``step4_cascade_true_sub_2`` and the Level's output
  ``step4_cascade_out_2 (20, 1248, 3)`` (normalized frame).
- **Its pipeline** (7b): ``step4_jax_cd_gt``, the Chamfer distance of
  :func:`threepu.inference.upsample_shape` of shape 0 at 16x (312-point
  patches, chunk 8, G=8) to the 80,000-point ground truth, and
  ``step4_jax_pert_cd_gt``, the same for the input times ``1 + 1e-6
  N(0, 1)``: how far rounding alone moves that distance.
- **Its train step at ratio 4** (7c): the batch ``_sample_impl`` cuts from
  shape 0 and its 20,000-point label (``sample_seed_4``, ``angles_4``
  pinned with numpy), ``input_4 (16, 312, 3)``, ``gt_4 (16, 1248, 3)``;
  ``loss_4``, the unweighted Chamfer loss, and ``grad_4/<path>``, the
  gradient of the weighted loss ``threepu.train.model.train_step``
  differentiates.
- **AdaptiveLevel** (7d; growth 12, dense 3, knn 15, fm_knn 5: at the
  reference's knn 16 ``layer4`` asks for 17 neighbours among 16 points
  and raises), its initial parameters ``adaptive_params/<path>``
  (``PRNGKey(0)``), its input ``patches``, the 48 normalized 312-point
  patches of shape 0 as the ``vis`` phase cuts them, and its outputs at
  ``target_n_point`` 1248: ``adaptive_out (48, 1225, 3)`` and
  ``adaptive_gfeat (48, 1, 264)``.
- **The vis capture** (7e): ``collect_intermediates`` of the first 8 of
  those patches with ``artifacts/prod_clean_final.npz``: level 1's
  ``vis_layer_4 (1, 2496, 264)`` and ``vis_nnIdx_layer_0`` ... ``_3 (1,
  2496, 32)``; and its float-noise control, for 8 noise seeds that
  scale the patches by ``1 + 1e-6 N(0, 1)``: ``vis_control_sets (8,
  4)``, the share of each layer's rows whose neighbour set is unchanged
  (``vis_control_rows``: in order too; near-equal distances reorder
  under rounding), and ``vis_control_layer4 (8,)``, the share of
  ``layer_4``'s rows within 1e-4 (a neighbour set that changes moves its
  row's max-pooled features).

JAX runs on the CPU with float32 matmuls at full precision.  About 5
minutes and a few GB on 8 cores.  Run from the repository root:

    python tests/fixtures/make_torch_surface_ref.py
"""

import os
import sys
import time
import unittest.mock as mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import h5py
import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_surface_ref.npz")
PORT_REF = os.path.join(ROOT, "tests", "fixtures", "torch_port_ref.npz")
WEIGHTS = os.path.join(ROOT, "artifacts", "prod_clean_final.npz")
NET4 = dict(max_up_ratio=16, step_ratio=4, knn=32, growth_rate=12,
            dense_n=3, max_num_point=312, fm_knn=5)
ADAPTIVE = dict(dense_n=3, growth_rate=12, knn=15, fm_knn=5)
RATIO, NUM_POINT, CHUNK, BATCH, SEED = 16, 312, 8, 16, 0
TARGET, VIS_PATCHES = 1248, 8


def cascade_trace(net, params, patch):
    """``Net.upsample`` of one normalized patch ``(1, N, 3)`` at
    ``RATIO``, step by step; returns the ``step4_cascade_*`` arrays."""
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
    rec = {"cascade_out_1": xyz}
    old_xyz, old_feats, prev_invalid = patch, feats, None
    for l in range(2, net.num_levels + 1):
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
    return {f"step4_{k}": np.asarray(a) for k, a in rec.items()}


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from threepu import cli as jcli
    from threepu.data.h5_dataset import _sample_impl
    from threepu.inference import upsample_shape
    from threepu.io import load_checkpoint
    from threepu.io.checkpoint import _flatten
    from threepu.losses import chamfer_loss
    from threepu.models import AdaptiveLevel, Net
    from threepu.ops import gather_nd, knn_group
    from threepu.ops.fps import _dispatch_fps
    from threepu.ops.normalize import normalize_point_batch_cl
    from threepu.train.model import loss_weight
    from threepu.utils import pc_utils
    from threepu.vis import collect_intermediates

    from chip_smoke import normalize_by_input

    t_start = time.time()
    with h5py.File(os.path.join(ROOT, "artifacts", "held.hdf5"), "r") as f:
        inp = f["poisson_5000"][0].astype(np.float32)
        label_4 = f["poisson_20000"][0].astype(np.float32)
        gt = f["poisson_80000"][0].astype(np.float32)
    port_ref = np.load(PORT_REF)
    assert np.array_equal(port_ref["input"], inp)
    assert np.array_equal(port_ref["gt"], gt)
    out = {}

    # the step-4 net's initial parameters, as the JAX command line builds
    # them without --ckpt
    net = Net(**NET4)
    flags = jcli.build_parser().parse_args(
        ["--step_ratio", "4", "--num_point", str(NUM_POINT), "--up_ratio",
         str(RATIO)])
    with mock.patch.object(net, "init", jax.jit(
            net.init, static_argnums=(2,), static_argnames=("train",))):
        params = jcli._load_params(flags, net)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    out.update({f"step4_params/{k}": v for k, v in flat.items()})
    print(f"step-4 net: {sum(v.size for v in flat.values())} parameters "
          f"({time.time() - t_start:.0f} s)", flush=True)

    # 7a: the cascade step by step on the port fixture's patch
    out.update(cascade_trace(net, params, jnp.asarray(port_ref["cascade_in"])))
    print(f"cascade: true sub-patches {out['step4_cascade_true_sub_2']} "
          f"({time.time() - t_start:.0f} s)", flush=True)

    # 7b: the pipeline's Chamfer distance to the ground truth
    def chamfer(a, b):
        return float(chamfer_loss(jnp.asarray(a)[None], jnp.asarray(b)[None]))

    cds = []
    for seed in (None, 1):
        x = inp if seed is None else (inp * (1.0 + 1e-6 * np.random.default_rng(
            seed).standard_normal(inp.shape))).astype(np.float32)
        t0 = time.time()
        _, up = upsample_shape(net, params, x, RATIO, num_point=NUM_POINT,
                               chunk=CHUNK)
        up = np.asarray(up, np.float32)
        assert up.shape == (inp.shape[0] * RATIO, 3) and np.isfinite(up).all()
        cds.append(chamfer(up, gt))
        print(f"pipeline (noise seed {seed}): chamfer to gt {cds[-1]:.6e} "
              f"({time.time() - t0:.0f} s)", flush=True)
    out["step4_jax_cd_gt"] = np.float64(cds[0])
    out["step4_jax_pert_cd_gt"] = np.float64(cds[1])

    # 7c: the ratio-4 train step on a batch of shape 0, draws pinned
    rng = np.random.default_rng(SEED)
    shape, lab4 = normalize_by_input(inp[None], label_4[None])
    seed_idx = rng.integers(0, inp.shape[0], (BATCH,))
    angles = rng.uniform(0, 2 * np.pi, (BATCH, 3)).astype(np.float32)
    with mock.patch.object(jax.random, "randint",
                           lambda *a, **kw: jnp.asarray(seed_idx)), \
            mock.patch.object(jax.random, "uniform",
                              lambda *a, **kw: jnp.asarray(angles)):
        x, gt4 = _sample_impl.__wrapped__(
            jnp.asarray(shape), jnp.asarray(lab4), jax.random.PRNGKey(0),
            jnp.asarray(0), ratio=4, batch_size=BATCH,
            num_patch_point=NUM_POINT, phase="train", jitter=False,
            jitter_sigma=0.0025, jitter_max=0.005, drop_out=1.0,
            is_2d=False)
    x, gt4 = np.asarray(x, np.float32), np.asarray(gt4, np.float32)
    weight = loss_weight(4, NET4["max_up_ratio"], NET4["step_ratio"])

    def loss_fn(p):
        pred, gt_out = net.apply({"params": p}, x, 4, gt4, train=True,
                                 rngs={"patch": jax.random.PRNGKey(0)})
        cd = chamfer_loss(pred, gt_out)
        return cd * weight, cd

    (_, cd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out.update(sample_seed_4=seed_idx, angles_4=angles, input_4=x, gt_4=gt4,
               loss_4=np.float64(cd))
    out.update({f"grad_4/{k}": np.asarray(v)
                for k, v in _flatten(grads).items()})
    print(f"train ratio 4: loss {float(cd):.9e} "
          f"({time.time() - t_start:.0f} s)", flush=True)

    # the 48 patches of shape 0 as the vis phase cuts them
    shape_b = jnp.asarray(pc_utils.normalize_point_cloud(inp)[0])[None]
    num_patches = max(int(inp.shape[0] / NUM_POINT * 3.0), 1)
    seeds = gather_nd(shape_b, _dispatch_fps(shape_b, num_patches, None,
                                             None))
    patches = normalize_point_batch_cl(
        knn_group(seeds, shape_b, NUM_POINT).neighbors[0])[0]
    out["patches"] = np.asarray(patches, np.float32)

    # 7d: AdaptiveLevel at full width
    ada = AdaptiveLevel(**ADAPTIVE)
    ada_params = jax.jit(ada.init, static_argnums=(2,))(
        jax.random.PRNGKey(0), patches, TARGET)["params"]
    ada_out, gfeat = jax.jit(lambda p, a: ada.apply({"params": p}, a, TARGET))(
        ada_params, patches)
    out.update({f"adaptive_params/{k}": np.asarray(v)
                for k, v in _flatten(ada_params).items()})
    out.update(adaptive_out=np.asarray(ada_out),
               adaptive_gfeat=np.asarray(gfeat))
    print(f"adaptive: {ada_out.shape}, {gfeat.shape} "
          f"({time.time() - t_start:.0f} s)", flush=True)

    # 7e: level 1's capture of the first 8 patches, trained weights
    trained = Net(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12,
                  dense_n=3, max_num_point=NUM_POINT, fm_knn=5)
    tparams = load_checkpoint(WEIGHTS)[0]["params"]
    fn = jax.jit(lambda v, a: trained.apply(v, a, 2, train=False,
                                            mutable=["intermediates"]))
    fast = mock.Mock(apply=lambda v, a, r, **kw: fn(v, a))
    vis_patches = np.asarray(patches[:VIS_PATCHES], np.float32)
    cap = collect_intermediates(fast, tparams, vis_patches, 2)
    out["vis_layer_4"] = cap["level_1.layer_4"].astype(np.float32)
    graphs = [cap[f"level_1.nnIdx_layer_{i}"][0] for i in range(4)]
    for i, g in enumerate(graphs):
        out[f"vis_nnIdx_layer_{i}"] = g[None].astype(np.int32)
    sets, rows, layer4 = [], [], []
    for seed in range(1, 9):
        noise = np.random.default_rng(seed).standard_normal(vis_patches.shape)
        pert = collect_intermediates(
            fast, tparams, (vis_patches * (1 + 1e-6 * noise)).astype(
                np.float32), 2)
        got = [pert[f"level_1.nnIdx_layer_{i}"][0] for i in range(4)]
        rows.append([float((a == b).all(-1).mean())
                     for a, b in zip(got, graphs)])
        sets.append([float((np.sort(a, -1) == np.sort(b, -1)).all(-1).mean())
                     for a, b in zip(got, graphs)])
        err = np.abs(pert["level_1.layer_4"][0] - out["vis_layer_4"][0])
        layer4.append(float((err.max(-1) <= 1e-4).mean()))
    out["vis_control_sets"] = np.asarray(sets)
    out["vis_control_rows"] = np.asarray(rows)
    out["vis_control_layer4"] = np.asarray(layer4)
    print(f"vis control over 8 seeds: smallest share of rows unchanged, in "
          f"order {np.min(rows, 0)}, as sets {np.min(sets, 0)}; of layer_4's "
          f"rows within 1e-4 {min(layer4)}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}, {os.path.getsize(OUT)} bytes, "
          f"{time.time() - t_start:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
