"""Make ``tests/fixtures/torch_train_ref.npz``: the JAX package's training
step on full-width batches, for the PyTorch port's training check.

The port's GPU check runs where neither JAX nor h5py is installed, so
this script freezes what that check needs.  The net is
``Net(16, 2, knn 32, growth 12, dense 3, 312, fm_knn 5)`` with
``artifacts/prod_clean_final.npz``; the data is held-out shape 0 of
``artifacts/held.hdf5``, normalized as ``load_h5_data`` does (every
resolution by the 5000-point input's centroid and radius;
``chip_smoke.normalize_by_input``).  For each
ratio r in (2, 16):

- ``sample_seed_{r}`` (16,), ``angles_{r}`` (16, 3): the draws of
  ``_sample_impl`` (seed points, rotation angles), made with numpy;
- ``input_{r}`` (16, 312, 3), ``gt_{r}`` (16, 312 r, 3): the batch
  ``_sample_impl`` cuts with them (train phase, no jitter);
- ``repatch_{r}`` (L, 16, 1): the re-patch seed of each of the L
  re-patching levels (none at ratio 2, three at ratio 16);
- ``loss_{r}``: the unweighted Chamfer loss of the train step, and
  ``grad_{r}/<param path>``: the gradient of the weighted loss that
  ``threepu.train.model.train_step`` differentiates;
- ``control_loss_{r}``, ``control_grad_{r}``: the float-noise control,
  for 64 noise seeds: the relative loss change and the relative L2
  change of all gradients together when the batch (input and gt) is
  scaled by ``1 + 1e-6 * N(0, 1)`` per coordinate;

and at ratio 16, ``adam_repatch`` (5, 3, 16, 1) and ``adam_loss`` (5,):
five steps of the clipped Adam update (``make_optimizer``, lr 5e-4) on
the ratio-16 batch, each with its own re-patch seeds, and the loss each
step returns.  ``label_2`` holds the 10,000-point resolution of the
shape (``torch_port_ref.npz`` holds the 5000-point input and the 80,000
ground truth).

It also runs the port's training step on the CPU on the same batches
and prints how far it lies from JAX.  JAX runs on the CPU with float32
matmuls at full precision.  Takes about 9 minutes and 3.3 GB on 8 CPU
cores.  Run from the repository root:

    python tests/fixtures/make_torch_train_ref.py
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

OUT = os.path.join(ROOT, "tests", "fixtures", "torch_train_ref.npz")
NET = dict(max_up_ratio=16, step_ratio=2, knn=32, growth_rate=12, dense_n=3,
           max_num_point=312, fm_knn=5)
BATCH = 16
NUM_POINT = 312
RATIOS = (2, 16)
ADAM_STEPS = 5
LR = 5e-4
SEED = 0
#: the float-noise control's noise seeds: the chip check holds the port to
#: the largest of these JAX-against-JAX changes, so many seeds keep a
#: port that differs from JAX by rounding alone from failing by chance
NOISE_SEEDS = tuple(range(1, 65))


def repatch_levels(ratio):
    return int(np.log2(ratio)) - 1


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import optax
    import torch

    from threepu.data.h5_dataset import _sample_impl
    from threepu.io import load_checkpoint
    from threepu.io.checkpoint import _flatten
    from threepu.losses import chamfer_loss
    from threepu.models import Net
    from threepu.train.model import loss_weight, make_optimizer

    from chip_smoke import normalize_by_input
    from threepu_torch.io.weights import state_dict_from_jax
    from threepu_torch.models import load_net
    from threepu_torch.train import make_optimizer as make_port_optimizer
    from threepu_torch.train import train_loss, train_step

    t_start = time.time()
    with h5py.File(os.path.join(ROOT, "artifacts", "held.hdf5"), "r") as f:
        inp = f["poisson_5000"][0].astype(np.float32)
        label_2 = f["poisson_10000"][0].astype(np.float32)
        label_16 = f["poisson_80000"][0].astype(np.float32)
    port_ref = np.load(os.path.join(ROOT, "tests", "fixtures",
                                    "torch_port_ref.npz"))
    assert np.array_equal(port_ref["input"], inp)
    assert np.array_equal(port_ref["gt"], label_16)
    shape, lab2, lab16 = normalize_by_input(inp[None], label_2[None],
                                            label_16[None])
    labels = {2: lab2, 16: lab16}

    net = Net(**NET)
    weights = os.path.join(ROOT, "artifacts", "prod_clean_final.npz")
    params = load_checkpoint(weights)[0]["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    rng = np.random.default_rng(SEED)

    def make_loss(ratio):
        weight = loss_weight(ratio, NET["max_up_ratio"], NET["step_ratio"])

        def loss_fn(p, x, gt, seeds):
            it = iter([seeds[i] for i in range(seeds.shape[0])])
            with mock.patch.object(jax.random, "randint",
                                   lambda *a, **kw: next(it)):
                pred, gt_out = net.apply(
                    {"params": p}, x, ratio, gt, train=True,
                    rngs={"patch": jax.random.PRNGKey(0)})
            cd = chamfer_loss(pred, gt_out)
            return cd * weight, cd

        return loss_fn

    def flat(tree):
        return {k: np.asarray(v) for k, v in _flatten(tree).items()}

    def rel_l2(a, b):
        keys = sorted(a)
        da = np.concatenate([a[k].ravel() - b[k].ravel() for k in keys])
        nb = np.concatenate([b[k].ravel() for k in keys])
        return float(np.linalg.norm(da) / np.linalg.norm(nb))

    out = {"label_2": label_2}
    port = load_net(weights, device="cpu", **NET)
    for ratio in RATIOS:
        seed_idx = rng.integers(0, inp.shape[0], (BATCH,))
        angles = rng.uniform(0, 2 * np.pi, (BATCH, 3)).astype(np.float32)
        with mock.patch.object(jax.random, "randint",
                               lambda *a, **kw: jnp.asarray(seed_idx)), \
                mock.patch.object(jax.random, "uniform",
                                  lambda *a, **kw: jnp.asarray(angles)):
            x, gt = _sample_impl.__wrapped__(
                jnp.asarray(shape), jnp.asarray(labels[ratio]),
                jax.random.PRNGKey(0), jnp.asarray(0), ratio=ratio,
                batch_size=BATCH, num_patch_point=NUM_POINT, phase="train",
                jitter=False, jitter_sigma=0.0025, jitter_max=0.005,
                drop_out=1.0, is_2d=False)
        x, gt = np.asarray(x, np.float32), np.asarray(gt, np.float32)
        repatch = rng.integers(0, 2 * NUM_POINT,
                               (repatch_levels(ratio), BATCH, 1)
                               ).astype(np.int32)
        grad_fn = jax.jit(jax.value_and_grad(make_loss(ratio), has_aux=True))
        t0 = time.time()
        (_, cd), grads = grad_fn(params, x, gt, repatch)
        grads = flat(grads)
        print(f"ratio {ratio}: JAX loss {float(cd):.9e} "
              f"({time.time() - t0:.1f} s with compile)", flush=True)
        control_loss, control_grad = [], []
        for s in NOISE_SEEDS:
            nrng = np.random.default_rng(s)
            xp = (x * (1 + 1e-6 * nrng.standard_normal(x.shape))
                  ).astype(np.float32)
            gp = (gt * (1 + 1e-6 * nrng.standard_normal(gt.shape))
                  ).astype(np.float32)
            (_, cdp), gradp = grad_fn(params, xp, gp, repatch)
            control_loss.append(abs(float(cdp) - float(cd)) / float(cd))
            control_grad.append(rel_l2(flat(gradp), grads))
        print(f"ratio {ratio}: control over {len(NOISE_SEEDS)} seeds: loss "
              f"max {max(control_loss):.3e} median "
              f"{np.median(control_loss):.3e}; grads max "
              f"{max(control_grad):.3e} median {np.median(control_grad):.3e}",
              flush=True)

        # the port on the CPU, same batch and seeds
        weighted, pcd, _, _ = train_loss(
            port, torch.from_numpy(x), torch.from_numpy(gt), ratio,
            seed_idx=[torch.from_numpy(r) for r in repatch])
        port.zero_grad(set_to_none=True)
        weighted.backward()
        want = state_dict_from_jax(grads)
        got = {k: p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32)
               for k, p in port.named_parameters()}
        per = {k: float(np.linalg.norm(got[k] - w.numpy())
                        / np.linalg.norm(w.numpy()))
               for k, w in want.items() if np.any(w.numpy())}
        print(f"ratio {ratio}: port on the CPU: loss {pcd.item():.9e} "
              f"(rel err {abs(pcd.item() - float(cd)) / float(cd):.3e}); "
              f"grads rel L2 {rel_l2(got, {k: w.numpy() for k, w in want.items()}):.3e}, "
              f"worst tensor {max(per.values()):.3e} "
              f"({max(per, key=per.get)})", flush=True)

        out.update({f"sample_seed_{ratio}": seed_idx,
                    f"angles_{ratio}": angles, f"input_{ratio}": x,
                    f"gt_{ratio}": gt, f"repatch_{ratio}": repatch,
                    f"loss_{ratio}": np.float64(cd),
                    f"control_loss_{ratio}": np.asarray(control_loss),
                    f"control_grad_{ratio}": np.asarray(control_grad)})
        out.update({f"grad_{ratio}/{k}": v for k, v in grads.items()})

    # five clipped-Adam steps at ratio 16 on its batch
    tx = make_optimizer(LR)
    loss_fn = make_loss(16)

    @jax.jit
    def adam_step(p, opt_state, seeds):
        (_, cd), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, out["input_16"], out["gt_16"], seeds)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, cd

    adam_repatch = rng.integers(0, 2 * NUM_POINT,
                                (ADAM_STEPS, repatch_levels(16), BATCH, 1)
                                ).astype(np.int32)
    p, opt_state, losses = params, tx.init(params), []
    for seeds in adam_repatch:
        p, opt_state, cd = adam_step(p, opt_state, seeds)
        losses.append(float(cd))
    print(f"adam: JAX losses {losses}", flush=True)
    out.update(adam_repatch=adam_repatch, adam_loss=np.asarray(losses))
    opt = make_port_optimizer(port.parameters(), LR)
    port.load_state_dict(load_net(weights, device="cpu", **NET).state_dict())
    port_losses = [train_step(
        port, opt, torch.from_numpy(out["input_16"]),
        torch.from_numpy(out["gt_16"]), 16,
        seed_idx=[torch.from_numpy(r) for r in seeds]).item()
        for seeds in adam_repatch]
    print(f"adam: port losses on the CPU {port_losses}, rel err "
          f"{[abs(a - b) / b for a, b in zip(port_losses, losses)]}",
          flush=True)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}, {os.path.getsize(OUT)} bytes, "
          f"{time.time() - t_start:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
