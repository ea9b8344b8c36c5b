"""Rank functions of ``tests/test_torch_parallel.py`` and of the sharded
case of ``tests/test_torch_kernels_cuda.py``, run on every rank by
:func:`threepu_torch.parallel.launch.spawn`.

Spawned ranks import this module afresh, so it imports torch, numpy and
``threepu_torch`` only, never JAX.  Each function takes its rank's mesh
and a payload of numpy arrays and plain values, and returns numpy arrays
and the mesh's collective counts, taken around each case.
"""

import os

import numpy as np
import torch

from threepu_torch.inference import upsample_shape
from threepu_torch.io import load_checkpoint
from threepu_torch.models import Net
from threepu_torch.parallel import (batch_sharded, make_mesh,
                                    make_sharded_train_step,
                                    make_sharded_upsampler, replicated)
from threepu_torch.train import TrainConfig, make_optimizer, train_loop


def port_net(config: dict, weights: dict, device) -> Net:
    """The port's ``Net(**config)`` on ``weights`` (numpy, port names)."""
    net = Net(**config)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()},
                        strict=True)
    return net.to(device)


def params_of(net: Net) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in net.state_dict().items()}


def counted(mesh, fn):
    """``(fn(), the collectives it ran through mesh)``."""
    mesh.counts.clear()
    out = fn()
    return out, dict(mesh.counts)


def upsample(mesh, net: Net, case: dict) -> np.ndarray:
    """One upsampler case of the payload: ``make_sharded_upsampler`` on a
    normalized cloud, or ``upsample_shape`` with the mesh."""
    if case["kind"] == "shape":
        return upsample_shape(net, case["points"], case["ratio"],
                              num_point=case["num_point"],
                              chunk=case["chunk"], bucket=case["bucket"],
                              mesh=mesh)[1]
    fn = make_sharded_upsampler(net, mesh, case["ratio"], case["num_point"],
                                num_patches=case["num_patches"],
                                num_out=case["num_out"])
    return fn(case["points"]).cpu().numpy()


def train_step_case(mesh, payload: dict) -> dict:
    """The sharded step on the global batch with its re-patch seeds
    pinned: its loss and parameters, the collectives of a step without
    and with the prediction, and that prediction."""
    dev = mesh.device
    t = payload["train"]
    net = port_net(t["net"], t["weights"], dev).train()
    opt = make_optimizer(net.parameters(), t["lr"])
    step = make_sharded_train_step(net, opt, mesh)
    inp = torch.from_numpy(t["input"]).to(dev)
    gt = torch.from_numpy(t["gt"]).to(dev)
    seeds = [torch.from_numpy(s).to(dev) for s in t["seeds"]]
    loss, counts = counted(mesh, lambda: step(net, opt, inp, gt, t["ratio"],
                                              seed_idx=seeds))
    out = dict(loss=float(loss), params=params_of(net), counts=counts)
    (loss2, (pred, gt_out)), out["pred_counts"] = counted(
        mesh, lambda: step(net, opt, inp, gt, t["ratio"], seed_idx=seeds,
                           with_pred=True))
    out.update(loss2=float(loss2), pred=pred.cpu().numpy(),
               gt_out=gt_out.cpu().numpy(), params2=params_of(net))
    return out


def generator_step_case(mesh, payload: dict) -> dict:
    """The sharded step drawing its own re-patch seeds from a generator
    seeded alike on every rank: its loss and parameters."""
    t = payload["train"]
    net = port_net(t["net"], t["weights"], mesh.device).train()
    opt = make_optimizer(net.parameters(), t["lr"])
    step = make_sharded_train_step(net, opt, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(
        payload["generator_seed"])
    loss = step(net, opt, torch.from_numpy(t["input"]),
                torch.from_numpy(t["gt"]), t["ratio"], generator=gen)
    return dict(loss=float(loss), params=params_of(net))


def loop_case(mesh, payload: dict) -> dict:
    """``train_loop`` with ``mesh``: its error log and parameters."""
    cfg = TrainConfig(**payload["loop"], mesh=mesh)
    state, error_log = train_loop(cfg, max_steps=payload["loop_steps"])
    return dict(error_log=dict(error_log), params=params_of(state.net),
                step=state.step)


def checkpoint_case(mesh, payload: dict) -> dict:
    """One whole epoch of ``train_loop`` with ``mesh``, each rank given a
    ``model_dir`` of its own: the files each rank's directory holds after
    it, and whether rank 0's checkpoint reads back as its parameters."""
    model_dir = os.path.join(payload["ckpt_root"], f"rank{mesh.rank}")
    cfg = TrainConfig(**dict(payload["loop"], model_dir=model_dir,
                             stage_steps=10 ** 6, max_epoch=1,
                             ckpt_epochs=1), mesh=mesh)
    state, _ = train_loop(cfg)
    files = sorted(os.listdir(model_dir)) if os.path.isdir(model_dir) else []
    read_back = None
    if files:
        restored, step = load_checkpoint(os.path.join(model_dir, files[0]),
                                         state.net)
        mine = state.net.state_dict()
        read_back = step == state.step and all(
            torch.equal(restored[k].cpu(), mine[k].cpu()) for k in mine)
    return dict(files=files, read_back=read_back, step=state.step)


def indivisible_batch_raises(mesh, payload: dict) -> bool:
    cfg = TrainConfig(**dict(payload["loop"], batch_size=mesh.size + 1),
                      mesh=mesh)
    try:
        train_loop(cfg, max_steps=1)
    except ValueError:
        return True
    return False


def other_device_raises(mesh, payload: dict) -> bool:
    """``train_loop`` with ``mesh`` on the CPU, asked for the card."""
    cfg = TrainConfig(**payload["loop"], mesh=mesh)
    try:
        train_loop(cfg, max_steps=1, device="cuda")
    except ValueError:
        return True
    return False


def n_devices_raises(mesh) -> bool:
    try:
        make_mesh(mesh.size + 1, device=mesh.device)
    except ValueError:
        return True
    return False


def parallel_cases(mesh, payload: dict) -> dict:
    """Every case of ``tests/test_torch_parallel.py`` at this world size
    (the loop's only where the payload holds one), in one spawn."""
    out = dict(rank=mesh.rank, size=mesh.size,
               rows=np.array(batch_sharded(mesh, payload["rows"])),
               n_devices_raises=n_devices_raises(mesh))
    out["replicated"] = counted(mesh, lambda: replicated(
        mesh, np.full((2, 3), mesh.rank, np.float32)).numpy())
    net = port_net(payload["net"], payload["weights"], mesh.device).eval()
    out["upsample"] = {name: counted(mesh, lambda: upsample(mesh, net, case))
                       for name, case in payload["upsample"].items()}
    out["train"] = train_step_case(mesh, payload)
    out["generator_step"] = generator_step_case(mesh, payload)
    if "loop" in payload:
        out["loop"] = loop_case(mesh, payload)
        out["checkpoint"] = checkpoint_case(mesh, payload)
        out["indivisible_raises"] = indivisible_batch_raises(mesh, payload)
        out["other_device_raises"] = other_device_raises(mesh, payload)
    return out


def sharded_upsample(mesh, config: dict, weights: dict, case: dict):
    """One upsampler case on this rank's device: the output, the
    collectives it ran and each kernel's launches in this rank."""
    from threepu_torch.ops import fps, interlevel, select
    kernels = {"select": select.KERNEL, "fps": fps.KERNEL,
               "interlevel": interlevel.KERNEL}
    net = port_net(config, weights, mesh.device).eval()
    out, counts = counted(mesh, lambda: upsample(mesh, net, case))
    return out, counts, {name: k.launches for name, k in kernels.items()}

