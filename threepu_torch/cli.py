"""Command-line interface of the port (counterpart of ``threepu/cli.py``).

    python -m threepu_torch.cli --phase test --ckpt weights.npz \\
        --num_point 312 --test_data 'shapes/*.xyz' --result_dir out
    python -m threepu_torch.cli --phase train --h5_data data/train_*.npz \\
        --num_shape_point 5000 --num_point 312 --log_dir model --id demo
    python -m threepu_torch.cli --phase vis --ckpt weights.npz \\
        --num_point 312 --test_data 'shapes/*.xyz'

The flags are the JAX package's, name by name, with the same defaults and
choices, so a command line of ``python -m threepu.cli`` carries over.
``--phase test`` upsamples every file matching ``--test_data`` and writes
``<result_dir>/<parent folder>/<name>.ply`` beside ``<name>_input.ply``;
``--ckpt`` is a JAX-package ``.npz`` or a reference ``.pth``.  ``--phase
train`` trains from an ``.hdf5`` or ``.npz`` training file and writes
``<log_dir>/<id>/model_<epoch>.npz`` (:func:`threepu_torch.train.train_loop`).
``--phase vis`` captures the cascade's per-level kNN graphs of each test
file and plots each with :class:`threepu_torch.vis.Painter` (matplotlib).
``--step_ratio`` sets the net's per-level ratio in every phase (2: a 1-D
code column, 4: a 2-D code grid).  ``--arch punet`` runs PU-Net's
generator instead of 3PU's cascade in ``--phase test`` (``--up_ratio 4``;
``--ckpt`` a ``.pth`` state dict under the published scope names), and
``--arch pugan`` PU-GAN's (its test protocol: ``--up_ratio 4
--num_point 256``); it is the port's one flag that the JAX package
lacks.  Every
``--knn_method`` but ``exact`` raises: they are not ported.

The entry point runs on the CUDA device ``--device`` (or ``--gpu``) and
raises where none is visible.  A Python caller may name another device:
``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Optional, Sequence, Union

import torch

from threepu_torch.inference import upsample_shape
from threepu_torch.io import import_pth, load, save_ply
from threepu_torch.models import load_net
from threepu_torch.ops import knn
from threepu_torch.train import TrainConfig, train_loop
from threepu_torch.utils import logger
from threepu_torch.utils.profiling import trace
from threepu_torch.vis import VisdomMonitor, vis_phase

Device = Optional[Union[str, torch.device]]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("threepu_torch")
    p.add_argument("--phase", default="test",
                   help="train or test or vis [default: test]")
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device ordinal (reference: --gpu)")
    p.add_argument("--gpu", type=int, default=0,
                   help="alias of --device, used when --device is 0")
    p.add_argument("--id", default="demo",
                   help="experiment name, appended to log_dir")
    p.add_argument("--log_dir", default="./model", help="Log dir")
    p.add_argument("--model", default="model_microscope",
                   help="(unused, reference compatibility)")
    p.add_argument("--root_dir", default="../",
                   help="(unused, reference compatibility)")
    p.add_argument("--result_dir", help="result directory")
    p.add_argument("--ckpt", help="model to restore from (.npz or .pth)")
    p.add_argument("--num_point", type=int, help="patch point number")
    p.add_argument("--num_shape_point", type=int,
                   help="number of points per shape")
    p.add_argument("--up_ratio", type=int, default=16,
                   help="upsampling ratio [default: 16]")
    p.add_argument("--max_epoch", type=int, default=160)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--h5_data", help="training file (.hdf5, or .npz with "
                                     "the same datasets)")
    p.add_argument("--record_data",
                   help="(unused, reference compatibility)")
    p.add_argument("--test_data", help="test data glob path")
    p.add_argument("--lr_init", type=float, default=0.0005)
    p.add_argument("--restore_epoch", type=int,
                   help="(unused, reference compatibility)")
    p.add_argument("--stage_steps", type=int, default=15000,
                   help="updates per curriculum stage")
    p.add_argument("--step_ratio", type=int, default=2)
    p.add_argument("--patch_num_ratio", type=float, default=3)
    p.add_argument("--jitter", action="store_true")
    p.add_argument("--jitter_sigma", type=float, default=0.0025)
    p.add_argument("--jitter_max", type=float, default=0.005)
    p.add_argument("--drop_out", type=float, default=1.0)
    p.add_argument("--knn", type=int, default=32)
    p.add_argument("--dense_n", type=int, default=3)
    p.add_argument("--block_n", type=int, default=3,
                   help="(unused, reference compatibility)")
    p.add_argument("--fm_knn", type=int, default=5)
    p.add_argument("--growth_rate", type=int, default=12)
    p.add_argument("--cd_threshold", type=float, default=2.0)
    p.add_argument("--fidelity_weight", type=float, default=50.0,
                   help="(declared but unused in the reference; same here)")
    p.add_argument("--loss_weight_mode", default="floored",
                   choices=["floored", "reference"],
                   help="per-ratio loss weight of the train phase")
    p.add_argument("--chunk", type=int, default=8,
                   help="patches per cascade call, bounding device memory")
    p.add_argument("--knn_method", default="exact",
                   choices=["auto", "exact", "approx", "sort"],
                   help="kNN selection; only 'exact' is ported, the others "
                        "raise")
    p.add_argument("--select_kernel", default="on", choices=["on", "off"],
                   help="route small-k exact selections through the CUDA "
                        "selection kernel (on), or every selection through "
                        "a stable sort (off); the same results bit for bit")
    p.add_argument("--bucket", type=int,
                   help="point-count quantum for mixed-size test sets: "
                        "shapes are zero-padded and masked to the next "
                        "multiple, so one bucket runs at one set of tensor "
                        "shapes (try 1024)")
    p.add_argument("--profile_dir",
                   help="profile the first shape with torch.profiler and "
                        "write a Chrome trace (trace.json) there")
    p.add_argument("--arch", default="3pu", choices=["3pu", "punet", "pugan"],
                   help="the net: 3PU's cascade, or PU-Net's or PU-GAN's "
                        "generator (--phase test, --up_ratio 4) "
                        "[default: 3pu]")
    p.add_argument("--restitch_groups", type=int, default=None,
                   help="final re-stitch FPS grouping.  Default auto: G=8 "
                        "Morton-stratified hierarchical FPS from 16384 "
                        "output points up, exact FPS below.  1: exact FPS "
                        "everywhere.  G>1: hierarchical with G groups")
    return p


def result_path_for(flags) -> str:
    """``--result_dir``, else ``<log_dir>/<id>/result/x<ratio>/
    p<num_point>_s<num_shape_point>_<clean|s####>[_d##]``."""
    num_point = flags.num_point or (
        int(flags.num_shape_point * flags.drop_out)
        if flags.num_shape_point else None)
    parts = [f"p{num_point}" if num_point is not None else "pWhole",
             f"s{flags.num_shape_point}"
             if flags.num_shape_point is not None else "sWhole"]
    if flags.jitter:
        parts.append("s" + f"{flags.jitter_sigma:.4f}".replace(".", ""))
    else:
        parts.append("clean")
    if flags.drop_out < 1:
        parts.append("d" + f"{flags.drop_out:.2f}".replace(".", ""))
    return flags.result_dir or os.path.join(
        flags.log_dir, flags.id, "result", f"x{flags.up_ratio}",
        "_".join(parts))


def _device(flags, device: Device) -> Device:
    """``device``, else the CUDA device ``--device`` (else ``--gpu``)."""
    if device is None:
        return torch.device("cuda", flags.device or flags.gpu)
    return device


def _build_net(flags, device: Device = None) -> torch.nn.Module:
    """The flags' ``Net`` with ``--ckpt`` (``.npz``, or ``.pth`` through
    :func:`import_pth`) loaded strictly, on ``device`` (``None``: the CUDA
    device ``--device``, else ``--gpu``); with ``--arch punet`` or
    ``pugan``, that net for patches of ``--num_point`` points and its
    state dict."""
    if flags.arch != "3pu":
        num_point = flags.num_point or int(flags.num_shape_point
                                           * flags.drop_out)
        net = load_net(flags.ckpt, _device(flags, device), arch=flags.arch,
                       num_point=num_point, up_ratio=flags.up_ratio)
        logger.info(f"restored {flags.ckpt}")
        return net.eval()
    cfg = dict(max_up_ratio=flags.up_ratio, step_ratio=flags.step_ratio,
               knn=flags.knn, growth_rate=flags.growth_rate,
               dense_n=flags.dense_n, fm_knn=flags.fm_knn)
    if flags.ckpt.endswith(".pth"):
        net = load_net(None, _device(flags, device), **cfg)
        state, _ = import_pth(flags.ckpt, net)
        net.load_state_dict(state, strict=True)
    else:
        net = load_net(flags.ckpt, _device(flags, device), **cfg)
    logger.info(f"restored {flags.ckpt}")
    return net.eval()


def run_test(flags, result_dir: str, device: Device = None) -> None:
    """Upsample every file matching ``--test_data`` into ``result_dir``."""
    if flags.num_point is None and flags.num_shape_point is None:
        raise SystemExit("--num_point (or --num_shape_point, to run each "
                         "shape as one patch) is required for test")
    if flags.test_data is None:
        raise SystemExit("--test_data is required for test")
    net = _build_net(flags, device)
    on_cuda = next(net.parameters()).is_cuda
    num_point = flags.num_point or int(
        flags.num_shape_point * flags.drop_out)
    if flags.num_point is None and num_point > 1024:
        # the reference derives the patch size from the shape size when
        # --num_point is omitted: one patch as large as the whole shape,
        # almost always a forgotten flag
        logger.warn(
            f"patch size num_point={num_point} (whole shape?) — the "
            f"canonical eval uses --num_point 312; this will be "
            f"extremely slow and memory-hungry")

    files = sorted(glob(flags.test_data, recursive=True))
    if not files:
        logger.warn(f"no files match {flags.test_data}")
        return
    # two host threads read file i+1 and write the files of shape i-1
    # while the device upsamples shape i
    with ThreadPoolExecutor(max_workers=2) as io_pool:
        pending_writes = []
        next_data = io_pool.submit(load, files[0], flags.num_shape_point)
        for i, path in enumerate(files):
            folder = os.path.basename(os.path.dirname(path))
            out_path = os.path.join(result_dir, folder,
                                    os.path.basename(path)[:-4] + ".ply")
            data = next_data.result()
            if i + 1 < len(files):
                next_data = io_pool.submit(load, files[i + 1],
                                           flags.num_shape_point)
            logger.info(os.path.basename(path))
            prof_ctx = contextlib.nullcontext()
            if flags.profile_dir and i == 0:
                prof_ctx = trace(flags.profile_dir, cuda=on_cuda)
            start = time.perf_counter()
            with prof_ctx:
                inp, up = upsample_shape(
                    net, data, flags.up_ratio, num_point=num_point,
                    patch_num_ratio=flags.patch_num_ratio, chunk=flags.chunk,
                    jitter=flags.jitter, jitter_sigma=flags.jitter_sigma,
                    jitter_max=flags.jitter_max, drop_out=flags.drop_out,
                    bucket=flags.bucket,
                    restitch_groups=flags.restitch_groups)
            logger.info(f"total time: {time.perf_counter() - start:.3f}s "
                        f"({up.shape[0]} points)")
            for w in [w for w in pending_writes if w.done()]:
                w.result()  # surface write errors
            pending_writes = [w for w in pending_writes if not w.done()]
            pending_writes.append(
                io_pool.submit(save_ply, inp, out_path[:-4] + "_input.ply"))
            pending_writes.append(io_pool.submit(save_ply, up, out_path))
            logger.success(out_path)
        for w in pending_writes:
            w.result()


def run_train(flags, device: Device = None) -> None:
    """Train from ``--h5_data`` into ``<log_dir>/<id>``, the training
    monitor on visdom where it is installed."""
    if flags.h5_data is None or flags.num_shape_point is None:
        raise SystemExit("--h5_data and --num_shape_point are required for "
                         "train")
    cfg = TrainConfig(
        h5_data=flags.h5_data, num_shape_point=flags.num_shape_point,
        num_point=flags.num_point, batch_size=flags.batch_size,
        up_ratio=flags.up_ratio, step_ratio=flags.step_ratio,
        knn=flags.knn, growth_rate=flags.growth_rate,
        dense_n=flags.dense_n, fm_knn=flags.fm_knn,
        lr_init=flags.lr_init, max_epoch=flags.max_epoch,
        stage_steps=flags.stage_steps, cd_threshold=flags.cd_threshold,
        jitter=flags.jitter, jitter_sigma=flags.jitter_sigma,
        jitter_max=flags.jitter_max, drop_out=flags.drop_out,
        ckpt=flags.ckpt, model_dir=os.path.join(flags.log_dir, flags.id),
        weight_mode=flags.loss_weight_mode)
    monitor = VisdomMonitor(env=flags.id)
    train_loop(cfg, log_fn=monitor.log_train_step,
               device=_device(flags, device))


def run_vis(flags, result_dir: str, device: Device = None) -> None:
    """Capture and plot the kNN graphs of every file matching
    ``--test_data`` (:func:`threepu_torch.vis.vis_phase`)."""
    if flags.num_point is None and flags.num_shape_point is None:
        raise SystemExit("--num_point (or --num_shape_point) is required "
                         "for vis")
    if flags.test_data is None:
        raise SystemExit("--test_data is required for vis")
    vis_phase(flags, _build_net(flags, device), result_dir)


def main(argv: Optional[Sequence[str]] = None, device: Device = None) -> None:
    """Parse ``argv`` (default: the process's arguments) and run the phase
    on the GPU, or on ``device`` when a Python caller names one."""
    flags = build_parser().parse_args(argv)
    if flags.phase not in ("train", "test", "vis"):
        raise SystemExit(f"unknown phase {flags.phase!r}")
    if flags.knn_method != "exact":
        raise NotImplementedError(
            f"--knn_method {flags.knn_method} is not ported; only 'exact' is")
    if flags.phase != "train" and flags.ckpt is None:
        raise SystemExit(f"--ckpt is required for {flags.phase}")
    if flags.arch != "3pu" and flags.phase != "test":
        raise SystemExit(f"--arch {flags.arch} runs --phase test only")
    select_kernel = knn.EXACT_SELECT_KERNEL
    knn.set_exact_select_kernel(flags.select_kernel == "on")
    try:
        if flags.phase == "train":
            run_train(flags, device)
        elif flags.phase == "vis":
            run_vis(flags, result_path_for(flags), device)
        else:
            run_test(flags, result_path_for(flags), device)
    finally:
        knn.set_exact_select_kernel(select_kernel)


if __name__ == "__main__":
    main()
