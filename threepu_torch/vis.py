"""Visualization (port of :mod:`threepu.vis`).

- :class:`VisdomMonitor` plots the input, the prediction and the ground
  truth of a log step's first patch, and the running-mean loss of its
  ratio, on a visdom server.  ``visdom`` is optional: without it (or
  without a server) the monitor warns once and does nothing.
- :func:`collect_intermediates` / :func:`vis_phase`: the command line's
  ``vis`` phase.  Patches run through the eval cascade with a capture
  (:meth:`threepu_torch.models.Net.upsample`), which records each
  level's input points, layer features and edge-conv kNN indices; the
  batches merge into one cloud a level, kNN indices offset per
  (sub-)patch.
- :class:`Painter`: a matplotlib 3-D scatter; click a point to see its
  kNN.  matplotlib is imported only when a plot is drawn.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional, Union

import numpy as np
import torch

from threepu_torch.inference import cut_patches
from threepu_torch.io import load
from threepu_torch.ops.normalize import normalize_point_batch_cl
from threepu_torch.utils import logger
from threepu_torch.utils.pc_utils import normalize_point_cloud


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class VisdomMonitor:
    """Live training monitor; built without visdom installed (or
    reachable), it is a no-op."""

    def __init__(self, env: str = "main"):
        self._vis = None
        try:
            import visdom  # type: ignore
            self._vis = visdom.Visdom(env=env)
        except Exception:
            logger.warn("visdom unavailable; training monitor disabled")

    def log_train_step(self, step, ratio, loss, state, batch,
                       pred=None, gt_out=None, error=None) -> None:
        """Input, output and gt scatter windows of the first patch, and
        the running-mean ``error`` (else ``loss``) on the ratio's curve.
        ``pred`` / ``gt_out`` are the training forward's prediction and
        re-patched gt, as ``train_loop`` passes them on log steps."""
        if self._vis is None:
            return
        inp, gt = batch
        if gt_out is not None:
            gt = gt_out
        try:
            self._vis.scatter(
                _host(inp[0]), win=f"x{ratio}_input",
                opts=dict(title=f"x{ratio}_input", markersize=2))
            if pred is not None:
                self._vis.scatter(
                    _host(pred[0]), win=f"x{ratio}_output",
                    opts=dict(title=f"x{ratio}_output", markersize=2))
            self._vis.scatter(
                _host(gt[0]), win=f"x{ratio}_gt",
                opts=dict(title=f"x{ratio}_label", markersize=2))
            curve = loss if error is None else error
            self._vis.line(np.array([curve]), np.array([step]),
                           update="append", win=f"x{ratio}_loss",
                           opts=dict(title=f"x{ratio}_loss"))
        except Exception as e:  # the monitor must never stop training
            logger.warn(f"visdom logging failed: {e}")


def collect_intermediates(net, patches, ratio: int,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, np.ndarray]:
    """``net.upsample`` of ``patches (P, N, 3)`` (normalized; numpy or a
    tensor) on ``device`` (default: the net's), capturing every level.
    Returns ``{"level_<l>.<name>": array}`` with the batch merged: each
    capture ``(B, n, C)`` becomes ``(1, B * n, C)``, kNN indices offset
    by ``b * n`` for batch element ``b``; ``"__output__"`` holds the
    output ``(P, N * ratio, 3)``."""
    dev = torch.device(device) if device is not None else next(
        net.parameters()).device
    x = torch.as_tensor(patches, dtype=torch.float32).to(dev)
    capture: Dict[str, torch.Tensor] = {}
    out = net.upsample(x, ratio, capture=capture)
    result: Dict[str, np.ndarray] = {}
    for name, t in capture.items():
        b, n, c = t.shape
        if "nnIdx" in name:
            t = t + torch.arange(b, device=t.device,
                                 dtype=t.dtype)[:, None, None] * n
        result[name] = t.reshape(1, b * n, c).cpu().numpy()
    result["__output__"] = out.cpu().numpy()
    return result


def vis_phase(flags, net, result_dir: str, show: Optional[bool] = None
              ) -> None:
    """The command line's ``vis`` phase: for each file of
    ``--test_data``, cut ``--num_point`` patches around FPS seeds of the
    normalized shape, capture the cascade's intermediates at
    ``--up_ratio`` (:func:`collect_intermediates`, on the net's device)
    and open a :class:`Painter` per captured kNN graph, each on its own
    level's input cloud.  ``show=None``: plots block on screen only when
    ``DISPLAY`` is set, else render with the Agg backend and return.
    ``result_dir`` is taken for the command line's signature; nothing is
    written."""
    if show is None:
        show = bool(os.environ.get("DISPLAY"))
    dev = next(net.parameters()).device
    num_point = flags.num_point or int(flags.num_shape_point * flags.drop_out)
    for path in sorted(glob(flags.test_data, recursive=True)):
        data = load(path, flags.num_shape_point)
        data, _, _ = normalize_point_cloud(data)
        shape_b = torch.from_numpy(np.ascontiguousarray(
            data[None], np.float32)).to(dev)
        num_patches = max(
            int(data.shape[0] / num_point * flags.patch_num_ratio), 1)
        norm, _, _ = normalize_point_batch_cl(
            cut_patches(shape_b, num_patches, num_point))
        captured = collect_intermediates(net, norm, flags.up_ratio)
        xyz_flat = norm.reshape(-1, 3).cpu().numpy()
        for name, arr in captured.items():
            if "nnIdx" not in name:
                continue
            # each graph goes with its own level's input cloud: levels
            # past the first run on re-patched clouds
            scope = name.rsplit(".", 1)[0]
            cloud = captured.get(f"{scope}.xyz_in")
            cloud = cloud[0] if cloud is not None else xyz_flat
            painter = Painter("NN Feature")
            painter.nnIdx = arr[0]
            painter.interactive_3D_plot(cloud[:arr[0].shape[0]], name,
                                        show=show)


class Painter:
    """Interactive 3-D scatter: clicking a point highlights its kNN
    (``nnIdx (N, k)``)."""

    def __init__(self, title: str = "points"):
        self.title = title
        self.nnIdx: Optional[np.ndarray] = None
        self._highlight = None

    def interactive_3D_plot(self, xyz: np.ndarray, name: str = "",
                            show: bool = True):
        """Scatter ``xyz (N, 3)``; blocks in ``plt.show()`` when ``show``,
        else renders with the Agg backend.  Returns ``(figure, axes)``."""
        import matplotlib
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=4, picker=5)
        ax.set_title(f"{self.title} {name}")

        def on_pick(event):
            idx = int(np.atleast_1d(event.ind)[0])
            self.highlight(ax, xyz, idx)
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("pick_event", on_pick)
        if show:
            plt.show()
        return fig, ax

    def highlight(self, ax, xyz: np.ndarray, idx: int):
        """Mark the kNN of point ``idx`` in red, replacing the last mark."""
        if self._highlight is not None:
            try:
                self._highlight.remove()
            except Exception:
                pass
        if self.nnIdx is not None and idx < self.nnIdx.shape[0]:
            nn = self.nnIdx[idx].astype(int)
            nn = nn[nn < xyz.shape[0]]
            pts = xyz[nn]
            self._highlight = ax.scatter(
                pts[:, 0], pts[:, 1], pts[:, 2], s=30, c="red", marker="o")
        return self._highlight
