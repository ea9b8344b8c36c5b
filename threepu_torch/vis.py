"""Training monitor (port of :class:`threepu.vis.VisdomMonitor`; the
``vis`` phase is not ported yet).

:class:`VisdomMonitor` plots the input, the prediction and the ground
truth of a log step's first patch, and the running-mean loss of its
ratio, on a visdom server.  ``visdom`` is optional: without it (or
without a server) the monitor warns once and does nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from threepu_torch.utils import logger


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
