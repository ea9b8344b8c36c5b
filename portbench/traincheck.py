"""The training cell's correctness check: the loop's first steps from
the checkpoint and one step of the window, held to the plain reference
(:mod:`portbench.reference`).

The ratio-16 step is chaotic: its kNN picks, interlevel picks and
nearest-neighbour assignments flip on near-ties under rounding, and a
flipped pick moves the loss by more than a lower precision does.  So the
reference follows the program's decisions: it takes each of the
program's picks in call order (and counts how many equal its own).  For
the first steps it computes every value from its own parameters and
optimizer state, read from the checkpoint itself; for the window's step,
one drawn from the seed among however many the window runs, it starts
from the program's parameters and Adam state just before that step, as
the steps between cannot be followed without the program's picks.  What
this skips is checked by itself:

- ``batch``: the batch, re-patch seeds, ratio and threshold of each
  checked step, cut by the reference from the raw training file with the
  step's own draws, against the program's (max abs difference);
- ``decisions``: the share of the program's picks that differ from the
  reference's own at the same state.

And the steps (the contract's three numbers, each by the worst leaf
where it is of leaves):

- ``loss``: each step's loss, relative to the reference's;
- ``grad``: the first step's gradient as the optimizer got it (clipped;
  the program's worked out from its Adam state after one step), the gap
  of the norms of a leaf against the reference's norm of that leaf or of
  the median leaf, whichever is larger;
- ``change``: the parameters' change over the checked steps, the same
  way, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's.

The window's step gives the same numbers as ``window_batch``,
``window_decisions``, ``window_loss``, ``window_grad`` and
``window_change``.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench import reference as R

BETA1 = 0.9
INPUT_KEY = "poisson"
#: steps from the checkpoint that the check follows
START_STEPS = 3
READINGS = ("batch", "decisions1", "decisions", "loss1", "loss", "grad",
            "change1", "change", "change_median", "window_batch",
            "window_decisions", "window_loss", "window_grad",
            "window_change")


def torch_to_path(name: str) -> str:
    """``levels.level_1.up_layer.up_layer1.conv.weight`` ->
    ``level_1/up_layer1/conv/kernel`` (the checkpoint's path)."""
    name = name.removeprefix("levels.").replace("up_layer.", "")
    stem, _, leaf = name.rpartition(".")
    parts = stem.split(".")
    out = []
    for p in parts:
        if p.isdigit() and out and out[-1] == "mlps":
            out[-1] = f"mlps_{p}"
        else:
            out.append(p)
    return "/".join(out) + ("/kernel" if leaf == "weight" else "/bias")


def as_kernel(name: str, value: torch.Tensor) -> torch.Tensor:
    """A program tensor in the checkpoint's layout (a weight ``(out, in,
    1[, 1])`` as the kernel ``(in, out)``)."""
    if name.endswith(".weight"):
        return value.reshape(value.shape[0], value.shape[1]).t()
    return value


def curriculum(step: int, stage_steps: int, up_ratio: int, step_ratio: int,
               seed: int, cd_threshold: float = 2.0):
    """``(ratio, threshold)`` of a step: stage ``(s + S) // 2S``, the
    stage's newest ratio (drawn from the active ones past half a stage),
    the Chamfer threshold past 0.6 of it."""
    stage = (step + stage_steps) // (2 * stage_steps)
    progress = (step + stage_steps) / (2 * stage_steps) - stage
    n_levels = int(math.log(up_ratio, step_ratio))
    scales = [step_ratio ** r for r in range(1, min(stage + 1, n_levels) + 1)]
    ratio = scales[-1]
    if progress > 0.5:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        ratio = scales[int(rng.integers(len(scales)))]
    return ratio, (cd_threshold if progress > 0.6 else None)


def step_generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed % (1 << 64), step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def rotations(angles: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = torch.cos(angles).unbind(-1)
    sx, sy, sz = torch.sin(angles).unbind(-1)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    shape = (*angles.shape[:-1], 3, 3)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx],
                     -1).reshape(shape)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     -1).reshape(shape)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one],
                     -1).reshape(shape)
    return rz @ ry @ rx


class Data:
    """The training file as the reference reads it: every resolution
    normalized by the input resolution's centroid and radius."""

    def __init__(self, path: str, num_in: int, ratios: List[int], device):
        with np.load(path) as f:
            data = f[f"{INPUT_KEY}_{num_in}"].astype(np.float32)
            centroid = np.mean(data, axis=1, keepdims=True)
            data = data - centroid
            furthest = np.amax(np.sqrt(np.sum(data ** 2, axis=-1)), axis=1,
                               keepdims=True)[..., None]
            self.input = torch.from_numpy(data / furthest).to(device)
            self.labels = {r: torch.from_numpy(
                (f[f"{INPUT_KEY}_{num_in * r}"].astype(np.float32)
                 - centroid) / furthest).to(device) for r in ratios}


def repatch_sizes(num_point: int, ratio: int, step_ratio: int,
                  max_num_point: int) -> List[int]:
    max_np = min(num_point, max_num_point)
    n, sizes, level = num_point * step_ratio, [], step_ratio
    while level < ratio:
        if n > max_np:
            sizes.append(n)
            n = max_np
        n *= step_ratio
        level *= step_ratio
    return sizes


def batch(A: R.Arith, data: Data, seed: int, step: int, ratio: int,
          batch_size: int, num_point: int, net: dict):
    """``(input, gt, re-patch seeds)`` of a step, cut from ``data`` with
    the step's draws: seed points, rotation angles, then one seed a
    re-patching level."""
    g = step_generator(seed, step)
    dev = data.input.device
    i = step % data.input.shape[0]
    seed_idx = torch.randint(0, data.input.shape[1], (batch_size,),
                             generator=g)
    angles = torch.rand((batch_size, 3), generator=g) * (2 * math.pi)
    repatch = [torch.randint(0, n, (batch_size, 1), generator=g)
               for n in repatch_sizes(num_point, ratio, net["step_ratio"],
                                      net["max_num_point"])]
    shape, label = data.input[i], data.labels[ratio][i]
    centre = shape[seed_idx.to(dev).long()][None]
    inp = R.knn(A, centre, shape[None], num_point)[0][0]
    gt = R.knn(A, centre, label[None], num_point * ratio)[0][0]
    gt, c, r = R.normalize_batch(gt)
    inp = (inp - c) / r
    rot = rotations(angles.to(dev))
    return A.mm(inp, rot), A.mm(gt, rot), [s.to(dev) for s in repatch]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    norms = {k: float(ref[k].norm()) for k in keys}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    return {k: abs(float(prog[k].norm()) - norms[k])
            / max(norms[k], median, 1e-30) for k in keys}


def worst(gaps: Dict[str, float], what: str) -> float:
    if not gaps:
        return 0.0
    k = max(gaps, key=gaps.get)
    print(f"portbench: {what}: worst leaf {k} {gaps[k]:.3e}", file=sys.stderr)
    return gaps[k]


def batch_gap(data: Data, job: dict, st: dict, device) -> float:
    """The reference's cut of the step ``st["step"]`` from the raw file
    against the program's batch (max abs difference; infinite where the
    ratio, threshold or number of re-patch seeds differ)."""
    t, net = job["traffic"], job["config"]["net"]
    ratio, thr = curriculum(st["step"], t["stage_steps"], net["max_up_ratio"],
                            net["step_ratio"], job["seed"])
    with torch.no_grad():
        inp, gt, seeds = batch(R.Arith(), data, job["seed"], st["step"], ratio,
                               t["batch_size"], t["num_point"], net)
    if (ratio, thr) != (st["ratio"], st["threshold"]) \
            or len(seeds) != len(st["seeds"]):
        return math.inf
    return max([float((inp - st["inp"]).abs().max()),
                float((gt - st["gt"]).abs().max())]
               + [float((a.long() - b.to(device).long()).abs().max())
                  for a, b in zip(seeds, st["seeds"])])


def replayed_step(P, opt: R.Adam, spec: R.NetSpec, st: dict, label: str):
    """The reference's step on the program's batch with the program's
    picks (``P`` and ``opt`` updated in place): ``(share of picks that
    differ from the reference's own, loss relative to the reference's,
    the reference's clipped gradients)``."""
    A = R.Arith(replay=st["decisions"])
    loss, grads = R.train_step(A, P, spec, opt, st["inp"], st["gt"],
                               st["ratio"], st["seeds"], st["threshold"])
    eq = sum(a for a, _ in A.agree.values())
    tot = sum(b for _, b in A.agree.values())
    differ = 1.0 if A.replay_left() else 1.0 - eq / max(tot, 1)
    print(f"portbench: {label}: decisions differing by site "
          + ", ".join(f"{k} {1 - a / max(b, 1):.2e}"
                      for k, (a, b) in A.agree.items()), file=sys.stderr)
    lr = float(loss)
    return differ, abs(float(st["loss"]) - lr) / max(abs(lr), 1e-30), grads


def moved_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by rounding alone)."""
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    return [k for k in sorted(norms) if norms[k] >= 1e-3 * median]


def program_grad(m0, m1, keys) -> Dict[str, torch.Tensor]:
    """The gradient Adam got, from its first moment before and after."""
    return {k: (m1[k] - BETA1 * m0[k]) / (1 - BETA1) for k in keys}


def check_window(st: dict, job: dict, data: Data) -> Dict[str, float]:
    """Readings of the window's kept step ``st`` (also ``p0``, ``m0``,
    ``v0``, ``count0`` before it, ``m1``, ``p1`` after it), the
    reference starting from the program's state before it."""
    t = job["traffic"]
    spec = R.NetSpec(**job["config"]["net"])
    device = data.input.device
    P = {k: x.clone() for k, x in st["p0"].items()}
    opt = R.Adam(t["lr"], {k: x.clone() for k, x in st["m0"].items()},
                 {k: x.clone() for k, x in st["v0"].items()}, st["count0"])
    differ, loss, grads = replayed_step(P, opt, spec, st,
                                        f"window step {st['step']}")
    keys = sorted(P)
    moved = moved_leaves(grads)
    return dict(
        window_batch=batch_gap(data, job, st, device),
        window_decisions=differ, window_loss=loss,
        window_grad=worst(leaf_gaps(program_grad(st["m0"], st["m1"], keys),
                                    grads, keys), "window step's gradient"),
        window_change=worst(leaf_gaps(
            {k: st["p1"][k] - st["p0"][k] for k in keys},
            {k: P[k] - st["p0"][k] for k in keys}, moved),
            "window step's change"))


def check(rec: dict, job: dict, data_path: str, device) -> Dict[str, float]:
    """Readings of the program's checked steps ``rec``: ``steps`` (each
    ``step``, ``inp``, ``gt``, ``seeds``, ``ratio``, ``threshold``,
    ``loss``, ``decisions``), by parameter name ``p0``, ``m0`` (before
    the first step), ``m1``, ``p1`` (after it) and ``p_end`` (after the
    last), and ``window`` (see :func:`check_window`)."""
    t, net = job["traffic"], job["config"]["net"]
    spec = R.NetSpec(**net)
    path = job["resume"]
    P = R.load_params(path, device)
    count, m, v = R.load_adam(path, device)
    opt = R.Adam(t["lr"], m, v, count)
    P0 = {k: x.clone() for k, x in P.items()}
    ratios = [net["step_ratio"] ** r for r in
              range(1, spec.levels() + 1)]
    data = Data(data_path, t["num_shape_point"], ratios, device)
    if len(rec["steps"]) != START_STEPS or rec.get("window") is None:
        raise ValueError("the program's record lacks a checked step")
    out = {"batch": max(batch_gap(data, job, st, device)
                        for st in rec["steps"])}
    losses, disagree = [], []
    ref_g1 = P1 = None
    for n, st in enumerate(rec["steps"]):
        differ, loss, grads = replayed_step(P, opt, spec, st,
                                            f"step {n + 1}")
        disagree.append(differ)
        losses.append(loss)
        if n == 0:
            ref_g1 = grads
            P1 = {k: x.clone() for k, x in P.items()}
    keys = sorted(P)
    moved = moved_leaves(ref_g1)
    change = leaf_gaps({k: rec["p_end"][k] - rec["p0"][k] for k in keys},
                       {k: P[k] - P0[k] for k in keys}, moved)
    change1 = leaf_gaps({k: rec["p1"][k] - rec["p0"][k] for k in keys},
                        {k: P1[k] - P0[k] for k in keys}, moved)
    out.update(
        decisions1=disagree[0], decisions=max(disagree),
        loss1=losses[0], loss=max(losses),
        grad=worst(leaf_gaps(program_grad(rec["m0"], rec["m1"], keys),
                             ref_g1, keys), "first gradient"),
        change1=worst(change1, "change after the first step"),
        change=worst(change, "change after the checked steps"),
        change_median=float(np.median(list(change.values()))) if change
        else 0.0,
        left_out=float(len(keys) - len(moved)))
    try:
        out.update(check_window(rec["window"], job, data))
    except (ValueError, RuntimeError, IndexError, KeyError) as e:
        print(f"portbench: the check could not follow the window's step: "
              f"{e}", file=sys.stderr)
        out.update({k: math.inf for k in READINGS if k.startswith("window")})
    return out


def check_or_fail(*args) -> Dict[str, float]:
    """:func:`check`, or every reading infinite where the program's record
    does not fit the reference's steps (decisions of other sizes, a
    missing step)."""
    try:
        return check(*args)
    except (ValueError, RuntimeError, IndexError, KeyError) as e:
        print(f"portbench: the check could not follow the program: {e}")
        return {k: float("inf") for k in READINGS}


def control_rec(job: dict, data_path: str, device, tf32: bool = True,
                fault: str = "", window_step: int = 5) -> dict:
    """The reference in the program's place (TF32 products where
    ``tf32``): the checked steps recorded as the harness records the
    program's, its decisions its own; the window's step is the
    ``window_step``-th after the checkpoint.  ``fault="half"``: each step
    trains on the first half of the batch it is given."""
    t, net = job["traffic"], job["config"]["net"]
    spec = R.NetSpec(**net)
    path = job["resume"]
    P = R.load_params(path, device)
    count, m, v = R.load_adam(path, device)
    opt = R.Adam(t["lr"], m, v, count)
    start = job["start_step"]
    ratios = [net["step_ratio"] ** r for r in range(1, spec.levels() + 1)]
    data = Data(data_path, t["num_shape_point"], ratios, device)
    rec = {"steps": [], "start_step": start, "window": None,
           "p0": {k: x.clone() for k, x in P.items()},
           "m0": {k: x.clone() for k, x in m.items()}}

    def clone(d):
        return {k: x.clone() for k, x in d.items()}

    for n in range(max(START_STEPS, window_step + 1)):
        step = start + n
        ratio, thr = curriculum(step, t["stage_steps"], net["max_up_ratio"],
                                net["step_ratio"], job["seed"])
        A = R.Arith(tf32=tf32, record={})
        with torch.no_grad():
            inp, gt, seeds = batch(A, data, job["seed"], step, ratio,
                                   t["batch_size"], t["num_point"], net)
        A.record = {}
        before = dict(p0=clone(P), m0=clone(opt.m), v0=clone(opt.v),
                      count0=opt.count)
        h = inp.shape[0] // 2 if fault == "half" else inp.shape[0]
        loss, _ = R.train_step(A, P, spec, opt, inp[:h], gt[:h], ratio,
                               [s[:h] for s in seeds], thr)
        st = dict(step=step, inp=inp, gt=gt, seeds=seeds, ratio=ratio,
                  threshold=thr, loss=loss, decisions=A.record)
        if n < START_STEPS:
            rec["steps"].append(st)
        if n == window_step:
            rec["window"] = dict(st, **before, m1=clone(opt.m), p1=clone(P))
        if n == 0:
            rec["m1"] = clone(opt.m)
            rec["p1"] = clone(P)
        if n == START_STEPS - 1:
            rec["p_end"] = clone(P)
    return rec
