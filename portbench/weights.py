"""The weights a cell runs with, for the program and for the reference.

A configuration names its weights: an ``.npz`` checkpoint in the JAX
layout (``params/<path>/kernel (in, out)`` and ``bias``), which the
program loads with its own loader and the reference reads by itself; or
``"seed"``: the benchmark makes them on the device from the run's seed,
in one draw (Xavier-uniform kernels, zero biases, as the net's own
initialization draws them), and hands the same tensors to both sides.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from portbench import reference as R
from portbench.spec import ROOT


def param_shapes(net: dict) -> List[Tuple[str, Tuple[int, int]]]:
    """``[(JAX path of a dense layer, kernel shape (in, out))]`` of a net."""
    g, n_st = net["growth_rate"], net["dense_n"]
    c0 = 24
    block = c0 + n_st * g
    code_ch = 1 if net["step_ratio"] < 4 else 2
    out = []
    for l in range(1, int(round(math.log(net["max_up_ratio"],
                                         net["step_ratio"]))) + 1):
        lv = f"level_{l}"
        out.append((f"{lv}/layer0/conv", (3, c0)))
        feat = c0
        for i in (1, 2, 3, 4):
            if i > 1:
                out.append((f"{lv}/layer{i}_prep/conv", (feat, c0)))
            ins = [2 * c0] + [g * s + c0 for s in range(1, n_st)]
            out += [(f"{lv}/layer{i}/mlps_{s}", (ins[s], g))
                    for s in range(n_st)]
            feat += block
        widths = [feat + code_ch, 128, 128, 64, 3]
        names = ["up_layer1", "up_layer2", "fc_layer1", "fc_layer2"]
        out += [(f"{lv}/{nm}/conv", (a, b))
                for nm, a, b in zip(names, widths, widths[1:])]
    return out


def seeded(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{"<path>/kernel": (in, out), "<path>/bias": (out,)}`` drawn on
    ``device`` in one call from a generator seeded with ``seed``."""
    shapes = param_shapes(net)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(sum(a * b for _, (a, b) in shapes), generator=gen,
                   device=device)
    flat, at = {}, 0
    for path, (a, b) in shapes:
        bound = math.sqrt(6.0 / (a + b))
        flat[f"{path}/kernel"] = (u[at:at + a * b].view(a, b) * 2 - 1) * bound
        flat[f"{path}/bias"] = torch.zeros(b, device=device)
        at += a * b
    return flat


def checkpoint_path(cfg: dict) -> Path:
    return ROOT / cfg["weights"]


def reference_params(job: dict, device):
    """The reference's parameters, ``{path: (kernel, bias)}``."""
    cfg = job["config"]
    if cfg["weights"] == "seed":
        return R.pairs_of(seeded(cfg["net"], job["seed"], device))
    return R.pairs_of(R.load_params(str(checkpoint_path(cfg)), device))


def eval_net(job: dict, device):
    """``(the program's Net on device in eval mode, the reference's
    parameters)`` for the job's configuration."""
    from threepu_torch.io.weights import jax_path
    from threepu_torch.models import Net, load_net

    cfg = job["config"]
    if cfg["weights"] == "seed":
        flat = seeded(cfg["net"], job["seed"], device)
        net = Net(**cfg["net"]).to(device)
        state = {}
        for name, p in net.state_dict().items():
            path, leaf = jax_path(name)
            value = flat[f"{path}/{leaf}"]
            state[name] = (value.t().reshape(p.shape) if leaf == "kernel"
                           else value)
        net.load_state_dict(state, strict=True)
    else:
        path = str(checkpoint_path(cfg))
        net = load_net(path, device=device, **cfg["net"])
        flat = R.load_params(path, device)
    return net.eval(), R.pairs_of(flat)
