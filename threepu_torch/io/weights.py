"""Trained JAX weights -> the port's state dict.

The JAX package stores parameters as flat ``params/<path>/{kernel,bias}``
numpy arrays (``threepu/io/checkpoint.py``; e.g.
``artifacts/prod_clean_final.npz``).  The port's modules carry the
reference's state-dict names and shapes, so the mapping is the one of
``threepu.io.checkpoint.export_reference_state``, re-implemented here in
numpy (the JAX package does not import without JAX):

- ``level_1/layer1/mlps_0`` -> ``levels.level_1.layer1.mlps.0``;
- ``level_1/up_layer1/conv`` -> ``levels.level_1.up_layer.up_layer1.conv``;
- a dense ``kernel (in, out)`` -> ``weight (out, in, 1)`` for the
  ``*_prep`` layers (``Conv1d``) and ``(out, in, 1, 1)`` elsewhere.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

PARAM_PREFIX = "params/"


def reference_name(path: str) -> str:
    """``level_1/layer1/mlps_0`` -> ``levels.level_1.layer1.mlps.0``."""
    name = path.replace("/", ".")
    name = re.sub(r"mlps_(\d+)", r"mlps.\1", name)
    name = re.sub(r"\b(up_layer\d)\b", r"up_layer.\1", name)
    if re.match(r"^level_\d+", name):
        name = "levels." + name
    return name


def state_dict_from_jax(flat_params: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Map flat JAX parameters (keys ``[params/]<path>/kernel|bias``;
    other keys, such as optimizer state, are skipped) to the port's
    float32 state dict."""
    state: Dict[str, torch.Tensor] = {}
    for key, value in flat_params.items():
        if key.startswith(PARAM_PREFIX):
            key = key[len(PARAM_PREFIX):]
        path, _, leaf = key.rpartition("/")
        if not path or leaf not in ("kernel", "bias"):
            continue
        name = reference_name(path)
        value = np.asarray(value, np.float32)
        if leaf == "kernel":
            w = value.T                                      # (out, in)
            w = w[..., None] if "_prep" in name else w[..., None, None]
            state[name + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
        else:
            state[name + ".bias"] = torch.from_numpy(value.copy())
    return state


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX ``.npz`` checkpoint."""
    with np.load(path) as data:
        return state_dict_from_jax(
            {k: data[k] for k in data.files if k.startswith(PARAM_PREFIX)})
