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

:func:`jax_path` and :func:`jax_value` map back, for the checkpoints the
port writes in the JAX package's format (:mod:`threepu_torch.io.checkpoint`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

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


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested mapping of arrays (a JAX parameter or gradient tree) ->
    ``{"a/b/kernel": numpy array}``, the keys
    :func:`state_dict_from_jax` reads: so gradients cross over by the
    same names as parameters."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def torch_param(path: str, leaf: str, value) -> tuple:
    """One JAX leaf ``<path>/<leaf>`` -> ``(state-dict name, float32
    tensor)``: a kernel ``(in, out)`` becomes a weight ``(out, in, 1)``
    (``*_prep``) or ``(out, in, 1, 1)``."""
    name = reference_name(path)
    value = np.asarray(value, np.float32)
    if leaf == "kernel":
        w = value.T                                          # (out, in)
        w = w[..., None] if "_prep" in name else w[..., None, None]
        return name + ".weight", torch.from_numpy(np.ascontiguousarray(w))
    return name + ".bias", torch.from_numpy(value.copy())


def jax_path(name: str) -> Optional[Tuple[str, str]]:
    """A state-dict name -> ``(JAX path, "kernel" | "bias")``, the inverse
    of :func:`reference_name` (a ``module.`` prefix is dropped); ``None``
    for a name that is neither a weight nor a bias."""
    name = re.sub(r"^module\.", "", name)
    stem, _, last = name.rpartition(".")
    if last not in ("weight", "bias") or not stem:
        return None
    stem = re.sub(r"^levels\.", "", stem)
    stem = stem.replace("up_layer.", "")
    stem = re.sub(r"mlps\.(\d+)", r"mlps_\1", stem)
    return stem.replace(".", "/"), "kernel" if last == "weight" else "bias"


def jax_value(leaf: str, value) -> np.ndarray:
    """A weight ``(out, in, 1[, 1])`` -> the kernel ``(in, out)``; a bias
    as it is (numpy, on the host)."""
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    value = np.asarray(value)
    if leaf == "kernel":
        value = np.ascontiguousarray(value.reshape(value.shape[:2]).T)
    return value


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
        name, tensor = torch_param(path, leaf, value)
        state[name] = tensor
    return state


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX ``.npz`` checkpoint."""
    with np.load(path) as data:
        return state_dict_from_jax(
            {k: data[k] for k in data.files if k.startswith(PARAM_PREFIX)})
