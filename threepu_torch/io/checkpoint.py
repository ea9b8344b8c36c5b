"""Checkpoints in the JAX package's formats (port of
``threepu/io/checkpoint.py``), so that each package reads the other's
files.

- ``.npz``: ``params/<JAX path>/{kernel,bias}`` arrays and a ``step``
  scalar (:func:`save_checkpoint` / :func:`load_checkpoint`); the
  full-state file adds the optimizer's leaves ``opt/<i>`` and their
  structural fingerprint ``opt_treedef`` (:func:`save_train_checkpoint`
  / :func:`load_opt_state`).  Kernels are stored ``(in, out)``
  (:func:`threepu_torch.io.weights.jax_value`).
- ``.pth``: the reference's ``{"states": state_dict, "step": str(step)}``
  (:func:`save_pth` / :func:`import_pth`); the port's modules carry the
  reference's names, so such a state dict loads into them directly.

``params`` below is a module or a state dict with the reference's names.
The clipped Adam of :func:`threepu_torch.train.make_optimizer` maps one
to one onto the JAX package's ``optax.chain(clip, adam)`` state: its
``count`` is each parameter's ``step``, ``mu`` its ``exp_avg`` and ``nu``
its ``exp_avg_sq``, stored in the kernel's layout in the order of JAX's
leaves (sorted dict keys).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from threepu_torch.io.weights import (PARAM_PREFIX, jax_path, jax_value,
                                      state_dict_from_jax, torch_param)
from threepu_torch.utils import logger

OPT_PREFIX = "opt/"
OPT_TREE_KEY = "opt_treedef"

Params = Union[torch.nn.Module, Mapping[str, torch.Tensor]]


def _state_dict(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return dict(params)


def flat_params(params: Params) -> Dict[str, np.ndarray]:
    """``{"<JAX path>/kernel|bias": numpy array}`` of ``params``."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in _state_dict(params).items():
        mapped = jax_path(name)
        if mapped is not None:
            flat[f"{mapped[0]}/{mapped[1]}"] = jax_value(mapped[1], value)
    return flat


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    np.savez(path, **arrays)


def _merge(loaded: Dict[str, torch.Tensor], target: Optional[Params]
           ) -> Dict[str, torch.Tensor]:
    """The JAX package's partial restore: keys absent from ``target`` are
    dropped, keys missing from ``loaded`` keep the target's values."""
    if target is None:
        return loaded
    merged = _state_dict(target)
    for k, v in loaded.items():
        if k in merged:
            merged[k] = v
    return merged


def save_checkpoint(path: str, params: Params, step: int = 0,
                    **extra: np.ndarray) -> None:
    """Write ``{params, step, **extra}`` as an ``.npz`` archive."""
    arrays = {PARAM_PREFIX + k: v for k, v in flat_params(params).items()}
    arrays["step"] = np.asarray(step, np.int64)
    arrays.update(extra)
    _savez(path, arrays)


def load_checkpoint(path: str, target: Optional[Params] = None
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``(state dict, step)`` of an ``.npz`` checkpoint; with ``target``
    restored partially as the JAX package does."""
    with np.load(path) as data:
        step = int(data["step"]) if "step" in data else 0
        flat = {k: data[k] for k in data.files if k.startswith(PARAM_PREFIX)}
    return _merge(state_dict_from_jax(flat), target), step


# ------------------------------------------------------ optimizer state
def _leaf_paths(params: Params) -> List[Tuple[str, ...]]:
    """The JAX paths of ``params``' leaves, as tuples, in JAX's leaf order
    (dict keys sorted at every level)."""
    return sorted(tuple(k.split("/")) for k in flat_params(params))


def _tree_repr(paths: List[Tuple[str, ...]]) -> str:
    """The ``PyTreeDef`` text of the nested dict with leaves at
    ``paths``."""
    tree: dict = {}
    for path in paths:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = None

    def text(node) -> str:
        if node is None:
            return "*"
        return "{" + ", ".join(f"{k!r}: {text(node[k])}"
                               for k in sorted(node)) + "}"

    return text(tree)


def opt_fingerprint(params: Params) -> str:
    """The fingerprint the JAX package stores for the state of
    ``optax.chain(optax.clip(1.0), optax.adam(lr))`` over ``params``: the
    treedef's text, then the key path of every leaf."""
    paths = _leaf_paths(params)
    tree = _tree_repr(paths)
    treedef = ("PyTreeDef((CustomNode(namedtuple[EmptyState], []), "
               "(CustomNode(namedtuple[ScaleByAdamState], [*, "
               f"{tree}, {tree}]), CustomNode(namedtuple[EmptyState], []))))")
    leaves = ["[1][0].count"] + [
        f"[1][0].{field}" + "".join(f"[{p!r}]" for p in path)
        for field in ("mu", "nu") for path in paths]
    return treedef + "|" + "|".join(leaves)


_LEAF = re.compile(r"^\[1\]\[0\]\.(count|mu|nu)((?:\['[^']*'\])*)$")


def _parse_leaves(fingerprint: str) -> Optional[List[Tuple[str, str]]]:
    """``[(field, JAX path), ...]`` from a fingerprint's key paths, or
    ``None`` where one is not an Adam leaf."""
    out = []
    for key in fingerprint.split("|")[1:]:
        m = _LEAF.match(key)
        if m is None:
            return None
        out.append((m.group(1), "/".join(re.findall(r"\['([^']*)'\]",
                                                    m.group(2)))))
    return out


def _adam_count(opt: torch.optim.Optimizer) -> int:
    for state in opt.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def save_train_checkpoint(path: str, net: torch.nn.Module,
                          opt: torch.optim.Optimizer, step: int = 0) -> None:
    """Full-state checkpoint: the parameters of ``net``, the state of its
    optimizer ``opt`` (:func:`threepu_torch.train.make_optimizer`) as the
    JAX package's ordered ``opt/<i>`` leaves with their fingerprint, and
    ``step``.  A parameter without state yet stores zero moments, as
    optax's initial state holds."""
    arrays = {PARAM_PREFIX + k: v for k, v in flat_params(net).items()}
    arrays["step"] = np.asarray(step, np.int64)
    by_path = {"/".join(jax_path(n)): p for n, p in net.named_parameters()}
    leaves = [np.asarray(_adam_count(opt), np.int32)]
    for key in ("exp_avg", "exp_avg_sq"):
        for leaf_path in _leaf_paths(net):
            p = by_path["/".join(leaf_path)]
            value = opt.state.get(p, {}).get(key)
            if value is None:
                value = torch.zeros_like(p)
            leaves.append(jax_value(leaf_path[-1], value))
    for i, leaf in enumerate(leaves):
        arrays[f"{OPT_PREFIX}{i:05d}"] = leaf
    arrays[OPT_TREE_KEY] = np.asarray(opt_fingerprint(net))
    _savez(path, arrays)


def load_opt_state(path: str, net: torch.nn.Module,
                   opt: torch.optim.Optimizer
                   ) -> Optional[torch.optim.Optimizer]:
    """Restore into ``opt`` (the optimizer of ``net``) the state a
    full-state checkpoint holds, from either package; returns ``opt``.
    Returns ``None`` (and ``opt`` stays as it was) when the file has no
    optimizer state, and warns too where its fingerprint is not the one
    of ``net``'s optimizer or its leaves do not line up."""
    with np.load(path) as data:
        keys = sorted(k for k in data.files if k.startswith(OPT_PREFIX))
        leaves = [data[k] for k in keys]
        stored_fp = (str(data[OPT_TREE_KEY]) if OPT_TREE_KEY in data
                     else None)
    if not leaves:
        return None
    want_fp = opt_fingerprint(net)
    if stored_fp is not None and stored_fp != want_fp:
        logger.warn(f"optimizer state in {path} was saved with a different "
                    "optimizer configuration; resuming with FRESH optimizer "
                    "state (params/step restore normally)")
        return None
    placed = _parse_leaves(stored_fp or want_fp)
    if placed is None or len(leaves) != len(placed):
        logger.warn(f"optimizer state in {path} has {len(leaves)} leaves, "
                    f"expected {len(placed or ())}; resuming with FRESH "
                    "optimizer state")
        return None
    params = dict(net.named_parameters())
    count, moments = 0, {}
    for (field, jpath), leaf in zip(placed, leaves):
        if field == "count":
            count = int(leaf)
            continue
        name, value = torch_param(*jpath.rsplit("/", 1), leaf)
        if name not in params or value.shape != params[name].shape:
            logger.warn(f"optimizer leaf {field} {jpath} in {path} does not "
                        "fit the model; resuming with FRESH optimizer state")
            return None
        moments.setdefault(name, {})[field] = value
    state = opt.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for group in opt.param_groups for p in group["params"])}
    state["state"] = {
        index[id(params[name])]: {
            "step": torch.tensor(float(count)),
            "exp_avg": m["mu"], "exp_avg_sq": m["nu"]}
        for name, m in moments.items()}
    opt.load_state_dict(state)
    return opt


# ----------------------------------------------------------------- .pth
def _squeezed(shape) -> tuple:
    """A weight's shape without its trailing axes of 1 past the second."""
    shape = tuple(shape)
    while len(shape) > 2 and shape[-1] == 1:
        shape = shape[:-1]
    return shape


def import_pth(path: str, target: Optional[Params] = None
               ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``(state dict, step)`` of a reference ``.pth`` checkpoint, the
    container ``{"states": state_dict, "step": s}`` or a bare state dict;
    a ``module.`` prefix is dropped, and every entry but weights and
    biases.  With ``target`` the restore is partial, as
    :func:`load_checkpoint`'s, and a weight whose shape does not match
    the target's raises ``ValueError`` (trailing axes of 1 aside)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "states" in blob:
        state, step = blob["states"], int(blob.get("step", 0) or 0)
    else:
        state, step = blob, 0
    loaded: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if jax_path(key) is not None:
            loaded[re.sub(r"^module\.", "", key)] = value.detach()
    if target is not None:
        want = _state_dict(target)
        for k, v in loaded.items():
            if k not in want or v.shape == want[k].shape:
                continue
            if not (k.endswith(".weight")
                    and _squeezed(v.shape) == _squeezed(want[k].shape)):
                raise ValueError(
                    f"shape mismatch importing {k}: checkpoint "
                    f"{tuple(v.shape)} vs model {tuple(want[k].shape)}")
            loaded[k] = v.reshape(want[k].shape)
    return _merge(loaded, target), step


def export_reference_state(params: Params, step: int = 0) -> Dict[str, object]:
    """``{"states": {name: numpy array}, "step": str(step)}``: the
    reference-named state dict of ``params`` on the host."""
    states = {name: np.ascontiguousarray(v.detach().cpu().numpy())
              for name, v in _state_dict(params).items()
              if jax_path(name) is not None}
    return {"states": states, "step": str(step)}


def save_pth(path: str, params: Params, step: int = 0,
             label: Optional[str] = None,
             epoch: Optional[int] = None) -> str:
    """Write ``{"states": state_dict, "step": str(step)}`` with
    ``torch.save``; with ``label`` and ``epoch``, ``path`` is a directory
    and the file is ``{label}_{epoch}.pth``.  Returns the path written."""
    blob = export_reference_state(params, step)
    blob["states"] = {k: torch.from_numpy(np.array(v, copy=True))
                      for k, v in blob["states"].items()}
    if label is not None and epoch is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"{label}_{epoch}.pth")
    else:
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
    torch.save(blob, path)
    return path
