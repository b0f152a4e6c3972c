"""Checkpoint and resume of the MVS nets' training (the port's counterpart of
monohair_tpu/checkpoint.py's save_pytree/load_pytree, which write orbax trees).

A run's output directory holds, for kind = occ or ori:
- `<kind>.npz`: the net's state dict under the reference's torch names,
  BatchNorm buffers included, so infer_inner's `load_net` (and `weights_path`,
  for an `mvs.<kind>_model_path` that names the tree's directory `<kind>`)
  loads it as it is;
- `<kind>_train.npz`: Adam's moments `mu/<name>` and `nu/<name>`, its
  `count`, and the trainer's `step`.
Each is written to a temporary file beside it, then moved over it
(os.replace), so a run cut mid-write leaves the previous checkpoint whole.
NeRF snapshots (`save_nerf_snapshot`/`load_nerf_snapshot`, the .ingp
equivalent) are one compressed .npz in the JAX package's layout: the flax
tree's leaves as `param_<i>` in jax.tree_util's flatten order (dict keys
sorted), its treedef's string and the config's items, so a snapshot written
by either package loads in the other.
"""

from __future__ import annotations

import os
import tempfile
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from .models.convert import load_weights, read_state_dict
from .nerf.convert import field_kind, field_state_from_flax, flax_from_field
from .mvs.train import load_adam_state


def save_npz_atomic(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    """np.savez of `arrays` to `path` through a temporary file and os.replace."""
    folder = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tmp_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def weights_file(out: str, kind: str) -> str:
    return os.path.join(out, f"{kind}.npz")


def train_file(out: str, kind: str) -> str:
    return os.path.join(out, f"{kind}_train.npz")


def save_train_state(out: str, kind: str, state) -> None:
    """Write `<out>/<kind>.npz` and `<out>/<kind>_train.npz` of a
    `mvs.train.TrainState`."""
    os.makedirs(out, exist_ok=True)
    save_npz_atomic(weights_file(out, kind), OrderedDict(
        (k, _numpy(v)) for k, v in state.model.state_dict().items()))
    names = state.param_names()
    arrays: Dict[str, np.ndarray] = OrderedDict()
    for key, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        for name, m in zip(names, moments):
            arrays[f"{key}/{name}"] = _numpy(m)
    arrays["count"] = np.asarray(state.opt.count, np.int64)
    arrays["step"] = np.asarray(state.step, np.int64)
    save_npz_atomic(train_file(out, kind), arrays)


def has_train_state(out: str, kind: str) -> bool:
    """Whether `out` holds a whole checkpoint of `kind`; one file without the
    other raises."""
    found = [os.path.exists(p) for p in (weights_file(out, kind), train_file(out, kind))]
    if any(found) and not all(found):
        raise FileNotFoundError(f"{out} holds only one of {kind}.npz and {kind}_train.npz")
    return all(found)


def load_train_state(out: str, kind: str, state) -> None:
    """Restore a `mvs.train.TrainState` in place from `out`: the weights and
    BatchNorm statistics, Adam's moments and count, and the step."""
    load_weights(state.model, read_state_dict(weights_file(out, kind)))
    with np.load(train_file(out, kind)) as data:
        moments = {key: {name: data[f"{key}/{name}"] for name in state.param_names()}
                   for key in ("mu", "nu")}
        load_adam_state(state, moments["mu"], moments["nu"], int(data["count"]))
        state.step = int(data["step"])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict in jax.tree_util's order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flatten(v, prefix + (k,)) if isinstance(v, Mapping) else [(prefix + (k,), v)]
    return out


def _treedef_str(tree: Mapping) -> str:
    """str() of the tree's jax PyTreeDef, e.g. "PyTreeDef({'a': *})"."""
    def walk(node):
        if not isinstance(node, Mapping):
            return "*"
        return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
    return f"PyTreeDef({walk(tree)})"


def save_nerf_snapshot(path: str, field: torch.nn.Module, config: dict) -> None:
    """A port NeRF field and its config -> a snapshot the JAX package's
    load_nerf_snapshot reads (run.py:121-127's .ingp, as one npz)."""
    tree = flax_from_field(field)
    arrays = {f"param_{i}": leaf for i, (_, leaf) in enumerate(_flatten(tree))}
    np.savez_compressed(path, __treedef__=_treedef_str(tree),
                        __config__=np.asarray(list(config.items()), dtype=object), **arrays)


def load_nerf_snapshot(path: str, field: torch.nn.Module) -> torch.nn.Module:
    """Load a snapshot (of either package) into a port field of the same kind
    and widths; returns the field."""
    with np.load(path, allow_pickle=True) as data:
        paths = [p for p, _ in _flatten(flax_from_field(field))]
        tree: Dict[str, Any] = {}
        for i, keys in enumerate(paths):
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[f"param_{i}"]
    dev = next(field.parameters()).device
    state = field_state_from_flax(field_kind(field), tree)
    missing, unexpected = field.load_state_dict({k: v.to(dev) for k, v in state.items()},
                                                strict=False)
    missing = [k for k, _ in field.named_parameters() if k in missing]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return field
