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
The NeRF's snapshots are not here: the port's NeRF writes its own
(nerf/pipeline.py).
"""

from __future__ import annotations

import os
import tempfile
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

from .models.convert import load_weights, read_state_dict
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
