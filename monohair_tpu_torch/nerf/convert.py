"""The JAX package's flax NeRF variables (as numpy) <-> the port's state dicts.

flax's Dense kernel is (in, out) and torch's Linear weight (out, in), so
kernels are transposed; tables and grids keep their layout. flax names a
list member ``trunk_0`` where torch says ``trunk.0``, and the dense grids
``grid0`` where torch says ``grids.0``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

KINDS = ("fourier", "ngp", "dense")


def _module_name(kind: str, name: str) -> str:
    if kind == "fourier":
        return re.sub(r"^trunk_(\d+)$", r"trunk.\1", name)
    if kind == "dense":
        return re.sub(r"^grid(\d+)$", r"grids.\1", name)
    return name


def field_state_from_flax(kind: str, variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": {...}} of a FourierField ("fourier"), NGPField ("ngp") or
    DenseGridField ("dense") -> a state dict of the port's field of the same
    kind and widths (float32 tensors on the CPU)."""
    if kind not in KINDS:
        raise ValueError(f"unknown field kind {kind!r} (one of {KINDS})")
    state = {}
    for name, leaf in variables["params"].items():
        key = _module_name(kind, name)
        if isinstance(leaf, Mapping):
            kernel = np.asarray(leaf["kernel"], np.float32)
            state[key + ".weight"] = torch.from_numpy(kernel.T.copy())
            if "bias" in leaf:
                state[key + ".bias"] = torch.from_numpy(np.asarray(leaf["bias"], np.float32).copy())
        else:
            state[key] = torch.from_numpy(np.asarray(leaf, np.float32).copy())
    return state


def field_kind(field: torch.nn.Module) -> str:
    """"fourier", "ngp" or "dense" by the port's field class."""
    kinds = {"FourierField": "fourier", "NGPField": "ngp", "DenseGridField": "dense"}
    name = type(field).__name__
    if name not in kinds:
        raise ValueError(f"not a NeRF field of the port: {name}")
    return kinds[name]


def flax_from_field(field: torch.nn.Module) -> Dict[str, dict]:
    """A port field's parameters -> {"params": {...}} as the JAX package's
    field of the same kind holds them (numpy; field_state_from_flax's inverse)."""
    kind = field_kind(field)
    inverse = {"fourier": (r"^trunk\.(\d+)$", r"trunk_\1"), "dense": (r"^grids\.(\d+)$", r"grid\1")}
    params: Dict[str, object] = {}
    for key, p in field.named_parameters():
        v = p.detach().cpu().numpy()
        module, _, leaf = key.rpartition(".")
        if leaf in ("weight", "bias") and module:
            if kind in inverse:
                module = re.sub(*inverse[kind], module)
            params.setdefault(module, {})["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(v.T) if leaf == "weight" else v)
        else:
            if kind in inverse:
                key = re.sub(*inverse[kind], key)
            params[key] = v
    return {"params": params}
