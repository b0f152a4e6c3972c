"""Load the JAX package's flax checkpoints into the torch segmentation nets.

The shipped hair-parser weights (``trained/hair_parser/{modnet,bisenet}.npz``)
are flattened flax trees: ``params/<path>/<leaf>`` and
``batch_stats/<path>/{mean,var}``. Because every torch submodule carries its
flax name, the conversion is the inverse of monohair_tpu/segment/convert.py:

    params/X/kernel (4D, HWIO)     -> X.weight, OIHW
    params/X/kernel (2D, in x out) -> X.weight, (out, in)  (Dense -> Linear)
    params/X/scale                 -> X.weight  (BatchNorm, IBNorm halves)
    params/X/bias                  -> X.bias
    batch_stats/X/mean, .../var    -> X.running_mean, X.running_var
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def flax_npz_to_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A flattened flax tree (.npz) -> a torch state dict in the same names."""
    d = np.load(path)
    sd = {}
    for key in d.files:
        kind, *parts = key.split("/")
        base, leaf = ".".join(parts[:-1]), parts[-1]
        v = np.asarray(d[key], np.float32)
        if kind == "params":
            if leaf == "kernel" and v.ndim == 4:
                sd[base + ".weight"] = np.transpose(v, (3, 2, 0, 1))
            elif leaf == "kernel" and v.ndim == 2:
                sd[base + ".weight"] = v.T
            elif leaf == "scale":
                sd[base + ".weight"] = v
            elif leaf == "bias":
                sd[base + ".bias"] = v
            else:
                raise KeyError(f"{path}: unhandled flax leaf {key}")
        elif kind == "batch_stats":
            if leaf not in ("mean", "var"):
                raise KeyError(f"{path}: unhandled flax leaf {key}")
            sd[f"{base}.running_{leaf}"] = v
        else:
            raise KeyError(f"{path}: unhandled flax collection {key}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_flax_npz(net: nn.Module, path: str) -> nn.Module:
    """Load a flax tree into `net` (every parameter and running stat must be
    in the tree; BatchNorm's num_batches_tracked is not) and set eval mode."""
    sd = flax_npz_to_state_dict(path)
    missing, unexpected = net.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return net.eval()
