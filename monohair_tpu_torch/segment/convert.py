"""Load the JAX package's flax checkpoints into the torch segmentation and
landmark nets, and write a net's weights as such a checkpoint.

The shipped hair-parser weights (``trained/hair_parser/{modnet,bisenet}.npz``)
are flattened flax trees: ``params/<path>/<leaf>`` and
``batch_stats/<path>/{mean,var}``. Because every torch submodule carries its
flax name, the conversion is the inverse of monohair_tpu/segment/convert.py:

    params/X/kernel (4D, HWIO)     -> X.weight, OIHW
    params/X/kernel (2D, in x out) -> X.weight, (out, in)  (Dense -> Linear)
    params/X/scale                 -> X.weight  (BatchNorm, IBNorm halves)
    params/X/bias                  -> X.bias
    batch_stats/X/mean, .../var    -> X.running_mean, X.running_var

A public torch checkpoint whose module names differ (face_alignment's FAN)
loads through ``load_renamed_state_dict`` with a rename hook, as the JAX
package's converter takes it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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


def save_flax_npz(net: nn.Module, path: str) -> None:
    """Write `net`'s parameters and running stats as a flattened flax tree
    (.npz), the layout the JAX package's runners and flax_npz_to_state_dict
    read: the inverse of the table above."""
    flat = {}
    for key, v in net.state_dict().items():
        base, leaf = key.rsplit(".", 1)
        path_ = base.replace(".", "/")
        v = v.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            flat[f"batch_stats/{path_}/{leaf[len('running_'):]}"] = v
        elif leaf == "bias":
            flat[f"params/{path_}/bias"] = v
        elif leaf == "weight" and v.ndim == 4:
            flat[f"params/{path_}/kernel"] = np.transpose(v, (2, 3, 1, 0))
        elif leaf == "weight" and v.ndim == 2:
            flat[f"params/{path_}/kernel"] = v.T
        elif leaf == "weight":
            flat[f"params/{path_}/scale"] = v
        else:
            raise KeyError(f"unhandled torch key {key}")
    np.savez(path, **flat)


def rename_public_fan(key: str) -> Optional[str]:
    """face_alignment FAN keys -> this package's names (the ConvBlock's
    downsample Sequential is the only difference)."""
    return key.replace("downsample.0.", "down_bn.").replace("downsample.2.", "down_conv.")


def load_renamed_state_dict(net: nn.Module, sd: Dict[str, np.ndarray],
                            rename: Optional[Callable[[str], Optional[str]]] = None
                            ) -> nn.Module:
    """Load a torch state dict of another module naming into `net`: a
    'module.' prefix (nn.DataParallel) is stripped, `rename` maps each key (None
    drops it), and every parameter and running stat must be there. Eval mode."""
    clean = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        k = rename(k) if rename is not None else k
        if k is not None:
            clean[k] = torch.as_tensor(np.asarray(v))
    missing, unexpected = net.load_state_dict(clean, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    return net.eval()
