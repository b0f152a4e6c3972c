"""Load the JAX package's flax checkpoints into the torch segmentation and
landmark nets, write a net's or a torch checkpoint's weights as such a
checkpoint, and convert the public MODNet, BiSeNet and FAN checkpoints
(port of monohair_tpu/segment/convert.py and tools/convert_checkpoints.py):

    python -m monohair_tpu_torch.segment.convert --net {modnet,bisenet,fan} \
        --ckpt <torch checkpoint> --out <flax .npz> [--mirror-keys]

The shipped hair-parser weights (``trained/hair_parser/{modnet,bisenet}.npz``)
are flattened flax trees: ``params/<path>/<leaf>`` and
``batch_stats/<path>/{mean,var}``. Because every torch submodule carries its
flax name, the conversion is the inverse of monohair_tpu/segment/convert.py:

    params/X/kernel (4D, HWIO)     -> X.weight, OIHW
    params/X/kernel (2D, in x out) -> X.weight, (out, in)  (Dense -> Linear)
    params/X/scale                 -> X.weight  (BatchNorm, IBNorm halves)
    params/X/bias                  -> X.bias
    batch_stats/X/mean, .../var    -> X.running_mean, X.running_var

A public torch checkpoint whose module names differ (MODNet's, BiSeNet's
face-parsing.PyTorch and face_alignment's FAN) loads through
``load_renamed_state_dict`` with a rename hook, or is written as a flax tree
through ``save_flax_npz`` with one, as the JAX package's converter takes it.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

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


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.asarray(value)


def convert_state_dict(sd: Mapping[str, np.ndarray],
                       rename: Optional[Callable[[str], Optional[str]]] = None
                       ) -> Tuple[dict, dict]:
    """A torch state dict (numpy values) -> flax (params, batch_stats) trees,
    the inverse of the table above: a 'module.' prefix (nn.DataParallel) is
    stripped, `rename` maps each key (None drops it), num_batches_tracked goes."""
    params: dict = {}
    stats: dict = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        k = rename(k) if rename is not None else k
        if k is None or k.endswith("num_batches_tracked"):
            continue
        v = np.asarray(v)
        base, leaf = k.rsplit(".", 1)
        if leaf == "weight" and v.ndim == 4:
            _set(params, base + ".kernel", np.transpose(v, (2, 3, 1, 0)))
        elif leaf == "weight" and v.ndim == 2:
            _set(params, base + ".kernel", np.transpose(v))
        elif leaf == "weight":
            _set(params, base + ".scale", v)
        elif leaf == "bias":
            _set(params, base + ".bias", v)
        elif leaf == "running_mean":
            _set(stats, base + ".mean", v)
        elif leaf == "running_var":
            _set(stats, base + ".var", v)
        else:
            raise KeyError(f"unhandled torch key: {k}")
    return params, stats


def save_flax_npz(net: Union[nn.Module, Mapping[str, np.ndarray]], path: str,
                  rename: Optional[Callable[[str], Optional[str]]] = None) -> None:
    """Write `net`'s parameters and running stats (or those of a torch state
    dict, keys mapped by `rename`) as a flattened flax tree (.npz), the
    layout the JAX package's runners and flax_npz_to_state_dict read."""
    sd = net.state_dict() if isinstance(net, nn.Module) else net
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
          for k, v in sd.items()}
    flat = {}

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                flat[f"{prefix}/{k}"] = v

    params, stats = convert_state_dict(sd, rename)
    walk(params, "params")
    walk(stats, "batch_stats")
    np.savez(path, **flat)


def rename_public_modnet(key: str) -> Optional[str]:
    """The public MODNet checkpoint's keys
    (modnet_photographic_portrait_matting.ckpt: backbone.model.features.N,
    Conv2dIBNormRelu 'layers' Sequentials, Sequential decoder stacks) -> this
    package's module names, as the JAX package maps them."""
    k = key
    if ".layers.0." in k:
        k = k.replace(".layers.0.", ".conv.")
    if ".layers.1." in k:
        k = k.replace(".layers.1.", ".ibn.")
    for seq in ("conv_hr4x", "conv_hr2x", "conv_hr", "conv_f"):
        for i in range(4):
            k = k.replace(f".{seq}.{i}.", f".{seq}_{i}.")
    k = k.replace("se_block.fc.0.", "se_block.fc1.")
    k = k.replace("se_block.fc.2.", "se_block.fc2.")
    if k.startswith("backbone.model.features."):
        rest = k[len("backbone.model.features."):]
        idx_s, sub = rest.split(".", 1)
        idx = int(idx_s)
        if idx in (0, 18):
            sub = sub.replace("0.", "conv.", 1).replace("1.", "bn.", 1)
            return f"backbone.{'stem' if idx == 0 else 'head'}.{sub}"
        block = idx - 1
        # InvertedResidual.conv Sequential indices -> named children
        if block == 0:  # expand == 1: dw (0, 1), pwl (3), pwl_bn (4)
            table = {"conv.0": "dw.conv", "conv.1": "dw.bn", "conv.3": "pwl",
                     "conv.4": "pwl_bn"}
        else:
            table = {"conv.0": "pw.conv", "conv.1": "pw.bn", "conv.3": "dw.conv",
                     "conv.4": "dw.bn", "conv.6": "pwl", "conv.7": "pwl_bn"}
        for old, new in table.items():
            if sub.startswith(old + "."):
                return f"backbone.block{block}.{new}.{sub[len(old) + 1:]}"
        return f"backbone.block{block}.{sub}"
    return k


def rename_public_bisenet(key: str) -> Optional[str]:
    """face-parsing.PyTorch BiSeNet keys -> this package's names (only the
    ResNet's stem and layer naming differs)."""
    k = key.replace("cp.resnet.conv1.", "cp.resnet.stem.conv.")
    k = k.replace("cp.resnet.bn1.", "cp.resnet.stem.bn.")
    for li in range(1, 5):
        for bi in range(2):
            p = f"cp.resnet.layer{li}.{bi}."
            if k.startswith(p):
                rest = k[len(p):]
                for old, new in (("conv1.", "conv1.conv."), ("bn1.", "conv1.bn."),
                                 ("conv2.", "conv2.conv."), ("bn2.", "conv2.bn.")):
                    if rest.startswith(old):
                        rest = new + rest[len(old):]
                        break
                rest = rest.replace("downsample.0.", "down.conv.", 1)
                rest = rest.replace("downsample.1.", "down.bn.", 1)
                return f"cp.resnet.layer{li}_{bi}.{rest}"
    return k


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


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth/.ckpt as a numpy state dict (the first of model_state_dict,
    state_dict and model when the file wraps one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


PUBLIC_RENAMES = {"modnet": rename_public_modnet, "bisenet": rename_public_bisenet,
                  "fan": rename_public_fan}


def main(argv: Optional[List[str]] = None) -> str:
    """The segmentation and annotation half of tools/convert_checkpoints.py,
    with its flags; its .npz loads in both packages' runners."""
    ap = argparse.ArgumentParser(prog="python -m monohair_tpu_torch.segment.convert")
    ap.add_argument("--net", required=True, choices=sorted(PUBLIC_RENAMES))
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mirror-keys", action="store_true",
                    help="the checkpoint already uses this package's module names; "
                         "skip the public-key renames")
    args = ap.parse_args(argv)
    sd = load_torch_checkpoint(args.ckpt)
    save_flax_npz(sd, args.out, None if args.mirror_keys else PUBLIC_RENAMES[args.net])
    n = sum(v.size for v in np.load(args.out).values())
    print(f"wrote {args.out}: {n:,} parameters")
    return args.out


if __name__ == "__main__":
    main()
