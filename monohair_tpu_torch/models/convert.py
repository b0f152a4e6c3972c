"""Weights of the DeepMVSHair nets between the JAX package's flax trees and the
reference's torch naming (the inverse of monohair_tpu/models/convert.py
`convert_pifu_checkpoint`), and their loading into the port's modules.

The port's modules carry the reference's state_dict names
(pifu_attn.py / UnetSimple.py / ViT.py module paths), so a DeepMVSHair ``.pth``
loads as it is, and a flax tree loads after `state_dict_from_flax`:

    backbone/inc/{conv0,bn0,conv1,bn1}     -> backbone.inc.double_conv.{0,1,3,4}
    backbone/downK/...                     -> backbone.downK.maxpool_conv.1.double_conv...
    backbone/upK_up, upK_conv/...          -> backbone.upK.up, backbone.upK.conv.double_conv...
    vit/blockD/{norm1,attn/...}            -> <vit>.transformer.layers.D.0.fn.{norm,fn....}
    vit/blockD/{norm2,ff1,ff2}             -> <vit>.transformer.layers.D.1.fn.{norm,fn.net.0,fn.net.3}
    vit/{head_norm,head1,head2,head_out}   -> <vit>.mlp_head.{0,1,3,5}

Layouts: flax Conv HWIO -> torch OIHW; Dense (in, out) -> Linear (out, in);
the JAX package's ConvTranspose kernel is the torch (in, out, kh, kw) kernel
flipped spatially and stored (kh, kw, in, out), so both are undone here.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _conv_t(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _lin(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k))


def _double_conv(sd: dict, params: Mapping, stats: Mapping, prefix: str) -> None:
    for i, torch_i in ((0, 0), (1, 3)):
        conv, bn = params[f"conv{i}"], params[f"bn{i}"]
        sd[f"{prefix}.{torch_i}.weight"] = _conv(conv["kernel"])
        sd[f"{prefix}.{torch_i}.bias"] = np.asarray(conv["bias"])
        b = f"{prefix}.{torch_i + 1}"
        sd[f"{b}.weight"] = np.asarray(bn["scale"])
        sd[f"{b}.bias"] = np.asarray(bn["bias"])
        sd[f"{b}.running_mean"] = np.asarray(stats[f"bn{i}"]["mean"])
        sd[f"{b}.running_var"] = np.asarray(stats[f"bn{i}"]["var"])
        sd[f"{b}.num_batches_tracked"] = np.zeros((), np.int64)


def state_dict_from_flax(params: Mapping, batch_stats: Mapping, vit_prefix: str
                         ) -> Dict[str, np.ndarray]:
    """A flax OccAttn/OriAttn (params, batch_stats) tree of numpy arrays -> a
    state dict in the reference's torch naming. vit_prefix: 'occ_vit' for the
    occupancy net, 'vit' for the orientation net (pifu_attn.py:176,288)."""
    sd: Dict[str, np.ndarray] = OrderedDict()
    bb, bs = params["backbone"], batch_stats["backbone"]
    _double_conv(sd, bb["inc"], bs["inc"], "backbone.inc.double_conv")
    for k in (1, 2, 3):
        _double_conv(sd, bb[f"down{k}"], bs[f"down{k}"],
                     f"backbone.down{k}.maxpool_conv.1.double_conv")
    for k in (1, 2, 3):
        up = bb[f"up{k}_up"]
        sd[f"backbone.up{k}.up.weight"] = _conv_t(up["kernel"])
        sd[f"backbone.up{k}.up.bias"] = np.asarray(up["bias"])
        _double_conv(sd, bb[f"up{k}_conv"], bs[f"up{k}_conv"],
                     f"backbone.up{k}.conv.double_conv")

    v, p = params["vit"], vit_prefix
    sd[f"{p}.view_fuse_pt.weight"] = _lin(v["view_fuse_pt"]["kernel"])
    sd[f"{p}.view_fuse_pt.bias"] = np.asarray(v["view_fuse_pt"]["bias"])
    sd[f"{p}.cls_token"] = np.asarray(v["cls_token"])
    sd[f"{p}.cls_fuse_pt.weight"] = _lin(v["cls_fuse_pt"]["kernel"])
    sd[f"{p}.cls_fuse_pt.bias"] = np.asarray(v["cls_fuse_pt"]["bias"])
    sd[f"{p}.pos_embedding"] = np.asarray(v["pos_embedding"])
    d = 0
    while f"block{d}" in v:
        blk, base = v[f"block{d}"], f"{p}.transformer.layers.{d}"
        attn = blk["attn"]
        sd[f"{base}.0.fn.norm.weight"] = np.asarray(blk["norm1"]["scale"])
        sd[f"{base}.0.fn.norm.bias"] = np.asarray(blk["norm1"]["bias"])
        sd[f"{base}.0.fn.fn.to_qkv.weight"] = _lin(attn["to_qkv"]["kernel"])
        sd[f"{base}.0.fn.fn.reattn_weights"] = np.asarray(attn["reattn_weights"])
        sd[f"{base}.0.fn.fn.reattn_norm.1.weight"] = np.asarray(attn["reattn_norm"]["scale"])
        sd[f"{base}.0.fn.fn.reattn_norm.1.bias"] = np.asarray(attn["reattn_norm"]["bias"])
        sd[f"{base}.0.fn.fn.to_out.0.weight"] = _lin(attn["to_out"]["kernel"])
        sd[f"{base}.0.fn.fn.to_out.0.bias"] = np.asarray(attn["to_out"]["bias"])
        sd[f"{base}.1.fn.norm.weight"] = np.asarray(blk["norm2"]["scale"])
        sd[f"{base}.1.fn.norm.bias"] = np.asarray(blk["norm2"]["bias"])
        sd[f"{base}.1.fn.fn.net.0.weight"] = _lin(blk["ff1"]["kernel"])
        sd[f"{base}.1.fn.fn.net.0.bias"] = np.asarray(blk["ff1"]["bias"])
        sd[f"{base}.1.fn.fn.net.3.weight"] = _lin(blk["ff2"]["kernel"])
        sd[f"{base}.1.fn.fn.net.3.bias"] = np.asarray(blk["ff2"]["bias"])
        d += 1
    sd[f"{p}.mlp_head.0.weight"] = np.asarray(v["head_norm"]["scale"])
    sd[f"{p}.mlp_head.0.bias"] = np.asarray(v["head_norm"]["bias"])
    for name, idx in (("head1", 1), ("head2", 3), ("head_out", 5)):
        sd[f"{p}.mlp_head.{idx}.weight"] = _lin(v[name]["kernel"])
        sd[f"{p}.mlp_head.{idx}.bias"] = np.asarray(v[name]["bias"])
    return sd


def shallow_encoder_state_from_flax(params: Mapping, batch_stats: Mapping
                                    ) -> Dict[str, np.ndarray]:
    """A flax ShallowEncoder (params, batch_stats) tree -> the port's
    ShallowEncoder state dict (the UNet encoder's names and layouts)."""
    sd: Dict[str, np.ndarray] = OrderedDict()
    _double_conv(sd, params["inc"], batch_stats["inc"], "inc.double_conv")
    for k in (1, 2):
        _double_conv(sd, params[f"down{k}"], batch_stats[f"down{k}"],
                     f"down{k}.maxpool_conv.1.double_conv")
    return sd


def adam_state_from_flax(opt_state, batch_stats: Mapping, vit_prefix: str,
                         param_names) -> dict:
    """optax.adam's state of a flax OccAttn/OriAttn (numpy leaves) -> the
    moments in the reference's torch naming, as `OptaxAdam` holds them:
    {"mu": {name: array}, "nu": {name: array}, "count": int} over
    `param_names` (the net's parameters, not its BatchNorm buffers). The
    moments have the parameters' tree, so they take the parameters' layout
    changes."""
    adam = next(s for s in opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    moments = {}
    for key in ("mu", "nu"):
        sd = state_dict_from_flax(getattr(adam, key), batch_stats, vit_prefix)
        moments[key] = OrderedDict((name, sd[name]) for name in param_names)
    return dict(moments, count=int(np.asarray(adam.count)))


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A weights file in the reference's naming -> CPU tensors: a ``.npz`` (as
    tools/export_mvs_weights.py writes) or a torch ``.pth`` (its
    'model_state_dict', mvs_eval.py:68, or the bare state dict)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return OrderedDict((k, torch.from_numpy(data[k])) for k in data.files)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    return OrderedDict((k, v.detach().cpu()) for k, v in sd.items())


def load_weights(model: torch.nn.Module, state_dict: Mapping) -> torch.nn.Module:
    """Load a reference-named state dict (numpy arrays or tensors) into one of
    the port's nets, strictly: every key present, every shape equal."""
    sd = {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


def weights_path(path: str) -> str:
    """The file that holds the weights of a configured model path: the path
    itself for a file; for an orbax tree (a directory, as the JAX package's
    train_mvs.py writes them) the ``.npz`` beside it, which
    tools/export_mvs_weights.py writes, as does the port's train_mvs (without
    the directory). A path that is neither, and has no ``.npz`` beside it,
    comes back as it is."""
    if os.path.isfile(path):
        return path
    npz = path.rstrip("/") + ".npz"
    if os.path.exists(npz):
        return npz
    if os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is an orbax tree, which the PyTorch port does not read; "
            f"write {npz} from it with `python tools/export_mvs_weights.py "
            f"{path}` (that tool needs JAX and orbax)")
    return path
