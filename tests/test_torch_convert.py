"""The port's converter of the public MODNet, BiSeNet and FAN checkpoints
(monohair_tpu_torch/segment/convert.py and its CLI) against the JAX package's
(monohair_tpu.segment.convert, tools/convert_checkpoints.py), key by key and
array by array, on tests/golden/torch_nets.py's state dicts written in the
public checkpoints' naming."""

import os
import re
import subprocess
import sys

import jax  # noqa: F401  (jax before torch: importing torch first can deadlock)
import numpy as np
import pytest
import torch

from monohair_tpu.segment import convert as jconvert
from monohair_tpu_torch.segment import convert
from monohair_tpu_torch.segment.bisenet import BiSeNet
from monohair_tpu_torch.segment.fan import FAN
from monohair_tpu_torch.segment.modnet import MODNet
from tests.test_torch_annotations import public_names as public_fan

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def golden(name):
    d = np.load(os.path.join(HERE, "golden", name + ".npz"))
    return {k[3:]: d[k] for k in d.files if k.startswith("sd.")}


_MODNET_BLOCK = {0: {"dw.conv": "conv.0", "dw.bn": "conv.1", "pwl": "conv.3",
                     "pwl_bn": "conv.4"}}
_MODNET_BLOCK_N = {"pw.conv": "conv.0", "pw.bn": "conv.1", "dw.conv": "conv.3",
                   "dw.bn": "conv.4", "pwl": "conv.6", "pwl_bn": "conv.7"}


def public_modnet(key):
    """This package's MODNet key in the public checkpoint's naming."""
    m = re.match(r"backbone\.(stem|head)\.(conv|bn)\.(.*)", key)
    if m:
        idx = 0 if m[1] == "stem" else 18
        return f"backbone.model.features.{idx}.{0 if m[2] == 'conv' else 1}.{m[3]}"
    m = re.match(r"backbone\.block(\d+)\.(dw\.conv|dw\.bn|pw\.conv|pw\.bn|pwl_bn|pwl)\.(.*)", key)
    if m:
        b = int(m[1])
        old = _MODNET_BLOCK.get(b, _MODNET_BLOCK_N)[m[2]]
        return f"backbone.model.features.{b + 1}.{old}.{m[3]}"
    key = key.replace("se_block.fc1.", "se_block.fc.0.").replace("se_block.fc2.", "se_block.fc.2.")
    key = re.sub(r"\.(conv_hr4x|conv_hr2x|conv_hr|conv_f)_(\d)\.", r".\1.\2.", key)
    return key.replace(".conv.", ".layers.0.").replace(".ibn.", ".layers.1.")


def public_bisenet(key):
    """This package's BiSeNet key in face-parsing.PyTorch's naming."""
    key = key.replace("cp.resnet.stem.conv.", "cp.resnet.conv1.")
    key = key.replace("cp.resnet.stem.bn.", "cp.resnet.bn1.")
    m = re.match(r"cp\.resnet\.layer(\d)_(\d)\.(.*)", key)
    if m:
        rest = m[3]
        for new, old in (("conv1.conv.", "conv1."), ("conv1.bn.", "bn1."),
                         ("conv2.conv.", "conv2."), ("conv2.bn.", "bn2."),
                         ("down.conv.", "downsample.0."), ("down.bn.", "downsample.1.")):
            if rest.startswith(new):
                rest = old + rest[len(new):]
        return f"cp.resnet.layer{m[1]}.{m[2]}.{rest}"
    return key


def public_sd(name):
    sd = golden(name)
    if name == "fan":      # public_fan adds nn.DataParallel's prefix
        return sd, {k[len("module."):]: v for k, v in public_fan(sd).items()}
    to_public = public_modnet if name == "modnet" else public_bisenet
    return sd, {to_public(k): v for k, v in sd.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("name", ["modnet", "bisenet", "fan"])
def test_renames_and_convert_state_dict_match_jax(name):
    sd, pub = public_sd(name)
    rename, jrename = convert.PUBLIC_RENAMES[name], getattr(jconvert, f"rename_public_{name}")
    assert set(pub) != set(sd)                       # the public naming differs
    for k in pub:
        assert rename(k) == jrename(k), k
    # the public keys map back onto this package's names, every one
    assert {rename(k) for k in pub} == set(sd)
    for r in (rename, None):
        src = pub if r is rename else sd
        got, want = convert.convert_state_dict(src, r), jconvert.convert_state_dict(
            src, jrename if r is rename else None)
        for g, w in zip(got, want):
            g, w = flat(g), flat(w)
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


NETS = {"modnet": lambda: MODNet(width=0.25), "bisenet": lambda: BiSeNet(19, width=0.125),
        "fan": lambda: FAN(num_modules=2, depth=2, width=0.125)}


@pytest.mark.parametrize("name", ["modnet", "bisenet", "fan"])
def test_cli_writes_the_npz_of_tools_convert_checkpoints(name, tmp_path):
    """`python -m monohair_tpu_torch.segment.convert` and
    tools/convert_checkpoints.py on the same public checkpoint (wrapped in a
    DataParallel 'module.' prefix and a state_dict key) write the same arrays
    under the same names, which load into the port's net as the golden's
    weights; --mirror-keys takes the package's own naming."""
    from monohair_tpu_torch.segment.convert import flax_npz_to_state_dict, load_flax_npz
    sd, pub = public_sd(name)
    ckpt = str(tmp_path / "public.ckpt")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(v) for k, v in pub.items()}}, ckpt)
    ref, out = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "convert_checkpoints.py"),
                    "--net", name, "--ckpt", ckpt, "--out", ref], check=True, cwd=REPO,
                   capture_output=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    convert.main(["--net", name, "--ckpt", ckpt, "--out", out])
    a, b = np.load(out), np.load(ref)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    net = load_flax_npz(NETS[name](), out)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    mirror = str(tmp_path / "mirror.ckpt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, mirror)
    convert.main(["--net", name, "--ckpt", mirror, "--out", str(tmp_path / "m.npz"),
                  "--mirror-keys"])
    back = flax_npz_to_state_dict(str(tmp_path / "m.npz"))
    assert set(back) == {k for k in sd if not k.endswith("num_batches_tracked")}
