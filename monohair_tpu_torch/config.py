"""YAML configuration system with ``_parent_`` inheritance and dotted CLI overrides.

Reimplements the behavior of the reference's ``options.py`` (parse_arguments :23-46,
load_options :62-76, override_options :78-95, process_options :97-113,
save_options_file :116-138) without easydict, and without interactive
prompts (unknown keys raise unless ``allow_new=True``; an existing differing
options.yaml is backed up instead of prompting — batch pipelines must not block).

YAML is read and written by the port's own reader and writer of the subset the
configs use (io/yaml_io.py), so the stages and their CLIs run without PyYAML.

Port of monohair_tpu/config.py. Syntax (identical to the reference):
    --key1.key2=value   -> value (YAML-parsed)
    --key1.key2=        -> None
    --key1.key2         -> True
    --key1.key2!        -> False
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from .io.yaml_io import dump_yaml, load_yaml, parse_scalar


class Config(dict):
    """A dict with attribute access, recursively applied (easydict replacement)."""

    def __init__(self, d: Optional[dict] = None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v for v in value)
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out


def parse_arguments(args: List[str]) -> Config:
    """Parse ``--a.b.c=v`` style command-line arguments into a nested Config."""
    opt_cmd: Dict[str, Any] = {}
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"argument must start with '--': {arg!r}")
        if "=" not in arg[2:]:
            key_str, value = (arg[2:-1], "false") if arg.endswith("!") else (arg[2:], "true")
        else:
            key_str, value = arg[2:].split("=", 1)
        keys = key_str.split(".")
        node = opt_cmd
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise ValueError(f"duplicate argument: {key_str}")
        node[keys[-1]] = parse_scalar(value) if value != "" else None
    return Config(opt_cmd)


def load_options(fname: str) -> Config:
    """Load a YAML file, resolving the ``_parent_`` inheritance chain."""
    with open(fname) as f:
        opt = Config(load_yaml(f.read()) or {})
    if "_parent_" in opt:
        parent_fnames = opt.pop("_parent_")
        if isinstance(parent_fnames, str):
            parent_fnames = [parent_fnames]
        for parent_fname in parent_fnames:
            # Parents are resolved relative to the child file's directory first,
            # then the CWD (the reference resolves only from CWD).
            cand = os.path.join(os.path.dirname(fname), parent_fname)
            parent = load_options(cand if os.path.exists(cand) else parent_fname)
            opt = override_options(parent, opt, allow_new=True)
    return opt


def override_options(opt: Config, opt_over: dict, key_stack: Optional[list] = None,
                     allow_new: bool = True) -> Config:
    """Recursively apply ``opt_over`` on top of ``opt``.

    With ``allow_new=False``, a key absent from ``opt`` raises KeyError (the
    reference prompts interactively; we fail fast instead).
    """
    key_stack = key_stack or []
    for key, value in opt_over.items():
        if isinstance(value, dict):
            child = opt.get(key)
            opt[key] = override_options(child if isinstance(child, dict) else Config(),
                                        value, key_stack + [key], allow_new)
        else:
            if not allow_new and key not in opt:
                raise KeyError("unknown config key: " + ".".join(key_stack + [key]))
            opt[key] = value
    return opt


def process_options(opt: Config) -> None:
    """Seed RNGs and resolve the device string (reference options.py:97-113)."""
    seed = opt.get("seed")
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        if seed != 0:
            opt["name"] = f"{opt.get('name', 'run')}_seed{seed}"
    # The stages take their device as an argument; this records the default.
    opt.setdefault("device", "cuda")


def set_options(opt_cmd: Optional[Config] = None, yaml_path: Optional[str] = None,
                allow_new: bool = True) -> Config:
    """Build the final config: YAML(+parents) overridden by CLI arguments.

    Mirror of the reference's ``options.set`` (options.py:48-60).
    """
    opt_cmd = opt_cmd or Config()
    if yaml_path is None:
        if "yaml" not in opt_cmd:
            raise ValueError("config requires --yaml=<path-without-extension>")
        yaml_path = f"{opt_cmd['yaml']}.yaml"
    opt = load_options(yaml_path)
    opt = override_options(opt, opt_cmd, key_stack=[], allow_new=allow_new)
    process_options(opt)
    return opt


def save_options_file(opt: Config, output_path: Optional[str] = None) -> str:
    """Persist the resolved options; back up an existing, differing snapshot.

    (The reference diffs and prompts, options.py:116-138; we keep a .bak copy.)
    """
    output_path = output_path or opt["output_path"]
    os.makedirs(output_path, exist_ok=True)
    opt_fname = os.path.join(output_path, "options.yaml")
    new_contents = dump_yaml(opt.to_dict() if isinstance(opt, Config) else dict(opt))
    if os.path.isfile(opt_fname):
        with open(opt_fname) as f:
            old_contents = f.read()
        if old_contents != new_contents:
            shutil.copyfile(opt_fname, opt_fname + ".bak")
    with open(opt_fname, "w") as f:
        f.write(new_contents)
    return opt_fname
