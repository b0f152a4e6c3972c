"""The port reads and writes its configs without PyYAML: its YAML subset
against yaml.safe_load and yaml.safe_dump."""

import glob
import os

import pytest
import yaml

from monohair_tpu_torch.io.yaml_io import dump_yaml, load_yaml, parse_scalar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_read_and_write_as_pyyaml_does(path):
    text = open(path).read()
    ref = yaml.safe_load(text)
    assert load_yaml(text) == ref
    written = dump_yaml(ref)
    assert written == yaml.safe_dump(ref, default_flow_style=False, indent=4)
    assert load_yaml(written) == ref


@pytest.mark.parametrize("text", [
    "0.1", "-1.644", "1.0e-05", "1e-3", "5", "+3", "0", "1_000", ".inf", "-.inf",
    "true", "False", "yes", "Off", "null", "~", "x", "a b", "configs/reconstruct/synthwig",
    "[1920, 1080]", "[0.92,0.92, 0.92]", "[]", "'it''s'", '"a\\tb"', "x # note"])
def test_cli_values_read_as_pyyaml_does(text):
    assert parse_scalar(text) == yaml.safe_load(text)


def test_written_values_read_back_by_both():
    d = {"a": {"s": "x: y", "t": "yes", "u": "", "w": "1.5", "v": 1e-5, "n": None},
         "b": [1.0, -0.32, "q r"], "c": {}, "e": [], "f": "it's"}
    text = dump_yaml(d)
    assert yaml.safe_load(text) == d
    assert load_yaml(text) == d


@pytest.mark.parametrize("text", ["a: &x 1", "a: {b: 1}", "a: 0x1f", "---\na: 1",
                                  "a:\n- - 1", "a: 012", "a: |\n  text", "a: 1\n  b: 2"])
def test_constructs_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        load_yaml(text)
