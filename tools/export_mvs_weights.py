#!/usr/bin/env python
"""Write the DeepMVSHair nets' orbax trees as ``.npz`` state dicts that the
PyTorch port loads (it reads no orbax).

    python tools/export_mvs_weights.py                        # trained/mvs/{occ,ori}
    python tools/export_mvs_weights.py path/to/occ path/to/ori

Each tree <dir> (as train_mvs.py saves it) becomes <dir>.npz beside it: its
`params` and `batch_stats` in the reference's torch naming
(monohair_tpu_torch.models.convert.state_dict_from_flax), f32 and compressed;
the optimizer state and step are left out. A tree whose directory name is `occ`
is the occupancy net (head `occ_vit`), any other the orientation net (`vit`).

The trees are restored with numpy restore arguments for every leaf: restoring
them without a target, as monohair_tpu.checkpoint.load_pytree does, fails in a
process without the devices they were saved from ("sharding passed to
deserialization should be specified"). Needs JAX and orbax; run it where the
JAX package runs.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def restore_tree(path: str) -> dict:
    """The orbax tree at `path` as numpy arrays, on any host."""
    import jax
    import orbax.checkpoint as ocp
    ckptr = ocp.PyTreeCheckpointer()
    path = os.path.abspath(path)
    meta = ckptr.metadata(path).item_metadata.tree
    args = jax.tree_util.tree_map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
    return ckptr.restore(path, restore_args=args)


def export(path: str) -> str:
    from monohair_tpu_torch.models.convert import state_dict_from_flax
    tree = restore_tree(path)
    prefix = "occ_vit" if os.path.basename(path.rstrip("/")) == "occ" else "vit"
    sd = state_dict_from_flax(tree["params"], tree["batch_stats"], prefix)
    out = path.rstrip("/") + ".npz"
    np.savez_compressed(out, **sd)
    count = sum(v.size for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    print(f"{path} -> {out}: {len(sd)} arrays, {count} values, head {prefix}")
    return out


def main(argv):
    paths = argv or [os.path.join(REPO, "trained/mvs/occ"), os.path.join(REPO, "trained/mvs/ori")]
    for p in paths:
        export(p)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
