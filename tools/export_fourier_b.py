#!/usr/bin/env python
"""Write the Fourier field's fixed frequency draw as a constant file that the
PyTorch port loads (it cannot import JAX).

    python tools/export_fourier_b.py        # monohair_tpu_torch/nerf/fourier_b.npy

The JAX package's FourierField draws its frequency matrix in setup as
jax.random.normal(PRNGKey(11), (3, num_features)) * freq_scale
(monohair_tpu/nerf/fourier.py). With jax_threefry_partitionable on (the
default since JAX 0.5), the bits of each element depend only on its flat
index, so the (3, F) draw is the first 3 * F values of one flat draw. The file
holds that flat draw, unscaled, for F up to MAX_FEATURES, and records the JAX
version and setting that wrote it; tests/test_torch_nerf_fields.py holds it
bitwise against JAX's draw.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "monohair_tpu_torch", "nerf", "fourier_b.npz")
MAX_FEATURES = 256


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    if not jax.config.jax_threefry_partitionable:
        sys.exit("jax_threefry_partitionable is off: the (3, F) draw is then not a "
                 "prefix of one flat draw")
    flat = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (3 * MAX_FEATURES,)),
                      np.float32)
    np.savez(OUT, normal=flat, key=np.int64(11), jax_version=np.str_(jax.__version__),
             threefry_partitionable=np.bool_(True))
    print(f"wrote {OUT}: {flat.shape} f32 from JAX {jax.__version__}")


if __name__ == "__main__":
    main()
