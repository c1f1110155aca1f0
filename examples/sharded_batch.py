#!/usr/bin/env python3
"""Example: multi-device filtering over a jax.sharding.Mesh.

Needs at least two devices -- on a single-GPU or CPU host, set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu to
simulate an 8-device mesh.  The batch is sharded over the `dp` axis and
image rows over `sp`; the vertical-pass halo rows move between devices
through a ppermute collective.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from gpu_image_processing.ops.weights import gaussian_kernel_f32
from gpu_image_processing.parallel.mesh import make_mesh
from gpu_image_processing.parallel.spatial import make_sharded_filter


def main() -> None:
    n = len(jax.devices())
    mesh = make_mesh(min(n, 8))
    dp, sp = mesh.devices.shape
    print(f"mesh: dp={dp} x sp={sp} over {mesh.devices.size} devices")

    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(2 * dp, 64 * sp, 320, 3), dtype=np.uint8)
    weights = gaussian_kernel_f32(3, 2.0)

    step = make_sharded_filter(mesh, "gaussian", radius=3)
    out = step(batch, weights)
    print(f"sharded result: {out.shape}, device_set={len(out.sharding.device_set)}")


if __name__ == "__main__":
    main()
