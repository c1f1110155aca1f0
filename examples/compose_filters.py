#!/usr/bin/env python3
"""Example: composing filter models inside one jitted pipeline.

The reference exposes filters only as opaque per-call bindings; here each
filter is a pure jax function, so users can fuse several into a single XLA
program (one device round trip, no intermediate HBM materialization between
stages beyond what XLA schedules).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from gpu_image_processing.models import BoxBlur, GaussianBlur, SobelEdgeDetection


def main() -> None:
    blur = GaussianBlur(sigma=2.0, radius=3, level=2)
    smooth = BoxBlur(radius=2, level=2)
    edges = SobelEdgeDetection(level=2)

    @jax.jit
    def denoised_edges(img):
        """Blur -> box smooth -> edge detect, compiled as ONE program."""
        return edges.apply(smooth.apply(blur.apply(img)))

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    out = np.asarray(denoised_edges(img))
    print(f"in {img.shape} -> out {out.shape}, edge pixels >64: "
          f"{(out[:, :, 0] > 64).mean():.1%}")


if __name__ == "__main__":
    main()
