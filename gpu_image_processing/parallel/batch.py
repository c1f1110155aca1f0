"""Batch data-parallel filtering: shard a stack of images across chips.

The reference processes one image per request on one GPU
(`/api/process-all` even iterates levels serially, backend/app.py:332).
The natural serving-scale path is a batch of same-shape images laid out
(B, H, W, C) and sharded over the `dp` mesh axis; XLA inserts no
collectives at all (pure data parallelism), so throughput scales with the
number of devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fused, ref


def make_batch_filter(mesh: Mesh, filter_name: str, radius: int = 3, level: int = 2):
    """Jitted batch filter with the batch dim sharded over EVERY mesh axis.

    Input (B, H, W, C) uint8, any B: batches that don't divide the device
    count are padded with copies of the last image and cropped after (data
    parallelism is per-image, so pad images cannot affect real outputs).
    """
    axes = tuple(mesh.axis_names)
    n = mesh.size
    spec = P(axes, None, None, None)
    sharding = NamedSharding(mesh, spec)

    if filter_name == "gaussian":
        impl = ref.gaussian_blur if level == 1 else fused.gaussian_fused
        per_image = lambda im, weights: impl(im, weights, radius)
    elif filter_name == "box":
        impl = ref.box_blur if level == 1 else fused.box_fused
        per_image = lambda im: impl(im, radius)
    elif filter_name == "sobel":
        per_image = lambda im: ref.sobel(im, level)
    else:
        raise ValueError(f"Unknown filter: {filter_name}")

    def fn(imgs, *rest):
        b = imgs.shape[0]
        pad_b = -b % n
        if pad_b:
            imgs = jnp.pad(imgs, ((0, pad_b), (0, 0), (0, 0), (0, 0)), mode="edge")
        imgs = jax.lax.with_sharding_constraint(imgs, sharding)
        out = jax.vmap(lambda im: per_image(im, *rest))(imgs)
        return out[:b] if pad_b else out

    return jax.jit(fn)
