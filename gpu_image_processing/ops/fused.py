"""Planar XLA versions of the level-2 filters.

Both separable passes are shifted-slice weighted sums that XLA fuses into a
handful of elementwise loops, on planar (C, H, W) data; the batch
data-parallel builder (parallel/batch.py) uses them.  The served level-2
path is the Pallas kernels in `ops/pallas/`.

Numerics are identical to the level-1 oracle for gaussian/box (the CUDA
level-2 kernels compute the same math as naive, just faster); Sobel level 2
quantizes the grayscale plane to uint8 before convolving, reproducing the
shared-memory kernel's tile-load rounding (image_filters.cu:1444).
"""

from __future__ import annotations

import jax.numpy as jnp

from .rounding import quantize_u8, quantize_u8_f32
from .weights import box_inv_taps_f32
from . import ref


def _conv_last(x: jnp.ndarray, weights, radius: int) -> jnp.ndarray:
    """Weighted clamp-to-edge conv along axis -1 (same tap order as ref)."""
    width = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(radius, radius)], mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + width] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _conv_rows(x: jnp.ndarray, weights, radius: int) -> jnp.ndarray:
    """Weighted clamp-to-edge conv along axis -2 (no transpose needed)."""
    height = x.shape[-2]
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (0, 0)]
    xp = jnp.pad(x, pad, mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _sum_last(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    width = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(radius, radius)], mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + width]
        acc = term if acc is None else acc + term
    return acc


def _sum_rows(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    height = x.shape[-2]
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (0, 0)]
    xp = jnp.pad(x, pad, mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :]
        acc = term if acc is None else acc + term
    return acc


def gaussian_fused(img_hwc: jnp.ndarray, weights: jnp.ndarray, radius: int) -> jnp.ndarray:
    x = jnp.transpose(img_hwc, (2, 0, 1)).astype(jnp.float32)
    h = quantize_u8_f32(_conv_last(x, weights, radius))
    v = quantize_u8(_conv_rows(h, weights, radius))
    return jnp.transpose(v, (1, 2, 0))


def box_fused(img_hwc: jnp.ndarray, radius: int) -> jnp.ndarray:
    inv = box_inv_taps_f32(radius)
    x = jnp.transpose(img_hwc, (2, 0, 1)).astype(jnp.float32)
    h = quantize_u8_f32(_sum_last(x, radius) * inv)
    v = quantize_u8(_sum_rows(h, radius) * inv)
    return jnp.transpose(v, (1, 2, 0))


def sobel_fused(img_hwc: jnp.ndarray) -> jnp.ndarray:
    return ref.sobel(img_hwc, level=2)


