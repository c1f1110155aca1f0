"""Sobel edge detection as one Pallas kernel through Triton.

The reference's optimized Sobel (sobelEdgeDetectionShared,
image_filters.cu:1329-1597) is one launch over a (bx+2) x (by+2) gray tile
in shared memory, with gray quantized to uint8 as it is loaded.  This
kernel is the same single pass on the (B, H, W*C) rows layout: a program
walks its row band, computes each input row's gray at the lane's own pixel
and its left and right neighbours (clamped index vectors), keeps the last
three rows in registers, and writes the magnitude of every pixel to all of
its channels.  The image is read once; nothing else touches device memory.

Numerics follow tests/oracle_numpy.py: gray = (.299 R + .587 G) + .114 B in
f32 (quantized to uint8 when `quantize_gray`, the reference's level 2),
taps summed top-left to bottom-right, magnitude min(sqrt(gx^2+gy^2), 255)
rounded half up, 1-pixel border zeroed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .blur import launch, quant

_GRAY = (np.float32(0.299), np.float32(0.587), np.float32(0.114))


def _sobel_kernel(x_ref, o_ref, *, channels: int, quantize_gray: bool,
                  block_lanes: int, block_rows: int):
    b = pl.program_id(0)
    strip = pl.program_id(1)
    band = pl.program_id(2)
    height, data_width = x_ref.shape[1], x_ref.shape[2]
    width = data_width // channels

    out_lane = strip * block_lanes + jnp.arange(block_lanes, dtype=jnp.int32)
    lane_ok = out_lane < data_width
    pix = jnp.minimum(out_lane, data_width - 1) // channels
    bases = (jnp.maximum(pix - 1, 0) * channels, pix * channels,
             jnp.minimum(pix + 1, width - 1) * channels)

    def gray(row, base):
        if channels == 1:
            g = plgpu.load(x_ref.at[b, row, base]).astype(jnp.float32)
        else:
            r, gr, bl = (plgpu.load(x_ref.at[b, row, base + k]).astype(
                jnp.float32) for k in range(3))
            g = _GRAY[0] * r + _GRAY[1] * gr + _GRAY[2] * bl
        return quant(g) if quantize_gray else g

    def gray_row(row):
        row = jnp.minimum(jnp.maximum(row, 0), height - 1)
        return tuple(gray(row, base) for base in bases)

    row0 = band * block_rows
    inside_cols = (pix >= 1) & (pix <= width - 2)

    def step(j, ring):
        top, mid = ring
        bot = gray_row(row0 + j + 1)
        # Tap weights as f32 literals (the lowering takes no unary op on a
        # constant).
        one, two = jnp.float32(1.0), jnp.float32(2.0)
        m_one, m_two = jnp.float32(-1.0), jnp.float32(-2.0)
        gx = (m_one * top[0] + one * top[2] + m_two * mid[0]
              + two * mid[2] + m_one * bot[0] + one * bot[2])
        gy = (m_one * top[0] + m_two * top[1] + m_one * top[2]
              + one * bot[0] + two * bot[1] + one * bot[2])
        mag = jnp.floor(jnp.minimum(jnp.sqrt(gx * gx + gy * gy),
                                    jnp.float32(255.0)) + jnp.float32(0.5))
        out_row = row0 + j
        inside = inside_cols & (out_row >= 1) & (out_row <= height - 2)
        plgpu.store(o_ref.at[b, jnp.minimum(out_row, height - 1), out_lane],
                    jnp.where(inside, mag, jnp.float32(0.0)).astype(jnp.uint8),
                    mask=lane_ok & (out_row < height))
        return mid, bot

    jax.lax.fori_loop(0, block_rows, step,
                      (gray_row(row0 - 1), gray_row(row0)))


def sobel_rows(rows: jnp.ndarray, channels: int, quantize_gray: bool,
               interpret: bool = False) -> jnp.ndarray:
    """(H, W*C) or (B, H, W*C) u8 -> u8 Sobel edge map."""
    if rows.shape[-1] % channels:
        raise ValueError(f"row width {rows.shape[-1]} is not a multiple of "
                         f"{channels} channels")
    kernel = functools.partial(_sobel_kernel, channels=channels,
                               quantize_gray=quantize_gray)
    return launch(kernel, rows, (), 1, interpret, "sobel_rows")
