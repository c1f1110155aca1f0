"""Interleaved <-> planar uint8 layout conversion via MXU permutation matmuls.

The serving boundary speaks interleaved HWC bytes (PNG/numpy convention,
same layout the CUDA kernels consume directly with per-channel offsets,
image_filters.cu:95).  A 128-lane vector unit wants planar (C, H, W) with
W on the lanes, where a direct XLA transpose of an (H, W, 3) uint8 array
is a byte-level lane shuffle.  This module casts the conversion as matrix
multiplication on a matrix unit instead:

    flat (N*C,) u8  -> X (N/128, 128*C)
    plane_c         =  X @ P_c      with P_c[C*k + c, k] = 1   (128*C x 128)
    interleaved     =  sum_c plane_c @ Q_c  with Q_c[k, C*k + c] = 1

Every output element receives exactly ONE nonzero product (x * 1) plus
zeros, so the result is bit-exact regardless of accumulation order -- the
MXU is used purely as a high-bandwidth permutation engine.  Operands are
bf16 with f32 accumulation: exact ONLY for u8-valued input (integers
<= 255 are exact in bf16); fractional f32 values would lose mantissa bits
in the operand cast, so f32 mode is for u8-VALUED planes held in f32.

A fused `broadcast_interleave` writes one gray plane to all C interleaved
channels in a single matmul (the Sobel output pattern,
image_filters.cu:1311-1313).

STATUS: measured slower than the XLA transpose it was meant to replace, on
the accelerator it was written for; not timed on the GPU.  Kept as a
correct, tested negative result and queued for deletion (ROADMAP.md,
Design).  Nothing on the served path uses it: the served kernels run on the
flat buffer's (H, W*C) rows layout (ops/interleaved.py, ops/pallas/).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

LANE = 128


@functools.lru_cache(maxsize=8)
def _deint_matrix(channels: int) -> np.ndarray:
    """(C*128, 128, C) stacked as (C,)?  Returns (C, C*128, 128) bf16."""
    mats = np.zeros((channels, channels * LANE, LANE), dtype=np.float32)
    for c in range(channels):
        for k in range(LANE):
            mats[c, channels * k + c, k] = 1.0
    return mats.astype(jnp.bfloat16)


@functools.lru_cache(maxsize=8)
def _int_matrix(channels: int) -> np.ndarray:
    """(C, 128, C*128) bf16 with Q_c[k, C*k+c] = 1."""
    mats = np.zeros((channels, LANE, channels * LANE), dtype=np.float32)
    for c in range(channels):
        for k in range(LANE):
            mats[c, k, channels * k + c] = 1.0
    return mats.astype(jnp.bfloat16)


@functools.lru_cache(maxsize=8)
def _bcast_matrix(channels: int) -> np.ndarray:
    """(128, C*128) bf16 with B[k, C*k+c] = 1 for every c."""
    mat = np.zeros((LANE, channels * LANE), dtype=np.float32)
    for k in range(LANE):
        for c in range(channels):
            mat[k, channels * k + c] = 1.0
    return mat.astype(jnp.bfloat16)


def _pad_rows(n: int) -> int:
    return -(-n // LANE) * LANE


def deinterleave(flat_u8: jnp.ndarray, height: int, width: int, channels: int,
                 out_f32: bool = False) -> jnp.ndarray:
    """(H*W*C,) u8 interleaved -> (C, H, W) u8 (or f32) planar, bit-exact."""
    if channels == 1:
        plane = flat_u8.reshape(1, height, width)
        return plane.astype(jnp.float32) if out_f32 else plane
    n = height * width
    n_pad = _pad_rows(n)
    x = flat_u8
    if n_pad != n:
        x = jnp.pad(x, (0, (n_pad - n) * channels))
    rows = x.reshape(n_pad // LANE, LANE * channels).astype(jnp.bfloat16)
    mats = jnp.asarray(_deint_matrix(channels))
    planes = jnp.einsum(
        "nk,ckm->cnm", rows, mats, preferred_element_type=jnp.float32
    )  # (C, n_pad/128, 128)
    planes = planes.reshape(channels, n_pad)[:, :n].reshape(channels, height, width)
    return planes if out_f32 else planes.astype(jnp.uint8)


def interleave(planar: jnp.ndarray) -> jnp.ndarray:
    """(C, H, W) planar -> (H*W*C,) u8 interleaved.

    Bit-exact for u8-VALUED input (incl. u8 values held in f32); a
    fractional f32 plane loses mantissa bits in the bf16 operand cast
    (see module docstring)."""
    channels, height, width = planar.shape
    if channels == 1:
        return planar.reshape(-1).astype(jnp.uint8)
    n = height * width
    n_pad = _pad_rows(n)
    x = planar.reshape(channels, n)
    if n_pad != n:
        x = jnp.pad(x, ((0, 0), (0, n_pad - n)))
    rows = x.reshape(channels, n_pad // LANE, LANE).astype(jnp.bfloat16)
    mats = jnp.asarray(_int_matrix(channels))
    out = jnp.einsum(
        "cnk,ckm->nm", rows, mats, preferred_element_type=jnp.float32
    )  # (n_pad/128, C*128)
    return out.reshape(n_pad * channels)[: n * channels].astype(jnp.uint8)


def broadcast_interleave(plane: jnp.ndarray, channels: int) -> jnp.ndarray:
    """(H, W) u8/f32 -> (H*W*C,) u8 with the value in every channel.

    The Sobel output pattern: one edge plane replicated across channels
    (alpha included), in one MXU matmul.
    """
    height, width = plane.shape
    if channels == 1:
        return plane.reshape(-1).astype(jnp.uint8)
    n = height * width
    n_pad = _pad_rows(n)
    x = plane.reshape(-1)
    if n_pad != n:
        x = jnp.pad(x, (0, n_pad - n))
    rows = x.reshape(n_pad // LANE, LANE).astype(jnp.bfloat16)
    mat = jnp.asarray(_bcast_matrix(channels))
    out = jnp.dot(rows, mat, preferred_element_type=jnp.float32)
    return out.reshape(n_pad * channels)[: n * channels].astype(jnp.uint8)
