"""Interleaved-HWC (rows-boundary) filter implementations, pure jnp.

The serving boundary ships images as (H, W*C) uint8 ROWS (HWC byte order
viewed 2-D; the host-side reshape is free), and every served program works
on that layout directly, so no (H, W, C) <-> planar relayout ever runs on
the device:

* a horizontal tap at pixel offset t is a lane offset of t*C (all channels
  shift together; slices stay contiguous),
* clamp-to-edge replicates PIXELS: the first/last C lanes are tiled,
* Sobel computes gray at EVERY lane (g[l] = .299 x[l] + .587 x[l+1] +
  .114 x[l+2]); pixel-phase lanes carry the true gray, the rest is
  phase-garbage that the channel-replication masks never select.

Numerics are bit-identical to the planar oracle (ops/ref.py): each output
element sees the exact same f32 operation sequence as the CUDA naive
kernels (image_filters.cu:64-144,362-431,1152-1315).  This module serves
level 1, the XLA side of the kernel-vs-XLA comparisons (PERF.md), and box
radii past the Pallas kernel's register ring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rounding import quantize_u8, quantize_u8_f32
from .weights import box_inv_taps_f32

# numpy scalars, NOT jnp arrays: module-level jnp constants become AOT
# const_args of every executable that closes over them and can be
# invalidated between compile and call (observed "compiled for 4 inputs but
# called with 1" under test ordering); numpy scalars embed as literals.
_GRAY_R = np.float32(0.299)
_GRAY_G = np.float32(0.587)
_GRAY_B = np.float32(0.114)


def _pad_pixels_lr(x: jnp.ndarray, radius: int, channels: int) -> jnp.ndarray:
    """Pixel-replicated clamp-to-edge padding on the last (W*C) axis."""
    first = jnp.tile(x[..., :channels], (1,) * (x.ndim - 1) + (radius,))
    last = jnp.tile(x[..., x.shape[-1] - channels:],
                    (1,) * (x.ndim - 1) + (radius,))
    return jnp.concatenate([first, x, last], axis=-1)


def _pad_rows_edge(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (0, 0)]
    return jnp.pad(x, pad, mode="edge")


def _conv_cols(x: jnp.ndarray, weights, radius: int, channels: int) -> jnp.ndarray:
    """Weighted horizontal pass on (..., H, W*C) f32, CUDA tap order."""
    wf = x.shape[-1]
    xp = _pad_pixels_lr(x, radius, channels)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i * channels : i * channels + wf] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _conv_rows(x: jnp.ndarray, weights, radius: int) -> jnp.ndarray:
    height = x.shape[-2]
    xp = _pad_rows_edge(x, radius)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _sum_cols(x: jnp.ndarray, radius: int, channels: int) -> jnp.ndarray:
    wf = x.shape[-1]
    xp = _pad_pixels_lr(x, radius, channels)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i * channels : i * channels + wf]
        acc = term if acc is None else acc + term
    return acc


def _sum_rows(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    height = x.shape[-2]
    xp = _pad_rows_edge(x, radius)
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + height, :]
        acc = term if acc is None else acc + term
    return acc


def gaussian_rows(rows_u8: jnp.ndarray, weights: jnp.ndarray, radius: int,
                  channels: int) -> jnp.ndarray:
    """(..., H, W*C) u8 -> u8 separable Gaussian, level-1 numerics."""
    x = rows_u8.astype(jnp.float32)
    h = quantize_u8_f32(_conv_cols(x, weights, radius, channels))
    return quantize_u8(_conv_rows(h, weights, radius))


def _windowed_sum_doubling(xp: jnp.ndarray, taps: int, unit: int,
                           axis: int) -> jnp.ndarray:
    """Sum of `taps` elements spaced `unit` apart along `axis`, built by
    doubling: ~2*log2(taps) adds instead of taps.  Exact for box windows
    (uint8 sums < 2^24 are exact integers in f32 under any association)."""
    def sl(a, start, length):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(start, start + length)
        return a[tuple(idx)]

    out_len = xp.shape[axis] - (taps - 1) * unit
    res = None
    off = 0
    s = xp
    n_bits = taps.bit_length()
    for b in range(n_bits):
        if (taps >> b) & 1:
            term = sl(s, off, out_len)
            res = term if res is None else res + term
            off += (1 << b) * unit
        if b < n_bits - 1:
            shift = (1 << b) * unit
            s = sl(s, 0, s.shape[axis] - shift) + sl(s, shift, s.shape[axis] - shift)
    return res


def box_rows(rows_u8: jnp.ndarray, radius: int, channels: int,
             doubling: bool = False) -> jnp.ndarray:
    """(..., H, W*C) u8 -> u8 separable box blur.

    doubling=False is the level-1 numerics (sequential CUDA tap order);
    doubling=True builds the window sums by doubling -- bit-identical
    output (sums are exact), ~2*log2 the adds, used by the optimized tiers
    at radius >= 4.
    """
    inv = box_inv_taps_f32(radius)
    x = rows_u8.astype(jnp.float32)
    taps = 2 * radius + 1
    if doubling:
        hs = _windowed_sum_doubling(
            _pad_pixels_lr(x, radius, channels), taps, channels, x.ndim - 1)
        h = quantize_u8_f32(hs * inv)
        vs = _windowed_sum_doubling(
            _pad_rows_edge(h, radius), taps, 1, x.ndim - 2)
        return quantize_u8(vs * inv)
    h = quantize_u8_f32(_sum_cols(x, radius, channels) * inv)
    return quantize_u8(_sum_rows(h, radius) * inv)


def _gray_phase_aligned(x: jnp.ndarray, channels: int) -> jnp.ndarray:
    """Per-pixel gray at EVERY lane of an interleaved (..., H, W*C) plane.

    Step 1 is the same every-lane 3-term chain the phase-0 scheme used
    (g[l] = .299 x[l] + .587 x[l+1] + .114 x[l+2]; true gray at phase-0
    lanes, phase-garbage elsewhere) so the f32 bits at phase-0 lanes are
    unchanged.  Step 2 replicates each pixel's phase-0 value to all its
    lanes with ONE 3-way phase select (lane l copies g[l - l mod C]).
    Replicating gray at the INPUT instead of magnitude at the output is
    what the old scheme's pad+concat+select epilogue cost, minus the
    concat -- and every downstream op (quantize/taps/mag) then computes
    each pixel's true value at every lane, so within-pixel channel
    equality and oracle agreement are bit-for-bit those of the phase-0
    scheme.  (Two rejected alternatives, measured: lane-periodic zero
    weights and per-channel gathers both change which multiply-adds XLA
    contracts to FMAs, flipping level-2 quantization ties ~8e-3 vs the
    tolerance gate's 1e-3.)
    """
    wf = x.shape[-1]
    c = channels
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, 2)], mode="edge")
    g = (
        _GRAY_R * xp[..., :wf]
        + _GRAY_G * xp[..., 1 : wf + 1]
        + _GRAY_B * xp[..., 2 : wf + 2]
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, x.shape[-2:], 1)
    phase = lane % c
    # pad left so shifting right by p never reads out of bounds; padded
    # values are only selected where phase == p <= lane, i.e. never.
    gp = jnp.pad(g, [(0, 0)] * (x.ndim - 1) + [(c - 1, 0)])
    out = None
    for p in range(c):
        sl = gp[..., c - 1 - p : c - 1 - p + wf]
        out = sl if out is None else jnp.where(phase == p, sl, out)
    return out


def sobel_rows(rows_u8: jnp.ndarray, level: int, width: int,
               channels: int) -> jnp.ndarray:
    """(..., H, W*C) u8 -> u8 Sobel edge map, zeroed 1-px border.

    level 1 keeps gray in f32; level 2 quantizes gray first
    (image_filters.cu:1444).  Gray/taps/magnitude run at every lane; the
    phase-aligned gray makes every lane compute its OWN pixel's value, so
    the output needs no phase-select replication.
    """
    x = rows_u8.astype(jnp.float32)
    wf = x.shape[-1]
    height = x.shape[-2]

    if channels == 1:
        gray = x
    else:
        gray = _gray_phase_aligned(x, channels)
    if level == 2:
        gray = quantize_u8_f32(gray)

    gp = _pad_rows_edge(_pad_pixels_lr(gray, 1, channels), 1)

    def tap(dy: int, dx: int) -> jnp.ndarray:
        c0 = (1 + dx) * channels
        return gp[..., 1 + dy : 1 + dy + height, c0 : c0 + wf]

    one, two = jnp.float32(1.0), jnp.float32(2.0)
    gx = (
        (-one) * tap(-1, -1) + one * tap(-1, 1)
        + (-two) * tap(0, -1) + two * tap(0, 1)
        + (-one) * tap(1, -1) + one * tap(1, 1)
    )
    gy = (
        (-one) * tap(-1, -1) + (-two) * tap(-1, 0) + (-one) * tap(-1, 1)
        + one * tap(1, -1) + two * tap(1, 0) + one * tap(1, 1)
    )
    mag = jnp.floor(
        jnp.minimum(jnp.sqrt(gx * gx + gy * gy), jnp.float32(255.0))
        + jnp.float32(0.5)
    )

    lane = jax.lax.broadcasted_iota(jnp.int32, (height, wf), 1)
    pix = lane // channels
    row = jax.lax.broadcasted_iota(jnp.int32, (height, wf), 0)
    inside = (pix >= 1) & (pix <= width - 2) & (row >= 1) & (row <= height - 2)

    # Every lane holds its own pixel's magnitude (phase-aligned gray), so
    # the border zeroing is the only masking left.
    return jnp.where(inside, mag, 0.0).astype(jnp.uint8)
