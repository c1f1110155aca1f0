"""Level-1 "oracle" filters: pure jnp, bit-matched to the CUDA naive kernels.

These are the functional specification of the framework.  They run anywhere
(CPU or GPU), are compiled by XLA, and reproduce the reference's numerics
operation-for-operation:

* separable Gaussian blur: clamp-to-edge, f32 accumulation in tap order,
  per-pass `(unsigned char)(sum + 0.5f)` quantization with the horizontal
  result stored as uint8 before the vertical pass
  (gaussianBlurHorizontalNaive/VerticalNaive, image_filters.cu:64-144);
* box blur: raw-pixel f32 sum then multiply by the f32 reciprocal of the tap
  count, per pass (boxBlurHorizontal/VerticalNaive, image_filters.cu:362-431);
* Sobel: 1-pixel border zeroed, color converted per-tap via
  `0.299f*R + 0.587f*G + 0.114f*B` kept in f32 (level 1) or quantized to
  uint8 first (level 2's shared-memory tile load, image_filters.cu:1444),
  magnitude `min(sqrtf(gx^2+gy^2), 255)`, written to ALL channels including
  alpha (sobelEdgeDetectionNaive/Shared, image_filters.cu:1152-1597).

Layout note: the reference works on interleaved HWC uint8 because that is
what coalesced CUDA loads want.  Every op here moves to planar (C, H, W)
float32 (the plainest statement of the math) and the surrounding jit fuses
the transposes into the pipeline.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .rounding import quantize_u8, quantize_u8_f32
from .weights import box_inv_taps_f32

# Grayscale conversion weights (Rec.601, image_filters.cu:1236).
_GRAY_R = np.float32(0.299)
_GRAY_G = np.float32(0.587)
_GRAY_B = np.float32(0.114)


def _to_planar_f32(img_hwc: jnp.ndarray) -> jnp.ndarray:
    """(H, W, C) any-int -> (C, H, W) float32."""
    return jnp.transpose(img_hwc, (2, 0, 1)).astype(jnp.float32)


def _to_hwc_u8(planar: jnp.ndarray) -> jnp.ndarray:
    """(C, H, W) uint8 -> (H, W, C)."""
    return jnp.transpose(planar, (1, 2, 0))


def _conv_pass_w(x: jnp.ndarray, weights, radius: int) -> jnp.ndarray:
    """Weighted conv along the last axis with clamp-to-edge, f32 tap order.

    `x` is (..., W) f32; `weights` is a (2r+1,) array (traced or numpy).
    Accumulates `pixel * w[i]` sequentially for i = -r..r, exactly like the
    CUDA loop (image_filters.cu:86-99).
    """
    width = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(radius, radius)]
    xp = jnp.pad(x, pad, mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + width] * weights[i]
        acc = term if acc is None else acc + term
    return acc


def _sum_pass(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Unweighted clamp-to-edge sum along the last axis, f32 tap order."""
    width = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(radius, radius)]
    xp = jnp.pad(x, pad, mode="edge")
    acc = None
    for i in range(2 * radius + 1):
        term = xp[..., i : i + width]
        acc = term if acc is None else acc + term
    return acc


def _swap_hw(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.swapaxes(x, -1, -2)


def gaussian_blur(img_hwc: jnp.ndarray, weights: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable Gaussian blur, level-1 numerics. (H, W, C) u8 -> u8."""
    x = _to_planar_f32(img_hwc)
    # Horizontal pass -> uint8 temp (kept as integral f32), then vertical.
    h = quantize_u8_f32(_conv_pass_w(x, weights, radius))
    v = quantize_u8(_conv_pass_w(_swap_hw(h), weights, radius))
    return _to_hwc_u8(_swap_hw(v))


def box_blur(img_hwc: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable box blur, level-1 numerics. (H, W, C) u8 -> u8."""
    inv = box_inv_taps_f32(radius)
    x = _to_planar_f32(img_hwc)
    h = quantize_u8_f32(_sum_pass(x, radius) * inv)
    v = quantize_u8(_sum_pass(_swap_hw(h), radius) * inv)
    return _to_hwc_u8(_swap_hw(v))


def grayscale_f32(img_hwc: jnp.ndarray) -> jnp.ndarray:
    """(H, W, C) u8 -> (H, W) f32 gray plane.

    For C==1 this is the plane itself; otherwise Rec.601 in the exact f32
    order `(0.299f*R + 0.587f*G) + 0.114f*B` (image_filters.cu:1245).
    Channel 4 (alpha) is ignored, as in the reference.
    """
    channels = img_hwc.shape[-1]
    if channels == 1:
        return img_hwc[..., 0].astype(jnp.float32)
    # Planar-first: one f32 plane per channel.  Same f32 op order.
    planar = jnp.moveaxis(img_hwc, -1, 0).astype(jnp.float32)
    return _GRAY_R * planar[0] + _GRAY_G * planar[1] + _GRAY_B * planar[2]


def sobel_magnitude_u8(gray: jnp.ndarray) -> jnp.ndarray:
    """(H, W) f32 gray -> (H, W) u8 edge magnitude with zeroed 1-px border.

    Tap accumulation matches sobelEdgeDetectionNaive exactly: gx and gy each
    sum their non-zero taps top-left to bottom-right (adding a `0.0f * v`
    term is an exact no-op in f32 for finite v, so zero-weight taps are
    skipped).
    """
    height, width = gray.shape
    gp = jnp.pad(gray, 1, mode="edge")

    def tap(dy: int, dx: int) -> jnp.ndarray:
        return gp[1 + dy : 1 + dy + height, 1 + dx : 1 + dx + width]

    one = jnp.float32(1.0)
    two = jnp.float32(2.0)
    # Gx: [-1 0 1; -2 0 2; -1 0 1]
    gx = (
        (-one) * tap(-1, -1)
        + one * tap(-1, 1)
        + (-two) * tap(0, -1)
        + two * tap(0, 1)
        + (-one) * tap(1, -1)
        + one * tap(1, 1)
    )
    # Gy: [-1 -2 -1; 0 0 0; 1 2 1]
    gy = (
        (-one) * tap(-1, -1)
        + (-two) * tap(-1, 0)
        + (-one) * tap(-1, 1)
        + one * tap(1, -1)
        + two * tap(1, 0)
        + one * tap(1, 1)
    )
    mag = jnp.minimum(jnp.sqrt(gx * gx + gy * gy), jnp.float32(255.0))
    out = quantize_u8(mag)
    # Zero the 1-pixel border (image_filters.cu:1164-1176).  For images
    # thinner than 3 pixels every pixel is border, matching the reference.
    zero = jnp.zeros_like(out)
    return zero.at[1 : height - 1, 1 : width - 1].set(out[1 : height - 1, 1 : width - 1])


def sobel(img_hwc: jnp.ndarray, level: int) -> jnp.ndarray:
    """Sobel edge detection. (H, W, C) u8 -> (H, W, C) u8.

    level 1 keeps the grayscale conversion in f32; level 2 reproduces the
    shared-memory kernel's fidelity nuance of quantizing gray to uint8 during
    the tile load (image_filters.cu:1444) before convolving.
    """
    gray = grayscale_f32(img_hwc)
    if level == 2:
        gray = quantize_u8_f32(gray)
    edge = sobel_magnitude_u8(gray)
    channels = img_hwc.shape[-1]
    # Same edge value written to every channel, alpha included
    # (image_filters.cu:1311-1313).
    return jnp.broadcast_to(edge[..., None], (*edge.shape, channels))
