"""Independent pure-numpy oracle implementing the CUDA reference semantics.

Deliberately written differently from the jnp ops (index-clamp gather instead
of edge-pad slicing) so agreement between the two is meaningful.  Semantics
transcribed from cuda_lib/src/image_filters.cu:

* gaussianBlurHorizontal/VerticalNaive (:64-144): f32 accumulate in tap
  order, clamp-to-edge, `(unsigned char)(sum + 0.5f)` per pass, uint8 temp
  between passes.
* boxBlurHorizontal/VerticalNaive (:362-431): raw f32 sum then multiply by
  f32 `1.0f/(2r+1)`, per pass.
* sobelEdgeDetectionNaive (:1152-1315) and Shared (:1329-1597): zeroed
  1-pixel border, Rec.601 gray (f32 at level 1, uint8-quantized at level 2),
  magnitude min(sqrt(gx^2+gy^2), 255).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _round_u8(x: np.ndarray) -> np.ndarray:
    """(unsigned char)(x + 0.5f) for non-negative x."""
    return np.floor(x.astype(F32) + F32(0.5)).clip(0, 255).astype(np.uint8)


def _clamped_take(arr: np.ndarray, idx: np.ndarray, axis: int) -> np.ndarray:
    idx = np.clip(idx, 0, arr.shape[axis] - 1)
    return np.take(arr, idx, axis=axis)


def gaussian_pass(img_u8: np.ndarray, weights: np.ndarray, radius: int, axis: int) -> np.ndarray:
    """One separable pass along `axis` of an (H, W, C) uint8 image."""
    n = img_u8.shape[axis]
    acc = np.zeros(img_u8.shape, dtype=F32)
    base = np.arange(n)
    for k, off in enumerate(range(-radius, radius + 1)):
        neighbor = _clamped_take(img_u8, base + off, axis).astype(F32)
        acc = acc + neighbor * F32(weights[k])
    return _round_u8(acc)


def gaussian_blur(img_u8: np.ndarray, weights: np.ndarray, radius: int) -> np.ndarray:
    h = gaussian_pass(img_u8, weights, radius, axis=1)   # horizontal (W)
    return gaussian_pass(h, weights, radius, axis=0)     # vertical (H)


def box_pass(img_u8: np.ndarray, radius: int, axis: int) -> np.ndarray:
    n = img_u8.shape[axis]
    inv = F32(1.0) / F32(2 * radius + 1)
    acc = np.zeros(img_u8.shape, dtype=F32)
    base = np.arange(n)
    for off in range(-radius, radius + 1):
        acc = acc + _clamped_take(img_u8, base + off, axis).astype(F32)
    return _round_u8(acc * inv)


def box_blur(img_u8: np.ndarray, radius: int) -> np.ndarray:
    h = box_pass(img_u8, radius, axis=1)
    return box_pass(h, radius, axis=0)


def grayscale(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W) f32 gray."""
    if img_u8.shape[2] == 1:
        return img_u8[:, :, 0].astype(F32)
    r = img_u8[:, :, 0].astype(F32)
    g = img_u8[:, :, 1].astype(F32)
    b = img_u8[:, :, 2].astype(F32)
    return F32(0.299) * r + F32(0.587) * g + F32(0.114) * b


def sobel(img_u8: np.ndarray, level: int) -> np.ndarray:
    """Whole-array numpy form of the per-pixel loop: every f32 operation is
    elementwise, in the reference's tap order, so each pixel sees exactly
    the scalar kernel's operation sequence."""
    height, width, channels = img_u8.shape
    gray = grayscale(img_u8)
    if level == 2:
        gray = np.floor(gray + F32(0.5)).clip(0, 255).astype(np.uint8).astype(F32)
    out = np.zeros((height, width), dtype=np.uint8)
    if height >= 3 and width >= 3:
        def g(dy: int, dx: int) -> np.ndarray:
            return gray[1 + dy:height - 1 + dy, 1 + dx:width - 1 + dx]

        zero = np.zeros((height - 2, width - 2), F32)
        # tap order: rows top->bottom, cols left->right (zero taps skipped)
        gx = zero + F32(-1.0) * g(-1, -1)
        gx = gx + F32(1.0) * g(-1, 1)
        gx = gx + F32(-2.0) * g(0, -1)
        gx = gx + F32(2.0) * g(0, 1)
        gx = gx + F32(-1.0) * g(1, -1)
        gx = gx + F32(1.0) * g(1, 1)
        gy = zero + F32(-1.0) * g(-1, -1)
        gy = gy + F32(-2.0) * g(-1, 0)
        gy = gy + F32(-1.0) * g(-1, 1)
        gy = gy + F32(1.0) * g(1, -1)
        gy = gy + F32(2.0) * g(1, 0)
        gy = gy + F32(1.0) * g(1, 1)
        mag = np.minimum(np.sqrt(gx * gx + gy * gy, dtype=F32), F32(255.0))
        out[1:-1, 1:-1] = np.floor(mag + F32(0.5)).astype(np.uint8)
    return np.repeat(out[:, :, None], channels, axis=2)
