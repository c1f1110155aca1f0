"""The served rows function of each filter and level, and its image views.

`rows_fn` is the one place that routes a served program: level 1 is the
interleaved XLA tier, bit-matched to the reference's naive kernels; levels
2 and 4 run the Pallas kernels (ops/pallas/blur.py, sobel.py) wherever they
measured faster than the XLA tier of the same numerics on an H100, and the
XLA tier elsewhere (`kernel_serves`).  The kernels compile through Triton
on the GPU; `interpret=True` runs them in the Pallas interpreter (the CPU
backend, runtime/device.py::use_interpret).
"""

from __future__ import annotations

from typing import Callable

from .. import interleaved as il
from . import blur, sobel

#: Where the kernels beat the XLA tier, from a sweep of 0.07-7 MP and
#: radius 1-15 on an H100 (PERF.md).  A small image shrinks the kernel's
#: row bands to keep every SM busy, so the 2r halo rows each band
#: recomputes grow against its output rows; box blurs also pay O(r) taps
#: against the XLA tier's O(log r) doubling window sums.  Sobel's kernel
#: won at every size.
GAUSSIAN_SMALL_RADIUS = 3          # the kernel at every size up to here
GAUSSIAN_MIN_PIXELS = 250_000      # ... and beyond it from here
BOX_MIN_PIXELS = ((3, 0), (7, 500_000), (15, 2_000_000))  # (max radius, min pixels)


def kernel_serves(filter_name: str, radius: int, pixels: int) -> bool:
    """Whether a level-2/4 program of `filter_name` at `radius` over
    `pixels` (all images of the program) runs the Pallas kernel rather
    than the XLA tier."""
    if filter_name == "gaussian":
        return radius <= GAUSSIAN_SMALL_RADIUS or pixels >= GAUSSIAN_MIN_PIXELS
    if filter_name == "box":
        return any(radius <= r and pixels >= p for r, p in BOX_MIN_PIXELS)
    return True


def rows_fn(filter_name: str, level: int, radius: int, width: int,
            channels: int, interpret: bool) -> Callable:
    """The served (..., H, W*C) u8 -> u8 function of one filter and level.

    The kernel-or-XLA choice is made from the traced shape.  Gaussian fns
    take the (2r+1,) weights as a second operand.
    """
    if level == 1:
        if filter_name == "gaussian":
            return lambda rows, w: il.gaussian_rows(rows, w, radius, channels)
        if filter_name == "box":
            return lambda rows: il.box_rows(rows, radius, channels)
        return lambda rows: il.sobel_rows(rows, 1, width, channels)

    def serves(rows) -> bool:
        return kernel_serves(filter_name, radius, rows.size // channels)

    if filter_name == "gaussian":
        def gaussian(rows, w):
            if serves(rows):
                return blur.gaussian_rows(rows, w, radius, channels,
                                          interpret=interpret)
            return il.gaussian_rows(rows, w, radius, channels)
        return gaussian
    if filter_name == "box":
        def box(rows):
            if serves(rows):
                return blur.box_rows(rows, radius, channels,
                                     interpret=interpret)
            return il.box_rows(rows, radius, channels, doubling=True)
        return box
    # Level 2 quantizes gray to uint8 as the reference's shared-memory tile
    # load does (image_filters.cu:1444); level 4 keeps it in f32.
    return lambda rows: sobel.sobel_rows(rows, channels,
                                         quantize_gray=level == 2,
                                         interpret=interpret)


def image_fn(filter_name: str, level: int, interpret: bool) -> Callable:
    """`rows_fn` on one (H, W, C) image, viewed as rows for free:
    gaussian(img, w, radius), box(img, radius), sobel(img)."""
    def apply(img, *args):
        h, w, c = img.shape
        if filter_name == "gaussian":
            weights, radius = args
            extra = (weights,)
        else:
            radius, extra = (args[0] if args else 0), ()
        fn = rows_fn(filter_name, level, radius, w, c, interpret)
        return fn(img.reshape(h, w * c), *extra).reshape(h, w, c)
    return apply


def level2_impls(interpret: bool) -> dict[str, Callable]:
    """Level 2: Sobel quantizes gray to uint8 (image_filters.cu:1444)."""
    return {f: image_fn(f, 2, interpret) for f in ("gaussian", "box", "sobel")}


def level4_impls(interpret: bool) -> dict[str, Callable]:
    """ADVANCED tier: Sobel keeps gray in f32; the blurs equal level 2."""
    return {f: image_fn(f, 4, interpret) for f in ("gaussian", "box", "sobel")}
