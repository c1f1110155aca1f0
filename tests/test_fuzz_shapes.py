"""Shape fuzzing: random (H, W, C, filter, level, radius) combos against the
oracle.  This is the broad guard on the tiling/padding arithmetic (bucket
pads, DMA alignment slack, halo bands, odd widths/heights)."""

import numpy as np
import pytest

from gpu_image_processing.ops.weights import gaussian_kernel_f32
from gpu_image_processing.runtime.dispatch import RUNTIME

from . import oracle_numpy as oracle
from .sobel_tolerance import assert_sobel_close

CASES = []
_rng = np.random.default_rng(20260816)
for _ in range(14):
    CASES.append((
        int(_rng.integers(3, 140)),          # H
        int(_rng.integers(3, 140)),          # W
        int(_rng.choice([1, 3, 4])),         # C
        str(_rng.choice(["gaussian", "box", "sobel"])),
        int(_rng.choice([1, 2])),
        int(_rng.integers(1, 9)),            # radius
    ))
# A couple of degenerate extremes.
CASES += [(1, 1, 1, "gaussian", 2, 3), (2, 200, 3, "box", 2, 7),
          (200, 2, 4, "sobel", 2, 1), (8, 8, 3, "gaussian", 2, 8)]


@pytest.mark.parametrize("h,w,c,filter_name,level,radius", CASES)
def test_fuzz_matches_oracle(h, w, c, filter_name, level, radius):
    rng = np.random.default_rng(h * 1000 + w * 10 + c)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if filter_name == "gaussian":
        sigma = 0.5 + (radius % 5)
        out, _ = RUNTIME.gaussian_blur(img, sigma=sigma, radius=radius, level=level)
        want = oracle.gaussian_blur(img, gaussian_kernel_f32(radius, sigma), radius)
        np.testing.assert_array_equal(out, want)
    elif filter_name == "box":
        out, _ = RUNTIME.box_blur(img, radius=radius, level=level)
        np.testing.assert_array_equal(out, oracle.box_blur(img, radius))
    else:
        out, _ = RUNTIME.sobel_edge_detection(img, level=level)
        assert_sobel_close(out, oracle.sobel(img, level))


@pytest.mark.parametrize("value", [0, 255])
@pytest.mark.parametrize("level", [1, 2])
def test_constant_image_invariant(value, level):
    # Blurring a constant image must return it unchanged (weights sum to ~1;
    # the +0.5-floor rounding and clip must not drift at saturation).
    img = np.full((40, 52, 3), value, dtype=np.uint8)
    out, _ = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=level)
    np.testing.assert_array_equal(out, img)
    out, _ = RUNTIME.box_blur(img, radius=5, level=level)
    np.testing.assert_array_equal(out, img)
    # Sobel of a constant image is all zeros (zero gradient + zero border).
    out, _ = RUNTIME.sobel_edge_detection(img, level=level)
    assert (out == 0).all()


@pytest.mark.parametrize("radius", [4, 8, 11, 15])
@pytest.mark.parametrize("c", [1, 3])
def test_box_doubling_exact(radius, c):
    # radius >= 4 engages the doubling-window sums in both optimized tiers
    # (Pallas kernel + XLA fallback); output must stay bit-identical to the
    # sequential-tap oracle.
    rng = np.random.default_rng(radius * 10 + c)
    img = rng.integers(0, 256, (45, 61, c), dtype=np.uint8)
    for level in (1, 2, 4):
        out, _ = RUNTIME.box_blur(img, radius=radius, level=level)
        np.testing.assert_array_equal(out, oracle.box_blur(img, radius))


def test_box_doubling_xla_tier_exact():
    # Small images at radius 8-15 route level-2 box blurs to the XLA
    # tier's doubling window sums (ops/pallas/api.py::kernel_serves); the
    # output stays bit-identical to the sequential-tap oracle.
    from gpu_image_processing.ops.pallas.api import kernel_serves

    rng = np.random.default_rng(77)
    img = rng.integers(0, 256, (38, 47, 3), dtype=np.uint8)
    for radius in (9, 15):
        assert not kernel_serves("box", radius, 64 * 64)
        out, _ = RUNTIME.box_blur(img, radius=radius, level=2)
        np.testing.assert_array_equal(out, oracle.box_blur(img, radius))


def test_fma_boundary_envelope_characterization():
    """A known image where one gaussian h-pass sum lands exactly on a
    rounding boundary: XLA's FMA contraction (like nvcc's in the CUDA
    reference) may round it differently per compilation unit, so tiers can
    differ from the strict-order oracle by at most 1 on such pixels.  The
    reference's own L1<->L2 gate is maxdiff <= 1 for the same reason
    (tests/test_comparison.cu:204-221).  This pins the envelope: every tier
    stays within 1, and the planar tiers happen to be exact here.
    """
    rng = np.random.default_rng(5)
    for shape in [(20, 700, 3), (30, 1600, 1), (16, 520, 4)]:
        rng.integers(0, 256, shape, np.uint8)
    img = rng.integers(0, 256, (25, 31, 3), np.uint8)
    w = gaussian_kernel_f32(3, 2.0)
    want = oracle.gaussian_blur(img, w, 3)
    for level in (1, 2):
        out, _ = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=level)
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
