"""ADVANCED (level 4) tier: the level the reference declares but never
implements (image_filters.h:28, README.md:316).  Gate: max pixel diff <= 1
vs level 2 -- the reference's own fidelity threshold
(tests/test_comparison.cu:204-221); advanced sobel equals level-1 numerics
exactly."""

import numpy as np
import pytest

import gpu_filters
from gpu_image_processing.runtime.dispatch import RUNTIME

from . import oracle_numpy as oracle
from .conftest import make_image


@pytest.mark.parametrize("shape", [(24, 31, 3), (19, 23, 1), (17, 29, 4)])
def test_gaussian_advanced_within_gate(rng, shape):
    img = make_image(rng, *shape)
    l2, _ = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=2)
    l4, _ = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=4)
    assert np.abs(l2.astype(int) - l4.astype(int)).max() <= 1


def test_box_advanced_within_gate(rng):
    img = make_image(rng, 24, 31, 3)
    l2, _ = RUNTIME.box_blur(img, radius=5, level=2)
    l4, _ = RUNTIME.box_blur(img, radius=5, level=4)
    assert np.abs(l2.astype(int) - l4.astype(int)).max() <= 1


def test_sobel_advanced_equals_l1(rng):
    from .sobel_tolerance import assert_sobel_close

    img = make_image(rng, 24, 31, 3)
    l4, _ = RUNTIME.sobel_edge_detection(img, level=4)
    assert_sobel_close(l4, oracle.sobel(img, 1))


def test_gpu_filters_accepts_level4(rng):
    img = make_image(rng, 12, 14, 3)
    result = gpu_filters.gaussian_blur(img, level=4)
    assert result["image"].shape == img.shape


def test_level5_still_rejected(rng):
    img = make_image(rng, 8, 8, 3)
    with pytest.raises(RuntimeError, match="[Ll]evel"):
        gpu_filters.box_blur(img, level=5)


@pytest.mark.parametrize("shape", [(24, 31, 3), (19, 23, 1), (17, 29, 4)])
def test_gaussian_advanced_large_radius_within_gate(rng, shape):
    """Large radii up to the weight-table cap (MAX_KERNEL_TAPS=64,
    reference image_filters.cu:729-732) hold the <=1 gate at level 4."""
    img = make_image(rng, *shape)
    for radius in (8, 15, 31):
        l2, _ = RUNTIME.gaussian_blur(img, sigma=3.0, radius=radius, level=2)
        l4, _ = RUNTIME.gaussian_blur(img, sigma=3.0, radius=radius, level=4)
        assert np.abs(l2.astype(int) - l4.astype(int)).max() <= 1
