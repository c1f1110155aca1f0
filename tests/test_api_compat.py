"""`gpu_filters` drop-in surface: signatures, defaults, dicts, constants,
and error behavior (backend/cuda_bindings/bindings.cpp:240-283)."""

import numpy as np
import pytest

import gpu_filters
from gpu_image_processing.core.params import ValidationError
from gpu_image_processing.core import params


def test_constants():
    assert gpu_filters.NAIVE == 1
    assert gpu_filters.SHARED_MEMORY == 2
    assert gpu_filters.TEXTURE_MEMORY == 3


@pytest.mark.parametrize(
    "call",
    [
        lambda img: gpu_filters.gaussian_blur(img),
        lambda img: gpu_filters.box_blur(img),
        lambda img: gpu_filters.sobel_edge_detection(img),
    ],
)
def test_result_dict_contract(rng, call):
    img = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)
    result = call(img)
    assert set(result) == {"image", "time_ms", "bandwidth_gbps", "fps"}
    assert result["image"].shape == img.shape
    assert result["image"].dtype == np.uint8
    assert result["time_ms"] > 0
    assert result["bandwidth_gbps"] > 0
    assert result["fps"] > 0


def test_default_kwargs(rng):
    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    a = gpu_filters.gaussian_blur(img, sigma=2.0, radius=3, level=1)
    b = gpu_filters.gaussian_blur(img)
    np.testing.assert_array_equal(a["image"], b["image"])


def test_bad_ndim_raises():
    with pytest.raises(RuntimeError, match="3D"):
        gpu_filters.gaussian_blur(np.zeros((8, 8), dtype=np.uint8))


def test_bad_channels_raises():
    with pytest.raises(RuntimeError, match="1, 3, or 4"):
        gpu_filters.box_blur(np.zeros((8, 8, 2), dtype=np.uint8))


def test_bad_level_raises(rng):
    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="[Ll]evel"):
        gpu_filters.gaussian_blur(img, level=7)
    with pytest.raises(RuntimeError, match="[Ll]evel"):
        gpu_filters.sobel_edge_detection(img, level=0)


def test_gaussian_accepts_enum_aliases(rng):
    # Unlike the reference library (which rejects SHARED_MEMORY for gaussian
    # and crashes its own tests, SURVEY 2.5), both aliases map to level 2.
    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    via2 = gpu_filters.gaussian_blur(img, level=2)
    via3 = gpu_filters.gaussian_blur(img, level=gpu_filters.TEXTURE_MEMORY)
    np.testing.assert_array_equal(via2["image"], via3["image"])


def test_oversize_radius_rejected(rng):
    # 2*32+1 = 65 > 64-tap weight table cap (image_filters.cu:729-732).
    img = rng.integers(0, 256, size=(8, 8, 1), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="64"):
        gpu_filters.gaussian_blur(img, radius=32)


def test_level_normalization_unit():
    assert params.normalize_level("gaussian", 3) == 2
    assert params.normalize_level("box", 2) == 2
    with pytest.raises(ValidationError):
        params.normalize_level("box", 3)


def test_input_not_mutated(rng):
    img = rng.integers(0, 256, size=(12, 12, 3), dtype=np.uint8)
    keep = img.copy()
    gpu_filters.gaussian_blur(img, level=2)
    np.testing.assert_array_equal(img, keep)
