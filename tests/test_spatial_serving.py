"""Row-sharded single-image serving (GIP_MESH_SPATIAL=1, VERDICT r2
item 5): the serving endpoints route large images through the
parallel/spatial.py ppermute-halo path over all attached devices, and the
outputs stay BIT-IDENTICAL to single-chip serving.

Runs on the 8-virtual-CPU-device mesh from conftest.py."""

import numpy as np
import pytest

from gpu_image_processing.runtime.dispatch import RUNTIME


@pytest.fixture
def spatial_env(monkeypatch):
    monkeypatch.setenv("GIP_MESH_SPATIAL", "1")
    # Keep test images small: 8 rows per shard is enough to exercise the
    # halo exchange without conftest-scale slowdowns.
    monkeypatch.setenv("GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "8")


def _single_chip(filter_name, img, **kw):
    out, _ = RUNTIME.run(filter_name, img, **kw)
    return out


def _spatial_keys():
    return [k for k in RUNTIME._cache if k[0] == "spatial"]


@pytest.mark.parametrize("level", [1, 2])
def test_gaussian_spatial_bit_equal(spatial_env, monkeypatch, level):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (100, 97, 3), np.uint8)  # H uneven vs sp=8
    monkeypatch.delenv("GIP_MESH_SPATIAL", raising=False)
    want = _single_chip("gaussian", img, sigma=2.0, radius=3, level=level)
    monkeypatch.setenv("GIP_MESH_SPATIAL", "1")
    # Drop any spatial executables earlier tests (or the other level
    # parametrization -- gaussian's spatial key is level-independent) left
    # behind, so "a spatial gaussian key exists afterwards" can only be
    # satisfied by THIS call actually routing spatially.
    for k in _spatial_keys():
        RUNTIME._cache.pop(k, None)
    got = _single_chip("gaussian", img, sigma=2.0, radius=3, level=level)
    assert any(k[1] == "gaussian" for k in _spatial_keys()), \
        "spatial path not taken"
    np.testing.assert_array_equal(got, want)


def test_box_spatial_bit_equal(spatial_env, monkeypatch):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (96, 64, 4), np.uint8)   # H divisible, RGBA
    monkeypatch.delenv("GIP_MESH_SPATIAL", raising=False)
    want = _single_chip("box", img, radius=5, level=2)
    monkeypatch.setenv("GIP_MESH_SPATIAL", "1")
    got = _single_chip("box", img, radius=5, level=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", [1, 2])
def test_sobel_spatial_bit_equal(spatial_env, monkeypatch, level):
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (101, 80, 3), np.uint8)  # padded bottom row
    monkeypatch.delenv("GIP_MESH_SPATIAL", raising=False)
    want = _single_chip("sobel", img, level=level)
    monkeypatch.setenv("GIP_MESH_SPATIAL", "1")
    got = _single_chip("sobel", img, level=level)
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all() and (got[0] == 0).all()


def test_small_images_stay_single_chip(spatial_env, monkeypatch):
    """Below the per-shard row floor the single-chip path serves (the
    spatial overhead would dominate); no spatial executable is built.
    At the default 64-rows-per-shard floor a bucketed 64-row image is far
    below the 8-device minimum of 512 rows."""
    monkeypatch.delenv("GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD")
    rng = np.random.default_rng(14)
    img = rng.integers(0, 256, (32, 40, 3), np.uint8)
    before = _spatial_keys()
    RUNTIME.box_blur(img, radius=3, level=2)
    assert _spatial_keys() == before


def test_grayscale_spatial(spatial_env, monkeypatch):
    rng = np.random.default_rng(15)
    img = rng.integers(0, 256, (88, 50, 1), np.uint8)
    monkeypatch.delenv("GIP_MESH_SPATIAL", raising=False)
    want = _single_chip("gaussian", img, sigma=1.0, radius=2, level=2)
    monkeypatch.setenv("GIP_MESH_SPATIAL", "1")
    got = _single_chip("gaussian", img, sigma=1.0, radius=2, level=2)
    np.testing.assert_array_equal(got, want)


def test_profile_filter_spatial(spatial_env):
    """Deep profiling on a spatial-serving deployment times the ROW-SHARDED
    executable the runtime actually serves, with provenance in config
    (VERDICT r3 item 6: the single-chip cache key used to find nothing)."""
    from gpu_image_processing.profiling.profiler import (
        get_common_metrics,
        profile_filter,
    )

    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (100, 97, 3), np.uint8)
    deep = profile_filter(img, "gaussian", 2, sigma=2.0, radius=3)
    assert deep["config"]["Serving Path"] == "spatial"
    assert deep["total_kernel_duration_ms"] > 0
    # Per-kernel rows survive (pass-ratio estimate on the CPU mesh; the
    # xplane tier takes over on a GPU trace).
    pp = deep["per_pass_durations_ms"]
    assert pp["horizontal"] > 0 and pp["vertical"] > 0
    common = get_common_metrics(deep, ncu_data=deep)
    assert common["time_ms"] == deep["total_kernel_duration_ms"]
    # The spatial executable itself was the profiled program.
    assert any(k[0] == "spatial" and k[1] == "gaussian"
               for k in RUNTIME._cache)


def test_profile_filter_single_chip_provenance(spatial_env, monkeypatch):
    """Without the spatial route (small image) the provenance says
    single_chip -- readers can tell which program the numbers describe."""
    from gpu_image_processing.profiling.profiler import profile_filter

    monkeypatch.setenv("GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "4096")
    rng = np.random.default_rng(22)
    img = rng.integers(0, 256, (24, 30, 3), np.uint8)
    deep = profile_filter(img, "sobel", 2)
    assert deep["config"]["Serving Path"] == "single_chip"
