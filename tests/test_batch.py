"""Batched runtime path and /api/process-batch endpoint."""

import base64
import io

import numpy as np
import pytest
from PIL import Image

from gpu_image_processing.core.params import ValidationError
from gpu_image_processing.runtime.dispatch import RUNTIME
from gpu_image_processing.server.app import create_app
from gpu_image_processing.server.http import Request

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close


def _stack(rng, b, h, w, c):
    return np.stack([make_image(rng, h, w, c) for _ in range(b)])


def test_run_batch_gaussian_matches_oracle(rng):
    imgs = _stack(rng, 4, 16, 19, 3)
    out, metrics = RUNTIME.run_batch("gaussian", imgs, level=2, sigma=2.0, radius=3)
    assert out.shape == imgs.shape
    from gpu_image_processing.ops.weights import gaussian_kernel_f32

    w = gaussian_kernel_f32(3, 2.0)
    for i in range(4):
        np.testing.assert_array_equal(out[i], oracle.gaussian_blur(imgs[i], w, 3))
    assert metrics.fps > 0 and metrics.time_ms > 0


def test_run_batch_sobel(rng):
    imgs = _stack(rng, 3, 12, 14, 1)
    out, _ = RUNTIME.run_batch("sobel", imgs, level=1)
    for i in range(3):
        assert_sobel_close(out[i], oracle.sobel(imgs[i], 1))


def test_run_batch_validates(rng):
    with pytest.raises(ValidationError, match="4D"):
        RUNTIME.run_batch("box", make_image(rng, 8, 8, 3))
    with pytest.raises(ValidationError, match="Invalid filter"):
        RUNTIME.run_batch("median", _stack(rng, 2, 8, 8, 3))


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def app():
    return create_app()


def test_endpoint_batch(rng, app):
    imgs = [_png_b64(make_image(rng, 14, 17, 3)) for _ in range(3)]
    status, body = app.dispatch(Request(
        method="POST", path="/api/process-batch",
        json={"images": imgs, "filter": "box", "level": 2, "radius": 2},
    ))
    assert status == 200
    assert len(body["processed_images"]) == 3
    assert body["metrics"]["batch_size"] == 3
    assert body["metrics"]["images_per_second"] > 0
    assert body["info"]["level"] == "shared_memory"


def test_endpoint_batch_shape_mismatch(rng, app):
    imgs = [_png_b64(make_image(rng, 14, 17, 3)), _png_b64(make_image(rng, 10, 9, 3))]
    status, body = app.dispatch(Request(
        method="POST", path="/api/process-batch",
        json={"images": imgs, "filter": "box"},
    ))
    assert status == 400
    assert "share one shape" in body["detail"]


def test_endpoint_batch_empty(app):
    status, body = app.dispatch(Request(
        method="POST", path="/api/process-batch", json={"images": [], "filter": "box"},
    ))
    assert status == 400


def test_batch_level4_large_radius_within_gate(rng):
    """Batched ADVANCED gaussian at a large radius stays within the <=1
    gate vs the batched level-2 result."""
    import numpy as np

    from gpu_image_processing.runtime.dispatch import RUNTIME

    imgs = np.stack([
        (rng.integers(0, 256, (40, 52, 3))).astype("uint8") for _ in range(3)
    ])
    l2, _ = RUNTIME.run_batch("gaussian", imgs, level=2, sigma=3.0, radius=8)
    l4, _ = RUNTIME.run_batch("gaussian", imgs, level=4, sigma=3.0, radius=8)
    assert np.abs(l2.astype(int) - l4.astype(int)).max() <= 1


def test_batch_mesh_serving(rng, monkeypatch):
    """GIP_MESH_BATCH=1: run_batch shards the batch over every attached
    device (pure dp via shard_map around the same batched kernels) --
    bit-identical to the single-chip path, any batch size (pad-and-crop)."""
    import jax

    from gpu_image_processing.ops.weights import gaussian_kernel_f32

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh (conftest forces 8 CPU devices)")
    monkeypatch.setenv("GIP_MESH_BATCH", "1")
    imgs = np.stack([make_image(rng, 40, 56, 3) for _ in range(6)])  # 6 % 8 != 0
    out, metrics = RUNTIME.run_batch("gaussian", imgs, level=2,
                                     sigma=2.0, radius=3)
    w = gaussian_kernel_f32(3, 2.0)
    for i in range(6):
        np.testing.assert_array_equal(out[i], oracle.gaussian_blur(imgs[i], w, 3))
    assert metrics.time_ms > 0
    # the mesh executable is cached under its own key (device count baked in;
    # position-independent: the key has since grown routing fields)
    assert any(k[0] == "batch" and len(jax.devices()) in k
               for k in RUNTIME._cache)

    out, _ = RUNTIME.run_batch("box", imgs, level=2, radius=4)
    for i in range(6):
        np.testing.assert_array_equal(out[i], oracle.box_blur(imgs[i], 4))


def test_profile_batch_contract(rng):
    """profile_batch deep-profiles the SERVED batch executable: categorized
    dict, provenance-tagged per-kernel rows (pass-estimate tier on the CPU
    mesh), batch provenance in config (VERDICT r3 item 6)."""
    from gpu_image_processing.profiling.profiler import (
        get_common_metrics,
        profile_batch,
    )

    imgs = _stack(rng, 3, 16, 20, 3)
    deep = profile_batch(imgs, "gaussian", 2, sigma=2.0, radius=3)
    for section in ("execution", "memory", "occupancy", "config"):
        assert section in deep
    assert deep["total_kernel_duration_ms"] > 0
    assert deep["config"]["Serving Path"] == "batch"
    assert deep["config"]["Batch Size"] == 3
    pp = deep["per_pass_durations_ms"]
    assert pp["horizontal"] > 0 and pp["vertical"] > 0
    assert pp["horizontal"] + pp["vertical"] == pytest.approx(
        deep["total_kernel_duration_ms"])

    common = get_common_metrics(deep, ncu_data=deep)
    assert common["time_ms"] == deep["total_kernel_duration_ms"]
    assert len(common["kernel_durations"]) == 2
    assert common["kernel_duration_source"] == "isolated_pass_estimate"


def test_endpoint_batch_profiling(rng, app):
    """enable_profiling on /api/process-batch: per-kernel durations under
    the reference's ncu_* key names, device time_ms never overridden."""
    imgs = [_png_b64(make_image(rng, 14, 17, 3)) for _ in range(2)]
    base = {"images": imgs, "filter": "gaussian", "level": 2,
            "sigma": 2.0, "radius": 3}
    status, body = app.dispatch(Request(
        method="POST", path="/api/process-batch",
        json={**base, "enable_profiling": True}))
    assert status == 200
    m = body["metrics"]
    assert "profiling_error" not in m
    assert m["ncu_profiled_time_ms"] > 0
    assert len(m["kernel_durations"]) == 2
    assert m["ncu_data"]["config"]["Serving Path"] == "batch"
    assert m["ncu_data"]["config"]["Batch Size"] == 2
    assert m["ncu_data"]["duration_source"] == m["kernel_duration_source"]
    # never-override-primary-time invariant (backend/app.py:391-427): the
    # profiled total lands under its own key, time_ms stays the serving
    # measurement.
    assert m["time_ms"] > 0
    assert m["kernel_duration_ms"] == m["ncu_profiled_time_ms"]
    assert m["batch_size"] == 2


def test_profile_batch_mesh(rng, monkeypatch):
    """On a GIP_MESH_BATCH deployment the profiled program is the
    dp-sharded batch executable (provenance says so)."""
    import jax

    from gpu_image_processing.profiling.profiler import profile_batch

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    monkeypatch.setenv("GIP_MESH_BATCH", "1")
    imgs = _stack(rng, 6, 16, 20, 3)  # 6 % 8 != 0: exercises the batch pad
    deep = profile_batch(imgs, "box", 2, radius=2)
    assert deep["config"]["Serving Path"] == f"batch(dp={len(jax.devices())})"
    assert deep["total_kernel_duration_ms"] > 0
