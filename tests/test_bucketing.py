"""Shape bucketing: arbitrary image sizes share compiled executables via
edge-padded bucket shapes, with bit-exact results (clamp-to-edge taps past
the true border read the edge pixel, which is exactly what every replicated
pad pixel holds; Sobel's true border is re-zeroed post-crop)."""

import numpy as np
import pytest

from gpu_image_processing.ops.weights import gaussian_kernel_f32
from gpu_image_processing.runtime import dispatch
from gpu_image_processing.runtime.dispatch import (RUNTIME, _bucket,
                                                       executable_cache_key)

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close


def test_bucket_values():
    assert _bucket(1) == 64
    assert _bucket(64) == 64
    assert _bucket(65) == 128
    assert _bucket(129) == 192
    for n in (333, 1000, 3239):
        assert _bucket(n) >= n
        assert _bucket(n) % 64 == 0


def test_gaussian_exact_across_bucket_pad(rng):
    # 100x75 pads to 128x128; result must equal the unpadded oracle.
    img = make_image(rng, 100, 75, 3)
    out, m = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=2)
    w = gaussian_kernel_f32(3, 2.0)
    np.testing.assert_array_equal(out, oracle.gaussian_blur(img, w, 3))
    assert out.shape == img.shape


def test_sobel_border_rezeroed(rng):
    img = make_image(rng, 70, 90, 3)
    out, _ = RUNTIME.sobel_edge_detection(img, level=2)
    assert_sobel_close(out, oracle.sobel(img, 2))
    assert (out[0] == 0).all() and (out[-1] == 0).all()
    assert (out[:, 0] == 0).all() and (out[:, -1] == 0).all()


def test_executable_reuse_within_bucket(rng):
    # Two different true sizes in the same bucket share one executable.
    before = len(RUNTIME._cache)
    a = make_image(rng, 97, 70, 3)
    b = make_image(rng, 100, 66, 3)   # same 128x128 bucket
    RUNTIME.box_blur(a, radius=4, level=2)
    n_after_first = len(RUNTIME._cache)
    RUNTIME.box_blur(b, radius=4, level=2)
    assert len(RUNTIME._cache) == n_after_first
    assert n_after_first > before


def test_box_batch_bucketed_exact(rng):
    imgs = np.stack([make_image(rng, 90, 77, 1) for _ in range(2)])
    out, _ = RUNTIME.run_batch("box", imgs, radius=5, level=2)
    for i in range(2):
        np.testing.assert_array_equal(out[i], oracle.box_blur(imgs[i], 5))


def test_bucketing_opt_out(rng, monkeypatch):
    monkeypatch.setenv("GIP_NO_BUCKETING", "1")
    img = make_image(rng, 33, 41, 3)
    out, _ = RUNTIME.gaussian_blur(img, sigma=2.0, radius=3, level=1)
    w = gaussian_kernel_f32(3, 2.0)
    np.testing.assert_array_equal(out, oracle.gaussian_blur(img, w, 3))
    assert dispatch.executable_cache_key("gaussian", 1, 33, 41, 3, 3) \
        in dispatch.RUNTIME._cache


def test_sobel_bucket_aligned_width_prefix_slice(rng):
    # Width exactly a bucket size + height padded: the unpad slice is a
    # CONTIGUOUS prefix view of the read-only jax output, which used to make
    # the true-border re-zeroing crash ("assignment destination is
    # read-only").
    img = make_image(rng, 48, 64, 3)
    out, _ = RUNTIME.sobel_edge_detection(img, level=2)
    # maxdiff gate only: the 0.1% diff-fraction gate is calibrated for
    # full-size images and is binomially noisy at 48x64.
    diff = np.abs(out.astype(int) - oracle.sobel(img, 2).astype(int))
    assert diff.max() <= 6
    assert (out[0] == 0).all() and (out[-1] == 0).all()
    assert (out[:, 0] == 0).all() and (out[:, -1] == 0).all()


def test_served_time_is_the_host_clock_of_one_call(rng, monkeypatch):
    # time_ms is the host clock around ONE execution ending in
    # block_until_ready: every request runs the program exactly once.
    calls = []
    img = make_image(rng, 40, 56, 3)
    RUNTIME.box_blur(img, radius=2, level=2)    # compile + warm
    key = executable_cache_key("box", 2, _bucket(40), _bucket(56), 3, 2)
    exe = RUNTIME._cache[key]
    real = exe._compiled
    monkeypatch.setattr(exe, "_compiled",
                        lambda *a: calls.append(1) or real(*a))
    out, metrics = RUNTIME.box_blur(img, radius=2, level=2)
    np.testing.assert_array_equal(out, oracle.box_blur(img, 2))
    assert metrics.time_ms > 0 and len(calls) == 1


def test_served_time_excludes_the_device_to_host_copy(rng, monkeypatch):
    # The fetch of the result (np.asarray on the device array) happens
    # after the clock stops: a slow fetch must not show in time_ms.
    import time as _time

    from gpu_image_processing.runtime import dispatch

    img = make_image(rng, 40, 56, 3)
    RUNTIME.box_blur(img, radius=2, level=2)    # compile + warm
    real = np.asarray

    def slow_fetch(x, *a, **k):
        _time.sleep(0.2)
        return real(x, *a, **k)

    monkeypatch.setattr(dispatch.np, "asarray", slow_fetch)
    _, metrics = RUNTIME.box_blur(img, radius=2, level=2)
    assert metrics.time_ms < 150.0


def test_level2_serves_the_kernels_at_every_size():
    # Every size gets the program the measured crossover picks
    # (ops/pallas/api.py::kernel_serves, PERF.md): the Pallas kernel where
    # it won on the card, the XLA tier elsewhere; level 1 is always XLA.
    from gpu_image_processing.ops.pallas.api import kernel_serves

    for h, w in ((30, 44), (1152, 1152), (2146, 3239)):
        for filt, radius in (("gaussian", 3), ("gaussian", 15), ("box", 5),
                             ("box", 15), ("sobel", 0)):
            for lvl in (2, 4):
                assert _traces_kernel(filt, lvl, radius, h, w, 3) is \
                    kernel_serves(filt, radius, h * w)
            assert not _traces_kernel(filt, 1, radius, h, w, 3)
    assert kernel_serves("gaussian", 3, 2146 * 3239)


def _traces_kernel(filt, lvl, radius, h, w, c) -> bool:
    """Whether the served program of this shape contains a Pallas call."""
    import jax

    from gpu_image_processing.runtime.dispatch import rows_fn

    spec = [jax.ShapeDtypeStruct((h, w * c), np.uint8)]
    if filt == "gaussian":
        spec.append(jax.ShapeDtypeStruct((2 * radius + 1,), np.float32))
    jaxpr = jax.make_jaxpr(rows_fn(filt, lvl, radius, w, c))(*spec)
    return "pallas_call" in str(jaxpr)


@pytest.mark.parametrize("radius,pixels,kernel", [
    (1, 64 * 64, True), (3, 64 * 64, True), (4, 512 * 512, False),
    (7, 512 * 512, False), (7, 724 * 724, True), (7, 2146 * 3239, True),
    (8, 1023 * 1024, False), (15, 1023 * 1024, False),
    (8, 2_000_000, True), (15, 2146 * 3239, True),
    (16, 2146 * 3239, False), (31, 7680 * 4320, False), (800, 10**8, False)])
def test_box_gate_is_radius_aware(radius, pixels, kernel):
    # The measured crossover (PERF.md): the kernel's O(r) taps against the
    # XLA tier's O(log r) doubling sums, by radius and pixel count.
    from gpu_image_processing.ops.pallas.api import kernel_serves

    assert kernel_serves("box", radius, pixels) is kernel


@pytest.mark.parametrize("radius,pixels,kernel", [
    (1, 64 * 64, True), (3, 256 * 256, True), (4, 256 * 256, False),
    (15, 256 * 256, False), (4, 512 * 512, True), (15, 2146 * 3239, True),
    (31, 1000 * 1000, True)])
def test_gaussian_gate_is_size_aware(radius, pixels, kernel):
    # Small images at radius > 3 run the XLA tier: the kernel's shrunken
    # row bands recompute too many halo rows there (PERF.md).
    from gpu_image_processing.ops.pallas.api import kernel_serves

    assert kernel_serves("gaussian", radius, pixels) is kernel
    assert kernel_serves("sobel", 0, pixels)


@pytest.mark.parametrize("radius,shape", [(3, (40, 60, 3)), (12, (40, 60, 3)),
                                          (20, (33, 17, 4))])
def test_box_gate_serves_both_tiers_exactly(rng, radius, shape):
    # Whichever tier the gate picks (traced shape decides), the served
    # output is exact.
    img = make_image(rng, *shape)
    for lvl in (2, 4):
        out, _ = RUNTIME.box_blur(img, radius=radius, level=lvl)
        np.testing.assert_array_equal(out, oracle.box_blur(img, radius))


def test_batch_sobel_bucket_aligned_width(rng):
    # Batch analog of the read-only border-zeroing crash: width exactly a
    # bucket, height padded -> contiguous prefix view of the jax output.
    imgs = np.stack([make_image(rng, 48, 64, 3) for _ in range(2)])
    out, _ = RUNTIME.run_batch("sobel", imgs, level=2)
    for i in range(2):
        diff = np.abs(out[i].astype(int) - oracle.sobel(imgs[i], 2).astype(int))
        assert diff.max() <= 6
        assert (out[i][0] == 0).all() and (out[i][:, -1] == 0).all()


def test_extreme_shape_output_exact(rng):
    # Functional check: the real 8K width (column-tiled kernel) with a few
    # rows; fit depends on width and radius, not height.
    img = make_image(rng, 24, 7680, 3)
    out, _ = RUNTIME.box_blur(img, radius=15, level=2)
    np.testing.assert_array_equal(out, oracle.box_blur(img, 15))


def test_radius_past_kernel_routes_to_xla_tier(rng):
    # Box has no radius cap (reference parity: boxBlur accepts any radius,
    # image_filters.cu:945); the runtime serves an extreme radius from the
    # XLA tier and matches the oracle.
    img = make_image(rng, 40, 60, 3)
    out, _ = RUNTIME.box_blur(img, radius=800, level=2)
    np.testing.assert_array_equal(out, oracle.box_blur(img, 800))
