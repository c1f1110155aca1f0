"""Test configuration: run on a virtual 8-device CPU mesh.

The env vars must be set before jax is imported anywhere, so this lives at
the top of conftest collection.  A process that already runs JAX on a GPU
(chip_smoke.py runs the card tests in its own process) sets JAX_PLATFORMS
first, and the platform is then left alone.  The compile cache is the
runtime's own (runtime/device.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _build_native_codec() -> None:
    """Build native/build/libgip_codec.so from the repo's sources before
    the test modules import (their native tests skip without it).  One
    xdist worker builds under a file lock; the rest find it built.  A
    failed build (no compiler) leaves those tests skipped."""
    import fcntl

    from gpu_image_processing.utils import native_codec

    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "build")
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native_codec.build()
        except Exception:  # noqa: BLE001 - no toolchain: tests skip
            pass


_build_native_codec()


@pytest.fixture
def peak_table(monkeypatch):
    """Publish placeholder peaks for the CPU test device, so the profiler's
    utilization-percentage path runs here (production omits percentages
    for a device kind without published peaks)."""
    from gpu_image_processing.profiling import profiler

    kind = jax.devices()[0].device_kind
    monkeypatch.setitem(profiler.DEVICE_PEAKS, kind, (50.0, 0.5, 0.5))
    return profiler.DEVICE_PEAKS[kind]


@pytest.fixture
def on_gpu():
    """Skip unless the default JAX device is a GPU (card-only tests, marked
    `gpu`; decided here, never at import time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: card-only test")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def make_image(rng, h, w, c):
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


@pytest.fixture
def small_rgb(rng):
    return make_image(rng, 24, 31, 3)


@pytest.fixture
def small_gray(rng):
    return make_image(rng, 19, 23, 1)


@pytest.fixture
def small_rgba(rng):
    return make_image(rng, 17, 29, 4)
