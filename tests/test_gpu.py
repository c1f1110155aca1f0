"""Card-only tests: the Pallas kernels compiled through Triton, the platform
rule and the profiler's GPU trace.  They skip without a GPU (decided in the
`on_gpu` fixture) and run on the card in chip_smoke.py's phase 6:

    python chip_smoke.py            # or, on a GPU machine:
    python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

from gpu_image_processing.ops.weights import gaussian_kernel_f32

from . import oracle_numpy as oracle
from .conftest import make_image

pytestmark = pytest.mark.gpu


def _close(got, want, maxdiff=1, frac=1e-4):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= maxdiff and (diff > 0).mean() <= frac, (
        diff.max(), (diff > 0).mean())


def test_platform_rule_compiles_on_gpu(on_gpu):
    from gpu_image_processing.runtime import device

    assert device.platform() == "gpu"
    assert device.use_interpret() is False


def test_device_peaks_known_for_this_card(on_gpu):
    from gpu_image_processing.profiling.profiler import device_peaks

    assert device_peaks() is not None


@pytest.mark.parametrize("shape,radius", [((300, 257, 3), 4),
                                          ((129, 1000, 4), 15),
                                          ((70, 90, 1), 1)])
def test_blur_kernels_compiled(on_gpu, rng, shape, radius):
    import jax

    from gpu_image_processing.ops.pallas import blur

    img = make_image(rng, *shape)
    h, w, c = shape
    rows = img.reshape(h, w * c)
    wts = gaussian_kernel_f32(radius, 2.5)
    got = np.asarray(jax.jit(lambda x, ww: blur.gaussian_rows(
        x, ww, radius, c))(rows, wts)).reshape(shape)
    _close(got, oracle.gaussian_blur(img, wts, radius))
    got = np.asarray(jax.jit(lambda x: blur.box_rows(x, radius, c))(
        rows)).reshape(shape)
    _close(got, oracle.box_blur(img, radius))


@pytest.mark.parametrize("level", [1, 2])
def test_sobel_kernel_compiled(on_gpu, rng, level):
    import jax

    from gpu_image_processing.ops.pallas import sobel

    from .sobel_tolerance import assert_sobel_close

    img = make_image(rng, 211, 333, 3)
    got = np.asarray(jax.jit(lambda x: sobel.sobel_rows(
        x, 3, quantize_gray=level == 2))(img.reshape(211, 999)))
    assert_sobel_close(got.reshape(img.shape), oracle.sobel(img, level))


def test_profiled_request_reads_gpu_trace(on_gpu, rng):
    from gpu_image_processing.profiling.profiler import profile_filter

    m = profile_filter(make_image(rng, 256, 320, 3), "gaussian", 2,
                       sigma=2.0, radius=3)
    assert m["duration_source"] == "xplane_trace"
    assert m["kernel_durations_ms"]


def test_model_api_compiles_on_gpu(on_gpu):
    """The composable model path (models/filters.py, __graft_entry__.py)
    compiles the Triton kernels inside a caller's jit."""
    import jax

    import __graft_entry__

    fn, (img, w) = __graft_entry__.entry()
    got = np.asarray(jax.jit(fn)(img, w))
    _close(got, oracle.gaussian_blur(img, w, 3))
