"""Bit-fidelity of the jnp ops against the independent numpy oracle.

The reference's own fidelity gate is a pixel-exact diff between levels with
pass iff max diff <= 1 (tests/test_comparison.cu:204-221); here we hold the
level-1 jnp ops to *exact* equality against the transcribed CUDA semantics,
and the level-2 implementations to the reference's own <=1 gate vs level 1.

All jnp calls go through jitted wrappers: this host has one CPU core, and
eager per-op dispatch would compile dozens of kernels per test.
"""

from functools import partial

import jax
import numpy as np
import pytest

from gpu_image_processing.ops import fused, interleaved as il, ref
from gpu_image_processing.ops.weights import gaussian_kernel_f32

from .conftest import make_image
from . import oracle_numpy as oracle
from .sobel_tolerance import assert_sobel_close


@partial(jax.jit, static_argnums=(2,))
def _gaussian_l1(img, w, radius):
    return ref.gaussian_blur(img, w, radius)


@partial(jax.jit, static_argnums=(1,))
def _box_l1(img, radius):
    return ref.box_blur(img, radius)


@partial(jax.jit, static_argnums=(1,))
def _sobel(img, level):
    return ref.sobel(img, level)


@partial(jax.jit, static_argnums=(2,))
def _gaussian_l2(img, w, radius):
    return fused.gaussian_fused(img, w, radius)


@partial(jax.jit, static_argnums=(1,))
def _box_l2(img, radius):
    return fused.box_fused(img, radius)


SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius,sigma", [(3, 2.0), (7, 5.0)])
def test_gaussian_l1_exact(rng, shape, radius, sigma):
    img = make_image(rng, *shape)
    w = gaussian_kernel_f32(radius, sigma)
    got = np.asarray(_gaussian_l1(img, w, radius))
    want = oracle.gaussian_blur(img, w, radius)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_box_l1_exact(rng, shape):
    img = make_image(rng, *shape)
    got = np.asarray(_box_l1(img, 5))
    want = oracle.box_blur(img, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_matches_oracle(rng, shape, level):
    # C>1 allows the FMA-contraction tolerance (see sobel_tolerance.py);
    # grayscale is exact.
    img = make_image(rng, *shape)
    got = np.asarray(_sobel(img, level))
    assert_sobel_close(got, oracle.sobel(img, level))


def test_sobel_border_and_alpha(rng):
    img = make_image(rng, 10, 12, 4)
    out = np.asarray(_sobel(img, 1))
    # 1-pixel border zeroed (image_filters.cu:1164-1176).
    assert (out[0, :] == 0).all() and (out[-1, :] == 0).all()
    assert (out[:, 0] == 0).all() and (out[:, -1] == 0).all()
    # Same edge value in every channel, alpha included (cu:1311-1313).
    for c in range(1, 4):
        np.testing.assert_array_equal(out[:, :, c], out[:, :, 0])


def test_sobel_tiny_image_all_border(rng):
    # width < 3: every pixel is border -> all zeros (cu:1164).
    img = make_image(rng, 5, 2, 1)
    assert (np.asarray(_sobel(img, 1)) == 0).all()


# ---------------------------------------------------------------------------
# Level-2 implementations: numerics vs the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_l2_exact_vs_oracle(rng, shape):
    img = make_image(rng, *shape)
    w = gaussian_kernel_f32(3, 2.0)
    got = np.asarray(_gaussian_l2(img, w, 3))
    # Same f32 tap order -> exact equality (stronger than the reference's
    # own <=1 L1<->L2 gate).
    np.testing.assert_array_equal(got, oracle.gaussian_blur(img, w, 3))


@pytest.mark.parametrize("shape", SHAPES)
def test_box_l2_exact_vs_oracle(rng, shape):
    img = make_image(rng, *shape)
    got = np.asarray(_box_l2(img, 5))
    np.testing.assert_array_equal(got, oracle.box_blur(img, 5))


def test_sobel_l1_vs_l2_maxdiff(rng):
    # The gray-quantization nuance (SURVEY 2.1 N8): L2 rounds gray to uint8
    # before convolving, L1 keeps f32.  Each rounded tap is off by <=0.5 and
    # the Gx/Gy kernels have |weight| sum 8, so gradients differ by <=4 and
    # the magnitude by <=~5.7.  The CUDA reference has the same property; on
    # smooth images the observed difference is tiny.
    base = make_image(rng, 32, 33, 3)
    smooth = np.asarray(_box_l1(base, 5))
    l1 = np.asarray(_sobel(smooth, 1)).astype(int)
    l2 = np.asarray(_sobel(smooth, 2)).astype(int)
    diff = np.abs(l1 - l2)
    assert diff.max() <= 6
    assert diff.mean() < 1.0


def test_synthetic_square_smoke():
    # Analog of tests/test_gaussian_blur.cu:22-36: white square on black,
    # blur must smooth the square's edges and leave far background alone.
    img = np.zeros((64, 64, 1), dtype=np.uint8)
    img[16:48, 16:48, 0] = 255
    w = gaussian_kernel_f32(3, 2.0)
    out = np.asarray(_gaussian_l1(img, w, 3))
    assert out[32, 32, 0] > 200
    assert 0 < out[16, 16, 0] < 255
    assert out[0, 0, 0] == 0


# ---------------------------------------------------------------------------
# Interleaved rows tier (ops/interleaved.py): the serving level-1 path and
# what bench.py times for level 1 -- locked directly against the oracle.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(2, 3))
def _gaussian_rows(rows, w, radius, channels):
    return il.gaussian_rows(rows, w, radius, channels)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _box_rows(rows, radius, channels, doubling):
    return il.box_rows(rows, radius, channels, doubling=doubling)


@partial(jax.jit, static_argnums=(1, 2, 3))
def _sobel_rows(rows, level, width, channels):
    return il.sobel_rows(rows, level, width, channels)


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_rows_exact(rng, shape):
    img = make_image(rng, *shape)
    h, w_, c = img.shape
    w = gaussian_kernel_f32(3, 2.0)
    got = np.asarray(_gaussian_rows(img.reshape(h, w_ * c), w, 3, c))
    np.testing.assert_array_equal(
        got.reshape(h, w_, c), oracle.gaussian_blur(img, w, 3))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("doubling", [False, True])
def test_box_rows_exact(rng, shape, doubling):
    img = make_image(rng, *shape)
    h, w_, c = img.shape
    got = np.asarray(_box_rows(img.reshape(h, w_ * c), 5, c, doubling))
    np.testing.assert_array_equal(got.reshape(h, w_, c), oracle.box_blur(img, 5))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_rows_matches_oracle(rng, shape, level):
    img = make_image(rng, *shape)
    h, w_, c = img.shape
    got = np.asarray(_sobel_rows(img.reshape(h, w_ * c), level, w_, c))
    assert_sobel_close(got.reshape(h, w_, c), oracle.sobel(img, level))


@pytest.mark.parametrize("shape", [(24, 31, 3), (17, 29, 4), (16, 43, 3)])
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_rows_channel_equality(rng, shape, level):
    """Every channel of a pixel carries the same magnitude (cu:1311-1313).

    Regression for the input-replicated phase-0 gray: a gray scheme whose
    per-lane FMA contraction differs by phase breaks this invariant at
    level 2 (quantization tie flips between a pixel's own lanes)."""
    img = make_image(rng, *shape)
    h, w_, c = img.shape
    got = np.asarray(_sobel_rows(img.reshape(h, w_ * c), level, w_, c))
    g3 = got.reshape(h, w_, c)
    np.testing.assert_array_equal(g3, np.repeat(g3[:, :, :1], c, axis=2))
