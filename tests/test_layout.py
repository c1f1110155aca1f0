"""MXU permutation-matmul layout ops: bit-exactness on every shape class."""

import jax
import numpy as np
import pytest

from gpu_image_processing.ops import layout

from .conftest import make_image


@pytest.mark.parametrize("shape", [(24, 31, 3), (17, 29, 4), (5, 7, 1),
                                   (128, 128, 3), (1, 300, 3)])
def test_deinterleave_exact(rng, shape):
    h, w, c = shape
    img = make_image(rng, h, w, c)
    got = np.asarray(jax.jit(
        lambda x: layout.deinterleave(x, h, w, c)
    )(img.reshape(-1)))
    np.testing.assert_array_equal(got, img.transpose(2, 0, 1))


@pytest.mark.parametrize("shape", [(24, 31, 3), (17, 29, 4), (5, 7, 1)])
def test_interleave_exact(rng, shape):
    h, w, c = shape
    img = make_image(rng, h, w, c)
    planar = img.transpose(2, 0, 1).copy()
    got = np.asarray(jax.jit(layout.interleave)(planar))
    np.testing.assert_array_equal(got, img.reshape(-1))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_broadcast_interleave_exact(rng, channels):
    g = rng.integers(0, 256, (19, 23), dtype=np.uint8)
    got = np.asarray(jax.jit(
        lambda x: layout.broadcast_interleave(x, channels)
    )(g))
    want = np.repeat(g.reshape(-1), channels)
    np.testing.assert_array_equal(got, want)


def test_roundtrip_f32(rng):
    img = make_image(rng, 33, 65, 3)
    f = jax.jit(lambda x: layout.interleave(
        layout.deinterleave(x, 33, 65, 3, out_f32=True)
    ))
    np.testing.assert_array_equal(np.asarray(f(img.reshape(-1))), img.reshape(-1))
