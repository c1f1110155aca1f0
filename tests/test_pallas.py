"""Pallas kernels (blur and Sobel, written for Triton), run through the
interpreter on CPU and held to EXACT equality against the independent
numpy oracle -- the same kernel code compiles through Triton on the GPU
(tests/test_gpu.py runs it there)."""

from functools import partial

import jax
import numpy as np
import pytest

from gpu_image_processing.ops.pallas import api, blur, sobel
from gpu_image_processing.ops.weights import gaussian_kernel_f32

from . import oracle_numpy as oracle
from .conftest import make_image
from .sobel_tolerance import assert_sobel_close

SHAPES = [(24, 31, 3), (19, 23, 1), (17, 29, 4)]


@partial(jax.jit, static_argnums=(2,))
def _gauss(img, w, radius):
    return api.level2_impls(interpret=True)["gaussian"](img, w, radius)


@partial(jax.jit, static_argnums=(1,))
def _box(img, radius):
    return api.level2_impls(interpret=True)["box"](img, radius)


@jax.jit
def _sobel(img):
    return api.level2_impls(interpret=True)["sobel"](img)


def _rows_gauss(img, w, radius):
    h, wd, c = img.shape
    out = jax.jit(lambda x, ww: blur.gaussian_rows(
        x, ww, radius, c, interpret=True))(img.reshape(h, wd * c), w)
    return np.asarray(out).reshape(img.shape)


def _rows_box(img, radius):
    h, wd, c = img.shape
    out = jax.jit(lambda x: blur.box_rows(x, radius, c, interpret=True))(
        img.reshape(h, wd * c))
    return np.asarray(out).reshape(img.shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_pallas_exact(rng, shape):
    img = make_image(rng, *shape)
    w = gaussian_kernel_f32(3, 2.0)
    np.testing.assert_array_equal(
        np.asarray(_gauss(img, w, 3)), oracle.gaussian_blur(img, w, 3)
    )


def test_gaussian_pallas_max_radius(rng):
    # radius=15 (the API's upper bound, app.py:148) with a tiny image.
    img = make_image(rng, 40, 22, 3)
    w = gaussian_kernel_f32(15, 8.0)
    np.testing.assert_array_equal(_rows_gauss(img, w, 15),
                                  oracle.gaussian_blur(img, w, 15))


@pytest.mark.parametrize("shape", SHAPES)
def test_box_pallas_exact(rng, shape):
    img = make_image(rng, *shape)
    np.testing.assert_array_equal(_rows_box(img, 5), oracle.box_blur(img, 5))
    # The registry routes a small image at radius 5 to the XLA tier.
    np.testing.assert_array_equal(np.asarray(_box(img, 5)),
                                  oracle.box_blur(img, 5))


@pytest.mark.parametrize("shape", SHAPES)
def test_sobel_pallas_matches_oracle(rng, shape):
    img = make_image(rng, *shape)
    assert_sobel_close(np.asarray(_sobel(img)), oracle.sobel(img, 2))


@pytest.mark.parametrize("h", [7, 8, 9, 16, 17, 45])
def test_tile_boundary_rows(rng, h):
    # Heights around the row-band size (8 rows at these widths) put the
    # last band's end, and its halo, on every side of a boundary.
    assert blur.geometry(1, h, 17, 4)["block_rows"] == 8
    img = make_image(rng, h, 17, 1)
    w = gaussian_kernel_f32(4, 2.5)
    np.testing.assert_array_equal(_rows_gauss(img, w, 4),
                                  oracle.gaussian_blur(img, w, 4))


# ------------------------------------------------------ interleaved rows
# The serving-path kernels consume the HWC byte buffer's natural (H, W*C)
# layout; taps shift by C lanes.

@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_rows_exact(rng, shape):
    img = make_image(rng, *shape)
    wts = gaussian_kernel_f32(3, 2.0)
    np.testing.assert_array_equal(_rows_gauss(img, wts, 3),
                                  oracle.gaussian_blur(img, wts, 3))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("level", [1, 2])
def test_sobel_rows_matches_oracle(rng, shape, level):
    h, w, c = shape
    img = make_image(rng, *shape)
    got = np.asarray(jax.jit(lambda f: sobel.sobel_rows(
        f, c, quantize_gray=level == 2, interpret=True))(img.reshape(h, -1)))
    assert_sobel_close(got.reshape(h, w, c), oracle.sobel(img, level))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_box_rows_batch_exact(rng, c):
    imgs = np.stack([make_image(rng, 25, 31, c) for _ in range(3)])
    got = np.asarray(jax.jit(lambda f: blur.box_rows(
        f, 4, c, interpret=True))(imgs.reshape(3, 25, -1)))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].reshape(25, 31, c), oracle.box_blur(imgs[i], 4))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_gaussian_rows_batch_exact(rng, c):
    imgs = np.stack([make_image(rng, 21, 18, c) for _ in range(2)])
    w = gaussian_kernel_f32(2, 1.5)
    got = np.asarray(jax.jit(lambda f, ww: blur.gaussian_rows(
        f, ww, 2, c, interpret=True))(imgs.reshape(2, 21, -1), w))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].reshape(21, 18, c), oracle.gaussian_blur(imgs[i], w, 2))


def test_level4_impls_within_gate(rng):
    # ADVANCED tier: maxdiff <= 1 vs the strict-order level 2 (the
    # reference's own L1<->L2 gate); the blurs share the level-2 kernel.
    img = make_image(rng, 33, 47, 3)
    wts = gaussian_kernel_f32(3, 3.0)
    exact = np.asarray(_gauss(img, wts, 3))
    adv = np.asarray(jax.jit(
        lambda x, ww: api.level4_impls(interpret=True)["gaussian"](x, ww, 3))(
            img, wts))
    assert np.abs(exact.astype(int) - adv.astype(int)).max() <= 1


# -- radii: large halos, strips narrower than the halo, images shorter or
#    narrower than the radius ---------------------------------------------

@pytest.mark.parametrize("shape,radius", [
    ((24, 40, 4), 20),   # halo 80 lanes: a third of a 256-lane strip
    ((16, 50, 3), 31),   # the largest kernel radius
    ((10, 20, 1), 16),   # halo wider than the image
])
def test_box_large_radius_exact(rng, shape, radius):
    img = make_image(rng, *shape)
    np.testing.assert_array_equal(_rows_box(img, radius),
                                  oracle.box_blur(img, radius))


def test_box_past_kernel_radius_routes_to_xla_tier(rng):
    """Box has no radius cap (reference parity); radii past the kernel's
    register ring run the exact XLA doubling sums, at every entry point."""
    img = make_image(rng, 12, 20, 3)
    radius = blur.MAX_RADIUS + 9
    with pytest.raises(ValueError, match="radius"):
        blur.box_rows(img.reshape(12, 60), radius, 3, interpret=True)
    np.testing.assert_array_equal(np.asarray(_box(img, radius)),
                                  oracle.box_blur(img, radius))


def test_halo_spanning_strips_exact(rng):
    """Several lane strips, with a halo nearly as wide as a strip: taps
    read most of the neighbouring strips and clamp at both image edges."""
    h, w, c, radius = 9, 300, 4, 31
    assert 4 * radius * c > blur.geometry(1, h, w * c, radius)["block_lanes"]
    img = make_image(rng, h, w, c)
    np.testing.assert_array_equal(_rows_box(img, radius),
                                  oracle.box_blur(img, radius))


@pytest.mark.parametrize("h,radius", [(2, 3), (5, 7), (1, 3), (9, 8)])
def test_rowfill_height_smaller_than_radius(rng, h, radius):
    """Heights at or below the radius: every halo row of every band clamps
    to an image row, from both ends at once."""
    img = make_image(rng, h, 20, 3)
    w = gaussian_kernel_f32(radius, 2.5)
    np.testing.assert_array_equal(_rows_gauss(img, w, radius),
                                  oracle.gaussian_blur(img, w, radius))
    np.testing.assert_array_equal(_rows_box(img, radius),
                                  oracle.box_blur(img, radius))


@pytest.mark.parametrize("width", [1, 2, 5])
def test_narrow_images_clamp_columns(rng, width):
    """Images narrower than the radius clamp every tap to a real pixel."""
    img = make_image(rng, 13, width, 3)
    w = gaussian_kernel_f32(4, 2.0)
    np.testing.assert_array_equal(_rows_gauss(img, w, 4),
                                  oracle.gaussian_blur(img, w, 4))


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
def test_gaussian_radii_exact(rng, radius):
    img = make_image(rng, 33, 21, 3)
    w = gaussian_kernel_f32(radius, 2.0)
    np.testing.assert_array_equal(_rows_gauss(img, w, radius),
                                  oracle.gaussian_blur(img, w, radius))


def test_rows_kernels_reject_bad_rows(rng):
    rows = make_image(rng, 8, 10, 1).reshape(8, 10)
    with pytest.raises(ValueError, match="multiple of 3 channels"):
        blur.box_rows(rows, 2, 3, interpret=True)
    with pytest.raises(ValueError, match="multiple of 3 channels"):
        sobel.sobel_rows(rows, 3, True, interpret=True)


@pytest.mark.parametrize("batch,height,data_width,halo", [
    (1, 2146, 9717, 3), (1, 1023, 4096, 15), (8, 1023, 3072, 5),
    (1, 64, 64, 1)])
def test_geometry_fills_the_card(batch, height, data_width, halo):
    """Strips are powers of two, bands shrink until there is at least one
    program per SM (or the band is 8 rows), and warps follow strip width."""
    g = blur.geometry(batch, height, data_width, halo)
    lanes, rows = g["block_lanes"], g["block_rows"]
    assert lanes & (lanes - 1) == 0 and rows & (rows - 1) == 0
    programs = batch * -(-data_width // lanes) * -(-height // rows)
    assert programs >= 132 or rows == 8
    assert g["num_warps"] == min(8, max(1, lanes // 32))
