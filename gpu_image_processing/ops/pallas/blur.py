"""Single-pass separable blur as one Pallas kernel through Triton.

The CUDA reference blurs in two launches with a uint8 temp buffer in
global memory between them (gaussianBlur, image_filters.cu:811-875; boxBlur
over shared-memory tiles, :1053-1069).  This kernel does both passes in one
launch and the uint8 intermediate never reaches device memory:

* the grid is (batch, lane strip, row band) over the (B, H, W*C) rows
  layout the runtime ships across the host boundary;
* a program walks its band's input rows (plus `radius` halo rows on each
  side) in a loop.  For each input row it computes the horizontal pass over
  its lane strip, quantizes it to uint8 exactly as the reference's temp
  buffer does (`(unsigned char)(sum + 0.5f)`), and keeps the last 2r+1 such
  rows in a ring of register vectors (loop-carried values);
* each output row is the vertical pass over that ring, summed in tap order;
* clamp-to-edge comes from clamped index vectors -- the reference's
  `min(max(.))` -- so no padded copy of the image is ever built.

Numerics per pass (bit-identical to tests/oracle_numpy.py in interpret
mode; on the GPU the compiler may contract a multiply-add into an FMA):
  gaussian: sum_t pixel*w[t]  -> floor(x+0.5)      (image_filters.cu:98,102)
  box:      (sum_t pixel)*inv -> floor(x+0.5)      (image_filters.cu:390-394)

Levels 2 and 4 share this kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..weights import box_inv_taps_f32

#: Streaming multiprocessors on an H100: the geometry keeps at least one
#: program per SM.
_SMS = 132

#: Largest radius the kernel takes: its ring holds 2r+1 rows in registers.
#: The same cap as the reference's 64-float weight table
#: (image_filters.cu:729-732).
MAX_RADIUS = 31

def quant(x: jnp.ndarray) -> jnp.ndarray:
    """floor(x + 0.5) clamped to [0, 255], kept in f32."""
    return jnp.minimum(jnp.maximum(jnp.floor(x + jnp.float32(0.5)),
                                   jnp.float32(0.0)), jnp.float32(255.0))


@functools.lru_cache(maxsize=None)
def geometry(batch: int, height: int, data_width: int, halo: int) -> dict:
    """Block sizes and launch parameters for one (B, H, W*C, halo).

    256-lane strips (masked past W*C) with 8 warps.  Row bands start long
    enough to amortize the 2*halo rows each band recomputes (32 rows for
    halos up to 7, else 128) and halve while the grid holds fewer programs
    than the card has SMs.  Chosen from a sweep of strip width, band height
    and warps on an H100 at 3239x2146 RGB and 1024x1023 RGBA (PERF.md).
    """
    lanes = min(256, max(32, pl.next_power_of_2(data_width)))
    rows = min(32 if halo <= 7 else 128, max(8, pl.next_power_of_2(height)))
    strips = pl.cdiv(data_width, lanes)
    while rows > 8 and batch * strips * pl.cdiv(height, rows) < _SMS:
        rows //= 2
    return {"block_lanes": lanes, "block_rows": rows,
            "num_warps": min(8, max(1, lanes // 32))}


def launch(kernel, rows: jnp.ndarray, operands: tuple, halo: int,
           interpret: bool, name: str) -> jnp.ndarray:
    """Run a (batch, strip, band) rows kernel on (H, W*C) or (B, H, W*C)."""
    squeeze = rows.ndim == 2
    if squeeze:
        rows = rows[None]
    batch, height, data_width = rows.shape
    geo = geometry(batch, height, data_width, halo)
    out = pl.pallas_call(
        functools.partial(kernel, block_lanes=geo["block_lanes"],
                          block_rows=geo["block_rows"]),
        out_shape=jax.ShapeDtypeStruct(rows.shape, jnp.uint8),
        grid=(batch, pl.cdiv(data_width, geo["block_lanes"]),
              pl.cdiv(height, geo["block_rows"])),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=geo["num_warps"], num_stages=1),
        interpret=interpret,
        name=name,
    )(rows, *operands)
    return out[0] if squeeze else out


def _blur_kernel(x_ref, w_ref, o_ref, *, radius: int, channels: int,
                 box_mode: bool, inv: float, block_lanes: int,
                 block_rows: int):
    b = pl.program_id(0)
    strip = pl.program_id(1)
    band = pl.program_id(2)
    height, data_width = x_ref.shape[1], x_ref.shape[2]
    taps = 2 * radius + 1

    out_lane = strip * block_lanes + jnp.arange(block_lanes, dtype=jnp.int32)
    lane_ok = out_lane < data_width
    # Lanes past W*C compute on the last lane and are never stored.
    lane = jnp.minimum(out_lane, data_width - 1)
    # Clamp-to-edge replicates PIXELS: a tap t pixels away reads lane
    # l + t*C, clamped into [ch, W*C - C + ch] for the lane's channel ch.
    lo = lane % channels
    hi = lo + (data_width - channels)
    weights = None if box_mode else [w_ref[t] for t in range(taps)]

    def weighted_sum(values):
        acc = None
        for t, v in enumerate(values):
            term = v if box_mode else v * weights[t]
            acc = term if acc is None else acc + term
        return quant(acc * jnp.float32(inv) if box_mode else acc)

    def hpass(row):
        row = jnp.minimum(jnp.maximum(row, 0), height - 1)
        return weighted_sum(
            plgpu.load(x_ref.at[b, row, jnp.minimum(jnp.maximum(
                lane + (t - radius) * channels, lo), hi)]).astype(jnp.float32)
            for t in range(taps))

    row0 = band * block_rows
    # Prologue: fill the ring with the band's first 2r horizontal rows.
    ring = tuple(jnp.zeros((block_lanes,), jnp.float32)
                 for _ in range(taps - 1))
    if taps > 1:
        ring = jax.lax.fori_loop(
            0, taps - 1,
            lambda i, ring: ring[1:] + (hpass(row0 - radius + i),), ring)

    def step(j, ring):
        window = ring + (hpass(row0 + radius + j),)
        out_row = row0 + j
        plgpu.store(o_ref.at[b, jnp.minimum(out_row, height - 1), out_lane],
                    weighted_sum(window).astype(jnp.uint8),
                    mask=lane_ok & (out_row < height))
        return window[1:]

    jax.lax.fori_loop(0, block_rows, step, ring)


def _blur(rows: jnp.ndarray, weights, radius: int, channels: int,
          box_mode: bool, interpret: bool) -> jnp.ndarray:
    if rows.shape[-1] % channels:
        raise ValueError(f"row width {rows.shape[-1]} is not a multiple of "
                         f"{channels} channels")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside [1, {MAX_RADIUS}]")
    if box_mode:
        weights = jnp.zeros((2 * radius + 1,), jnp.float32)
    kernel = functools.partial(
        _blur_kernel, radius=radius, channels=channels, box_mode=box_mode,
        inv=float(box_inv_taps_f32(radius)) if box_mode else 0.0)
    return launch(kernel, rows, (jnp.asarray(weights, jnp.float32),),
                  radius, interpret, "box_rows" if box_mode else "gaussian_rows")


def gaussian_rows(rows: jnp.ndarray, weights, radius: int, channels: int,
                  interpret: bool = False) -> jnp.ndarray:
    """(H, W*C) or (B, H, W*C) u8 -> u8 separable Gaussian."""
    return _blur(rows, weights, radius, channels, False, interpret)


def box_rows(rows: jnp.ndarray, radius: int, channels: int,
             interpret: bool = False) -> jnp.ndarray:
    """(H, W*C) or (B, H, W*C) u8 -> u8 separable box blur."""
    return _blur(rows, None, radius, channels, True, interpret)
