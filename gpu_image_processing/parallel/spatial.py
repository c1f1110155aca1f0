"""Spatially-sharded filtering: image rows split across devices.

This is the multi-device generalization of the reference's shared-memory
halo tiles (boxBlurHorizontalShared's cooperative halo loads,
cuda_lib/src/image_filters.cu:489-513): there the halo comes from global
memory into one SM's shared memory; here each device holds a contiguous
band of rows and the vertical pass's halo rows arrive from the neighbours
through a `jax.lax.ppermute` collective.  The horizontal pass is
embarrassingly parallel (full width is local); only the vertical pass needs
`radius` rows from each neighbor.  Global top/bottom edges use clamp-to-edge
replication, matching the single-device semantics
(image_filters.cu:129-134).

Every shard runs the function single-device serving runs, so outputs are
bit-identical to it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def exchange_halo_rows(x: jnp.ndarray, radius: int, axis_name: str = "sp",
                       axis: int = -2) -> jnp.ndarray:
    """Extend a local row-band with `radius` halo rows per side along `axis`.

    Interior shards receive neighbor rows via two ppermute rings; the global
    first/last shard replicate their own edge row (clamp-to-edge).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    hl = x.shape[axis]

    def rows(start, size):
        return jax.lax.slice_in_dim(x, start, start + size, axis=axis)

    top_rows = rows(0, radius)
    bot_rows = rows(hl - radius, radius)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # my bottom rows -> next shard
    bwd = [(i, (i - 1) % n) for i in range(n)]   # my top rows -> prev shard
    halo_top = jax.lax.ppermute(bot_rows, axis_name, fwd)   # from prev shard
    halo_bot = jax.lax.ppermute(top_rows, axis_name, bwd)   # from next shard
    edge_top = jnp.broadcast_to(rows(0, 1), top_rows.shape)
    edge_bot = jnp.broadcast_to(rows(hl - 1, 1), bot_rows.shape)
    halo_top = jnp.where(idx == 0, edge_top, halo_top)
    halo_bot = jnp.where(idx == n - 1, edge_bot, halo_bot)
    return jnp.concatenate([halo_top, x, halo_bot], axis=axis)


# ---------------------------------------------------------------------------
# Per-shard step body (runs inside shard_map; x is the local block)
#
# Each shard exchanges RAW halo rows with its neighbours and then runs the
# very function single-device serving runs (runtime/dispatch.py::rows_fn)
# on its extended band.  Rows are filtered independently across the width,
# and the band's clamped outer rows are cropped, so the sharded output is
# bit-identical to single-device serving.
# ---------------------------------------------------------------------------


def _zero_global_border_rows(out_u8: jnp.ndarray) -> jnp.ndarray:
    """Zero rows whose GLOBAL index is 0 or H-1 (image_filters.cu:1164).

    out_u8: (B, Hl, W, C); local row j is global row sp_index*Hl + j.
    Width borders are already zeroed per shard (W is fully local).
    """
    _, hl, _, _ = out_u8.shape
    n = jax.lax.axis_size("sp")
    idx = jax.lax.axis_index("sp")
    grow = idx * hl + jax.lax.broadcasted_iota(jnp.int32, (1, hl, 1, 1), 1)
    row_ok = (grow >= 1) & (grow <= n * hl - 2)
    return jnp.where(row_ok, out_u8, jnp.uint8(0))


def _shard_body(local_u8: jnp.ndarray, *rest, filter_name: str, level: int,
                radius: int) -> jnp.ndarray:
    """local_u8: (B_local, H_local, W, C) -> same, filtered."""
    from ..runtime.dispatch import rows_fn

    b, hl, width, channels = local_u8.shape
    halo = spatial_halo(filter_name, radius)
    rows = local_u8.reshape(b, hl, width * channels)
    ext = exchange_halo_rows(rows, halo)             # (B, Hl + 2*halo, W*C)
    fn = rows_fn(filter_name, level, radius, width, channels)
    out = fn(ext, *rest)[:, halo:halo + hl].reshape(b, hl, width, channels)
    if filter_name == "sobel":
        # The extended band zeroed its own first/last rows (cropped); the
        # global first/last rows must be zero too.
        out = _zero_global_border_rows(out)
    return out


# ---------------------------------------------------------------------------
# Public builders
# ---------------------------------------------------------------------------


def _specs(mesh: Mesh):
    batch_spec = P("dp", "sp", None, None)   # (B, H, W, C): B over dp, H over sp
    return batch_spec


def spatial_halo(filter_name: str, radius: int) -> int:
    """Halo rows each shard needs from its neighbor (sobel: 1; blurs: r)."""
    return 1 if filter_name == "sobel" else radius


def spatial_h_target(h: int, sp: int, filter_name: str, radius: int) -> int:
    """The mesh-divisible padded height `make_sharded_filter` computes.

    Exposed so callers that pre-pad on the HOST (runtime/dispatch.py's
    spatial serving, which must commit the operand already divisible so no
    in-graph pad/reshard lands in the timed program) use the SAME formula
    the in-graph pad would -- a divergence here would silently reintroduce
    the reshard into the measured call.
    """
    return sp * max(-(-h // sp), spatial_halo(filter_name, radius))


def make_sharded_filter(
    mesh: Mesh,
    filter_name: str,
    radius: int = 3,
    level: int = 2,
):
    """Build a jitted (dp, sp)-sharded batch filter step.

    Input: any (B, H, W, C) uint8.  Gaussian additionally takes a (2r+1,)
    f32 weight vector (replicated).

    Shapes that don't tile the mesh (B % dp != 0, H % sp != 0, or fewer
    than `halo` rows per shard) are edge-padded up to the divisible shape,
    filtered, and cropped back -- the same pad-and-crop trick the
    single-device runtime uses for shape bucketing (runtime/dispatch.py).
    Bit-exactness survives because edge padding replicates the clamp row:
    every tap an in-image output row reads from the pad region carries
    exactly the value clamp-to-edge would have produced.  Sobel's global
    bottom border row is re-zeroed after the crop (the in-graph zeroing hit
    the padded bottom row instead).
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    spec = _specs(mesh)
    sharding = NamedSharding(mesh, spec)

    if filter_name not in ("gaussian", "box", "sobel"):
        raise ValueError(f"Unknown filter: {filter_name}")
    body = partial(_shard_body, filter_name=filter_name, level=level,
                   radius=radius if filter_name != "sobel" else 0)
    in_specs = (spec, P()) if filter_name == "gaussian" else (spec,)

    shard_fn = jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=spec,
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )

    def fn(batch, *rest):
        b, h = batch.shape[0], batch.shape[1]
        pad_b = -b % dp
        h_target = spatial_h_target(h, sp, filter_name, radius)
        pad_h = h_target - h
        if pad_b or pad_h:
            batch = jnp.pad(
                batch, ((0, pad_b), (0, pad_h), (0, 0), (0, 0)), mode="edge"
            )
        batch = jax.lax.with_sharding_constraint(batch, sharding)
        out = shard_fn(batch, *rest)
        if pad_b or pad_h:
            out = out[:b, :h]
            if filter_name == "sobel" and pad_h:
                out = out.at[:, h - 1].set(jnp.uint8(0))
        return out

    return jax.jit(fn)
