"""Filter dispatch: executable cache, per-call timing, and the metrics triplet.

This replaces the reference's host orchestrators
(`gaussianBlur`/`boxBlur`/`sobelEdgeDetection`, image_filters.cu:679-1119,
1603-1739) plus the pybind bridge (bindings.cpp).  Where the reference does
per-call cudaMalloc/cudaMemcpy/kernel-launch, we keep a cache of XLA
executables keyed on the static trace signature (filter, level, H, W, C,
radius) and pass sigma-dependent weights as a traced operand so changing
sigma never recompiles.

Timing mirrors the CUDA-event discipline of bracketing the device work
only: host->device transfer, weight generation, PNG codec and compilation
happen outside the timed region (image_filters.cu:804-894).  `time_ms` is
the host clock around one execution that ends in `block_until_ready`.

All host<->device crossings use (H, W*C) interleaved uint8 ROWS -- the
same HWC byte order as the reference's flat cudaMemcpy (bindings.cpp:42,77)
viewed 2-D, which costs nothing on the host, and the layout every served
kernel consumes natively.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

import jax
import numpy as np

from ..core import config
from ..core.metrics import PerformanceMetrics, compute_metrics
from ..core.params import (
    FILTERS,
    ValidationError,
    normalize_level,
    validate_box_params,
    validate_gaussian_params,
    validate_image_shape,
)
from ..ops.weights import gaussian_kernel_f32
from .device import default_device, use_interpret


def rows_fn(filter_name: str, level: int, radius: int, width: int,
            channels: int) -> Callable:
    """The served (..., H, W*C) u8 -> u8 function of one filter and level
    (ops/pallas/api.py::rows_fn routes it), Pallas interpreted on the CPU
    backend.  Gaussian fns take the (2r+1,) weights as a second operand."""
    from ..ops.pallas import api

    return api.rows_fn(filter_name, level, radius, width, channels,
                       use_interpret())


def executable_cache_key(filter_name: str, lvl: int, height: int, width: int,
                         channels: int, radius: int | None = None) -> tuple:
    """The single-image executable cache key for a BUCKETED shape.

    THE one place the key layout lives: the profiler locates the served
    executable with it, and tests assert against it."""
    if filter_name == "sobel":
        return ("sobel", lvl, height, width, channels)
    return (filter_name, lvl, height, width, channels, radius)


def batch_cache_key(filter_name: str, lvl: int, batch: int, height: int,
                    width: int, channels: int,
                    radius: int | None = None) -> tuple:
    """The batched-program executable cache key (same single-source rule
    as executable_cache_key: the deep profiler locates the served batch
    executable with it -- profiling/profiler.py::profile_batch)."""
    return ("batch", filter_name, lvl, batch, height, width, channels,
            radius if filter_name != "sobel" else None,
            _mesh_batch_devices())


def _mesh_batch_devices() -> int:
    """Device count for the multi-device batch serving path, or 0.

    Opt-in (GIP_MESH_BATCH=1): when several devices are attached, the
    batch endpoint shards the image batch over all of them (pure data
    parallelism -- zero collectives, the per-shard work is the SAME
    batched trace the single-device path uses).
    """
    if os.environ.get("GIP_MESH_BATCH", "0") != "1":
        return 0
    n = len(jax.devices())
    return n if n > 1 else 0


def _mesh_batch_shardings(n_dev: int):
    """(batch sharding, replicated sharding) for the dp-only serving mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import make_mesh

    mesh = make_mesh(n_dev, dp=n_dev, sp=1)
    return NamedSharding(mesh, P("dp", None, None)), NamedSharding(mesh, P())


def _trace_batch_mesh(filter_name: str, level: int, radius: int,
                      w_: int, c: int, n_dev: int) -> Callable:
    """Batch trace fn sharded over `n_dev` devices on the batch axis.

    shard_map around the local batched trace fn: each device filters its
    contiguous slice of the batch with the very same kernels, XLA inserts
    no collectives.  The caller pads the batch on the HOST to a multiple
    of the device count (edge-replicated images; data parallelism is
    per-image so pad images cannot affect real outputs) and device_puts
    the operands with the dp sharding before the timed call.
    """
    from jax.sharding import PartitionSpec as P

    local_fn = rows_fn(filter_name, level, radius, w_, c)
    batch_sh, _ = _mesh_batch_shardings(n_dev)
    n_extra = 1 if filter_name == "gaussian" else 0
    return jax.shard_map(
        local_fn, mesh=batch_sh.mesh,
        in_specs=(P("dp", None, None),) + (P(),) * n_extra,
        out_specs=P("dp", None, None),
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )


def _mesh_spatial_devices(height: int) -> int:
    """Device count for row-sharded single-image serving, or 0.

    Opt-in (GIP_MESH_SPATIAL=1): with several devices attached, the
    single-image endpoints split the image's ROWS over an sp-only mesh --
    each device filters a contiguous row band and the vertical pass's halo
    rows arrive through a ppermute collective (parallel/spatial.py; the
    multi-device analog of the reference's shared-memory halo tiles,
    image_filters.cu:489-513).  Only images with at least
    GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD rows per device (default 64)
    route here: below that the collective and per-shard launch overhead
    dwarf the row work.
    """
    if os.environ.get("GIP_MESH_SPATIAL", "0") != "1":
        return 0
    n = len(jax.devices())
    if n <= 1:
        return 0
    try:
        min_rows = int(
            os.environ.get("GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "64"))
    except ValueError:
        min_rows = 64
    return n if height >= n * min_rows else 0


def _mesh_spatial_shardings(n_dev: int):
    """(mesh, row-sharded (B,H,W,C) sharding, replicated sharding)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import make_mesh

    mesh = make_mesh(n_dev, dp=1, sp=n_dev)
    return (mesh, NamedSharding(mesh, P(None, "sp", None, None)),
            NamedSharding(mesh, P()))


class FilterExecutable:
    """One compiled filter: an AOT-compiled XLA executable + its timing.

    Compilation and the program's first (untimed) execution happen once,
    under a lock; every call after that times one execution on the host
    clock, ending in `block_until_ready`.
    """

    def __init__(self, fn: Callable):
        self._raw_fn = fn
        self.fn = jax.jit(fn)
        self._compiled = None
        self._compile_lock = threading.Lock()

    def compiled(self, *args):
        if self._compiled is None:
            # Lock: concurrent first requests would each pay the compile.
            with self._compile_lock:
                if self._compiled is None:
                    compiled = self.fn.lower(*args).compile()
                    # Untimed warmup: the program loads on its first run.
                    compiled(*args).block_until_ready()
                    self._compiled = compiled
        return self._compiled

    def __call__(self, *args) -> tuple[np.ndarray, float]:
        """Run and return (output rows as numpy, device time in ms)."""
        compiled = self.compiled(*args)
        t0 = time.perf_counter()
        out = compiled(*args)
        out.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0
        return np.asarray(out), ms


# ---------------------------------------------------------------------------
# Shape bucketing
#
# XLA compiles per static shape; a serving host seeing arbitrary image sizes
# would pay a multi-second compile per novel shape (the CUDA reference's
# kernels are shape-dynamic and never recompile).  Images are therefore
# padded up to a geometric bucket grid with EDGE REPLICATION, filtered at the
# bucket shape, and cropped back.  This is bit-exact: clamp-to-edge taps
# beyond the true border read the edge pixel, and every replicated pad pixel
# equals that edge pixel; Sobel's true 1-px border is re-zeroed after the
# crop (the padded run treats those pixels as interior).
# Opt out with GIP_NO_BUCKETING=1 (e.g. for fixed-shape pipelines).
# ---------------------------------------------------------------------------

# Geometric bucket ratio: smaller = less padded-pixel overhead per served
# request, more executables to compile (the persistent compile cache
# amortizes them across processes).  1.15 costs 30 buckets in [64, 16384]
# and inflates the flagship image's served pixels by 1.06x.
def _bucket_ratio() -> float:
    """Env-supplied grid ratio, validated: a ratio <= 1.0 would make the
    grid loop below spin forever (int(64*1.0) never grows), and garbage
    must not crash import."""
    try:
        r = float(os.environ.get("GIP_BUCKET_RATIO", "1.15"))
    except ValueError:
        return 1.15
    return r if 1.01 <= r <= 4.0 else 1.15


_BUCKET_RATIO = _bucket_ratio()

_BUCKETS: list[int] = [64]
while _BUCKETS[-1] < 16384:
    nxt = ((int(_BUCKETS[-1] * _BUCKET_RATIO) + 63) // 64) * 64
    _BUCKETS.append(max(nxt, _BUCKETS[-1] + 64))


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if b >= n:
            return b
    return n


def _bucketing_enabled() -> bool:
    return os.environ.get("GIP_NO_BUCKETING", "0") != "1"


def _pad_to_bucket(image: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(H, W, C) u8 -> edge-padded (Hb, Wb, C); returns (padded, H, W)."""
    h, w = image.shape[:2]
    hb, wb = _bucket(h), _bucket(w)
    if (hb, wb) == (h, w):
        return image, h, w
    return (
        np.pad(image, ((0, hb - h), (0, wb - w), (0, 0)), mode="edge"),
        h,
        w,
    )


def _zero_true_border(out: np.ndarray) -> np.ndarray:
    """Re-apply Sobel's 1-px border zeroing at the TRUE image border of an
    (H, W, C) or (B, H, W, C) result."""
    if not out.flags.writeable:
        # The unpadding slice is contiguous when only H was bucketed, so
        # ascontiguousarray hands back the read-only jax-backed array.
        out = out.copy()
    out[..., 0, :, :] = 0
    out[..., -1, :, :] = 0
    out[..., :, 0, :] = 0
    out[..., :, -1, :] = 0
    return out


class FilterRuntime:
    """Executable cache + public run API.  Thread-safe for CPython use."""

    def __init__(self):
        self._cache: dict[tuple, FilterExecutable] = {}
        self._build_lock = threading.Lock()

    def _get(self, key: tuple, build: Callable[[], FilterExecutable]) -> FilterExecutable:
        exe = self._cache.get(key)
        if exe is None:
            # Serialize builds: concurrent requests for the same novel shape
            # would otherwise each compile the program.
            with self._build_lock:
                exe = self._cache.get(key)
                if exe is None:
                    exe = build()
                    self._cache[key] = exe
        return exe

    def _run_single(self, filter_name: str, lvl: int, image: np.ndarray,
                    radius: int, weights, true_h: int, true_w: int,
                    bucketed: bool) -> tuple[np.ndarray, PerformanceMetrics]:
        height, width, channels = image.shape
        n_sp = _mesh_spatial_devices(height)
        if n_sp:
            return self._run_spatial_attempt(
                filter_name, lvl, image, height, width, channels, radius,
                weights, true_h, true_w, bucketed, n_sp)
        key = executable_cache_key(filter_name, lvl, height, width, channels,
                                   radius)
        exe = self._get(key, lambda: FilterExecutable(
            rows_fn(filter_name, lvl, radius, width, channels)))
        dev = default_device()
        args = [jax.device_put(image.reshape(height, -1), dev)]
        if weights is not None:
            args.append(jax.device_put(weights, dev))
        jax.block_until_ready(args)
        out, ms = exe(*args)
        out = out.reshape(height, width, channels)[:true_h, :true_w]
        if filter_name == "sobel" and bucketed:
            # The padded run treated the true border as interior; restore
            # the reference's border zeroing (image_filters.cu:1164-1176).
            out = _zero_true_border(np.ascontiguousarray(out))
        return out, compute_metrics(
            ms, true_w, true_h, channels, FILTERS[filter_name].bytes_factor)

    @staticmethod
    def _prepare(image: np.ndarray) -> tuple[np.ndarray, int, int, bool]:
        true_h, true_w, _ = validate_image_shape(image.shape)
        image = np.ascontiguousarray(image, dtype=np.uint8)
        if _bucketing_enabled():
            image, _, _ = _pad_to_bucket(image)
        return image, true_h, true_w, image.shape[:2] != (true_h, true_w)

    # -- public API --------------------------------------------------------

    def gaussian_blur(
        self,
        image: np.ndarray,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        image, true_h, true_w, bucketed = self._prepare(image)
        lvl = normalize_level("gaussian", level)
        validate_gaussian_params(sigma, radius)
        return self._run_single("gaussian", lvl, image, radius,
                                gaussian_kernel_f32(radius, float(sigma)),
                                true_h, true_w, bucketed)

    def box_blur(
        self,
        image: np.ndarray,
        radius: int = config.DEFAULT_RADIUS,
        level: int = config.DEFAULT_LEVEL,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        image, true_h, true_w, bucketed = self._prepare(image)
        lvl = normalize_level("box", level)
        validate_box_params(radius)
        return self._run_single("box", lvl, image, radius, None,
                                true_h, true_w, bucketed)

    def sobel_edge_detection(
        self, image: np.ndarray, level: int = config.DEFAULT_LEVEL
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        image, true_h, true_w, bucketed = self._prepare(image)
        lvl = normalize_level("sobel", level)
        return self._run_single("sobel", lvl, image, 0, None,
                                true_h, true_w, bucketed)

    def run(
        self,
        filter_name: str,
        image: np.ndarray,
        level: int = 1,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        """Generic entry used by the server layer."""
        if filter_name == "gaussian":
            return self.gaussian_blur(image, sigma=sigma, radius=radius, level=level)
        if filter_name == "box":
            return self.box_blur(image, radius=radius, level=level)
        if filter_name == "sobel":
            return self.sobel_edge_detection(image, level=level)
        raise ValidationError(
            f"Invalid filter: {filter_name}. Must be 'gaussian', 'box', or 'sobel'"
        )

    def _spatial_handle(self, filter_name, lvl, image, height, width,
                        channels, radius, weights, n_dev):
        """(key, exe, args, h_target) for the row-sharded config: the
        executable plus sharded, committed operands -- shared by serving
        (_run_spatial_attempt) and the deep profiler (profile_filter's
        spatial tier), so both trace the SAME served program.

        The host edge-pads H up to the mesh-divisible shape so the
        committed operand needs no in-graph pad or reshard (the same
        pad-and-crop trick shape bucketing uses; edge rows are the exact
        clamp-to-edge tap content, so outputs stay bit-identical to
        single-device serving).
        """
        from ..parallel.spatial import make_sharded_filter, spatial_h_target

        key = ("spatial", filter_name, lvl, height, width, channels,
               radius if filter_name != "sobel" else None, n_dev)
        mesh, img_sh, repl_sh = _mesh_spatial_shardings(n_dev)
        h_target = spatial_h_target(height, n_dev, filter_name, radius)
        exe = self._get(key, lambda: FilterExecutable(make_sharded_filter(
            mesh, filter_name, radius=radius, level=lvl)))
        img4 = image.reshape(1, height, width, channels)
        if h_target != height:
            img4 = np.pad(
                img4, ((0, 0), (0, h_target - height), (0, 0), (0, 0)),
                mode="edge")
        args = [jax.device_put(img4, img_sh)]
        if weights is not None:
            args.append(jax.device_put(weights, repl_sh))
        jax.block_until_ready(args)
        return key, exe, args, h_target

    def spatial_profile_handle(self, filter_name, lvl, image, radius,
                               weights):
        """(key, exe, args) of the served row-sharded executable, or None
        when spatial serving is not active for this shape."""
        height, width, channels = image.shape
        n_dev = _mesh_spatial_devices(height)
        if not n_dev:
            return None
        key, exe, args, _ = self._spatial_handle(
            filter_name, lvl, image, height, width, channels,
            radius if filter_name != "sobel" else 0, weights, n_dev)
        return key, exe, args

    def _run_spatial_attempt(self, filter_name, lvl, image, height, width,
                             channels, radius, weights, true_h, true_w,
                             bucketed, n_dev):
        """Row-sharded single-image serving (GIP_MESH_SPATIAL=1);
        see _spatial_handle for the sharding/pad contract."""
        _, exe, args, h_target = self._spatial_handle(
            filter_name, lvl, image, height, width, channels, radius,
            weights, n_dev)
        out, ms = exe(*args)
        out = out.reshape(h_target, width, channels)[:true_h, :true_w]
        if filter_name == "sobel" and (bucketed or h_target != height):
            # The padded rows treated the true bottom border as interior;
            # restore the reference's border zeroing.
            out = _zero_true_border(np.ascontiguousarray(out))
        return out, compute_metrics(
            ms, true_w, true_h, channels, FILTERS[filter_name].bytes_factor)

    # -- batched serving path (an extension; the reference is strictly
    #    one-image-per-request, backend/app.py:332) ------------------------

    def run_batch(
        self,
        filter_name: str,
        images: np.ndarray,
        level: int = 1,
        sigma: float = config.DEFAULT_SIGMA,
        radius: int = config.DEFAULT_RADIUS,
    ) -> tuple[np.ndarray, PerformanceMetrics]:
        """Filter a (B, H, W, C) uint8 stack in one device program.

        The whole batch is one XLA program (the kernels' grid carries the
        batch); with GIP_MESH_BATCH=1 and several devices, the batch is
        sharded over them (pure data parallelism, no collectives).  Returned
        metrics are for the WHOLE batch; fps is batch-normalized
        (images/second).
        """
        if images.ndim != 4:
            raise ValidationError("Batch input must be 4D (batch, H, W, C)")
        batch = int(images.shape[0])
        if batch < 1:
            raise ValidationError("Batch must contain at least one image")
        true_h, true_w, channels = validate_image_shape(images.shape[1:])
        images = np.ascontiguousarray(images, dtype=np.uint8)
        bucketed = False
        if _bucketing_enabled():
            hb, wb = _bucket(true_h), _bucket(true_w)
            if (hb, wb) != (true_h, true_w):
                images = np.pad(
                    images,
                    ((0, 0), (0, hb - true_h), (0, wb - true_w), (0, 0)),
                    mode="edge",
                )
                bucketed = True
        height, width = images.shape[1:3]
        if filter_name not in FILTERS:
            raise ValidationError(
                f"Invalid filter: {filter_name}. Must be 'gaussian', 'box', or 'sobel'"
            )
        lvl = normalize_level(filter_name, level)
        weights = None
        if filter_name == "gaussian":
            validate_gaussian_params(sigma, radius)
            weights = gaussian_kernel_f32(radius, float(sigma))
        elif filter_name == "box":
            validate_box_params(radius)

        mesh_n = _mesh_batch_devices()
        key = batch_cache_key(filter_name, lvl, batch, height, width,
                              channels, radius)

        def build() -> FilterExecutable:
            if mesh_n:
                return FilterExecutable(_trace_batch_mesh(
                    filter_name, lvl, radius, width, channels, mesh_n))
            return FilterExecutable(
                rows_fn(filter_name, lvl, radius, width, channels))

        exe = self._get(key, build)
        rows_b = images.reshape(batch, height, -1)
        if mesh_n:
            # Pad the batch axis on the host (edge = repeat the last image)
            # so it divides the mesh, then commit operands with the dp
            # sharding BEFORE the timed call.
            pad_b = -batch % mesh_n
            if pad_b:
                rows_b = np.concatenate(
                    [rows_b, np.repeat(rows_b[-1:], pad_b, axis=0)], axis=0)
            batch_sh, repl_sh = _mesh_batch_shardings(mesh_n)
        else:
            batch_sh = repl_sh = default_device()
        args = [jax.device_put(rows_b, batch_sh)]
        if weights is not None:
            args.append(jax.device_put(weights, repl_sh))
        jax.block_until_ready(args)
        out, ms = exe(*args)
        out = out.reshape(-1, height, width, channels)[:batch, :true_h, :true_w]
        if bucketed and filter_name == "sobel":
            out = _zero_true_border(np.ascontiguousarray(out))
        metrics = compute_metrics(
            ms, true_w, true_h, channels * batch, FILTERS[filter_name].bytes_factor
        )
        metrics.fps = batch * 1000.0 / max(metrics.time_ms, 1e-6)
        return out, metrics


#: Process-wide runtime (the analog of the reference's module-level CUDA
#: context held by the pybind module).
RUNTIME = FilterRuntime()
