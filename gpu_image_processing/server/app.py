"""REST API application: the 6 reference endpoints, GPU-backed.

Endpoint surface, schemas, status codes, and error behavior match
backend/app.py:115-524 so reference clients (frontend/js/app.js,
backend/test_client.py) work against this server unchanged:

    GET  /                  service info
    GET  /api/health        {"status", "gpu_available"}
    GET  /api/filters       filter catalog with parameter ranges
    POST /api/process       one filter, one level
    POST /api/process-all   level_1 + level_2 comparison (+ optional profiling)
    POST /api/upload        multipart image -> base64

Degradation contract (app.py:21-27,131-137,190-194): if the accelerator
runtime cannot initialize, process endpoints return 503 and the healthcheck
reports it, but the server still serves.  Per-level failures inside
process-all are swallowed so the other level can succeed (app.py:461-466).
Profiled timings never override the primary device-timed `time_ms`
(app.py:391-427).
"""

from __future__ import annotations

import json as _json
import logging
import os
import time as _time
import traceback
from typing import Any

import numpy as np

from ..core import config
from ..core.params import FILTERS, ValidationError, filters_catalog
from ..utils.image import (
    ImageCodecError,
    decode_base64_image,
    decode_base64_image_ex,
    decode_tier_counts,
    encode_image_to_base64,
    load_image_file,
)
from .http import HTTPError, Request, Router
from .schemas import (AllLevelsResponse, FilterRequest, FilterResponse,
                      SchemaError)

logger = logging.getLogger("gip.server")

API_VERSION = "1.0.0"

# Filter runtime availability probe (the reference's GPU_AVAILABLE).
try:
    from ..runtime.dispatch import RUNTIME

    RUNTIME_AVAILABLE = True
    _IMPORT_ERROR = None
except Exception as exc:  # pragma: no cover - broken jax install
    RUNTIME = None
    RUNTIME_AVAILABLE = False
    _IMPORT_ERROR = str(exc)


def _require_runtime() -> None:
    if not RUNTIME_AVAILABLE:
        raise HTTPError(
            503,
            "Filter runtime not available: "
            f"{_IMPORT_ERROR or 'initialization failed'}",
        )


def _validate_request(req: FilterRequest) -> None:
    if req.filter not in FILTERS:
        raise HTTPError(
            400,
            f"Invalid filter: {req.filter}. Must be 'gaussian', 'box', or 'sobel'",
        )
    if req.level not in config.REQUEST_LEVELS:
        spec = FILTERS[req.filter]
        raise HTTPError(
            400,
            f"Invalid level: {req.level}. {spec.display_name} supports levels "
            f"1 (naive), 2 ({spec.level_names[2]}), or 4 (advanced)",
        )


def _level_name(filter_name: str, level: int) -> str:
    return FILTERS[filter_name].level_names[level]


def _info_dict(req: FilterRequest, level: int, height: int, width: int, channels: int,
               include_level_number: bool = False) -> dict[str, Any]:
    info = {
        "filter": req.filter,
        "level": _level_name(req.filter, level),
        "width": int(width),
        "height": int(height),
        "channels": int(channels),
        "parameters": {
            "sigma": req.sigma if req.filter == "gaussian" else None,
            "radius": req.radius if req.filter in ("gaussian", "box") else None,
        },
    }
    if include_level_number:
        info["level_number"] = level
    return info


def _run_filter(req: FilterRequest, img: np.ndarray, level: int):
    kwargs: dict[str, Any] = {"level": level}
    if req.filter == "gaussian":
        kwargs.update(sigma=req.sigma, radius=req.radius)
    elif req.filter == "box":
        kwargs.update(radius=req.radius)
    return RUNTIME.run(req.filter, img, **kwargs)


def _parse_filter_request(request: Request) -> FilterRequest:
    if request.json is None:
        raise HTTPError(400, "Expected a JSON body")
    try:
        return FilterRequest.from_json(request.json)
    except SchemaError as exc:
        raise HTTPError(422, f"Invalid request: {exc}") from None


def create_app() -> Router:
    app = Router()
    stats = {"started_at": _time.time(), "requests_total": 0, "by_route": {}}
    import threading

    stats_lock = threading.Lock()  # ThreadingHTTPServer: += is not atomic

    _dispatch = app.dispatch

    def counting_dispatch(request: Request):
        key = f"{request.method} {request.path}"
        with stats_lock:
            stats["requests_total"] += 1
            stats["by_route"][key] = stats["by_route"].get(key, 0) + 1
        return _dispatch(request)

    app.dispatch = counting_dispatch

    @app.get("/api/stats")
    def server_stats(_req: Request):
        """Observability extension (the reference has only bare prints,
        SURVEY 5.5): request counters, uptime, executable-cache size."""
        cache_size = len(RUNTIME._cache) if RUNTIME_AVAILABLE else 0
        device = None
        if RUNTIME_AVAILABLE:
            try:
                from ..runtime.device import default_device

                device = str(default_device())
            except Exception:
                pass
        return 200, {
            "uptime_s": round(_time.time() - stats["started_at"], 1),
            "requests_total": stats["requests_total"],
            "requests_by_route": stats["by_route"],
            "compiled_executables": cache_size,
            "device": device,
            "tpu_available": RUNTIME_AVAILABLE,  # key kept for client compat
            # Opt-in worker-recycle watchdog: the supervisor restarts the
            # backend when rss crosses the mark; worker_generation counts
            # restarts (1 = never recycled, null = running unsupervised).
            "rss_mb": round(_rss_mb(), 1),
            "max_rss_mb": watchdog_threshold_mb() or None,
            "worker_generation": int(os.environ["GIP_WORKER_GENERATION"])
            if os.environ.get("GIP_WORKER_GENERATION", "").isdigit()
            else None,
            # Which decoder tier served each upload (native C++ codec vs
            # PIL fallback vs failed): a native-tier coverage regression
            # shows up here instead of silently riding the fallback.
            "decode_tiers": decode_tier_counts(),
        }

    @app.get("/")
    def root(_req: Request):
        return 200, {
            "name": "GPU Image Processing API",
            "version": API_VERSION,
            "status": "running",
            "gpu_available": RUNTIME_AVAILABLE,  # key kept for client compat
            "tpu_available": RUNTIME_AVAILABLE,
            "endpoints": {
                "GET /": "This message",
                "GET /api/filters": "List available filters",
                "POST /api/process": "Process image with filter",
                "POST /api/process-all": "Process image at every level",
                "POST /api/upload": "Upload image, get base64",
                "GET /api/health": "Health check",
            },
        }

    @app.get("/docs")
    def docs(_req: Request):
        """API documentation (the analog of uvicorn/FastAPI's /docs,
        advertised by the reference at startup, app.py:540)."""
        return 200, {
            "openapi_like": True,
            "title": "GPU Image Processing API",
            "version": API_VERSION,
            "endpoints": {
                "GET /": {"description": "Service info"},
                "GET /api/health": {"description": "Health check"},
                "GET /api/filters": {
                    "description": "Filter catalog with parameter ranges"
                },
                "GET /api/stats": {"description": "Request counters + uptime"},
                "POST /api/process": {
                    "description": "Filter one image at one level",
                    "body": {
                        "image": "base64 or data-URL PNG/JPEG/...",
                        "filter": "gaussian | box | sobel",
                        "level": "1 (naive) | 2 (optimized) | 4 (advanced)",
                        "sigma": "float, gaussian only, [0.5, 20]",
                        "radius": "int, gaussian/box, [1, 15]",
                    },
                    "returns": "{processed_image, metrics{time_ms,"
                               "bandwidth_gbps,fps}, info}",
                },
                "POST /api/process-all": {
                    "description": "Filter at levels 1 and 2 for comparison",
                    "body": "same as /api/process + enable_profiling: bool",
                    "returns": "{original_image, results{level_1,level_2},"
                               " image_info, profiling_available}",
                },
                "POST /api/process-batch": {
                    "description": "Filter a batch of same-size images in one"
                                   " device program",
                    "body": "{images: [b64,...], filter, level, sigma, "
                            "radius, enable_profiling}",
                },
                "POST /api/upload": {
                    "description": "multipart/form-data file -> base64"
                },
            },
        }

    @app.get("/api/health")
    def health(_req: Request):
        return 200, {
            "status": "healthy",
            "gpu_available": RUNTIME_AVAILABLE,  # key kept for client compat
            "tpu_available": RUNTIME_AVAILABLE,
        }

    @app.get("/api/filters")
    def list_filters(_req: Request):
        return 200, {"filters": filters_catalog(), "gpu_available": RUNTIME_AVAILABLE}

    @app.post("/api/process")
    def process_image(request: Request):
        _require_runtime()
        req = _parse_filter_request(request)
        _validate_request(req)
        try:
            img = decode_base64_image(req.image)
        except ImageCodecError as exc:
            raise HTTPError(400, str(exc)) from None
        height, width, channels = img.shape
        _note_served_shape(width, height)
        try:
            out, metrics = _run_filter(req, img, req.level)
            response = FilterResponse(
                processed_image=encode_image_to_base64(out),
                metrics=metrics.as_dict(),
                info=_info_dict(req, req.level, height, width, channels),
            )
        except ValidationError as exc:
            raise HTTPError(400, str(exc)) from None
        except Exception as exc:
            raise HTTPError(500, f"Processing failed: {exc}") from None
        return 200, response.model_dump()

    @app.post("/api/process-all")
    def process_all_levels(request: Request):
        _require_runtime()
        req = _parse_filter_request(request)
        if req.filter not in FILTERS:
            raise HTTPError(
                400,
                f"Invalid filter: {req.filter}. Must be 'gaussian', 'box', or 'sobel'",
            )
        try:
            img, original_passthrough = decode_base64_image_ex(req.image)
        except ImageCodecError as exc:
            raise HTTPError(400, str(exc)) from None
        height, width, channels = img.shape
        _note_served_shape(width, height)
        # The reference re-encodes the original (app.py:305-309); when the
        # upload was already a rendering-neutral RGB PNG or single-scan
        # baseline RGB JPEG, the source bytes pass straight through instead
        # of paying a full PNG encode (~21 ms at 600x800).
        original_b64 = original_passthrough or encode_image_to_base64(img)

        profiling_available = False
        if req.enable_profiling:
            try:
                from ..profiling.profiler import check_profiler_available

                profiling_available = check_profiler_available()
            except ImportError:
                logger.warning("Profiling module not available")

        results: dict[str, Any] = {}
        prev_out: Any = None
        prev_encoded: str | None = None
        for level in config.VALID_LEVELS:
            try:
                out, metrics = _run_filter(req, img, level)
                base_metrics: dict[str, Any] = metrics.as_dict()

                if req.enable_profiling and profiling_available:
                    try:
                        from ..profiling.profiler import (
                            get_common_metrics,
                            profile_filter,
                        )

                        deep = profile_filter(
                            img,
                            req.filter,
                            level,
                            req.sigma if req.filter == "gaussian" else None,
                            req.radius if req.filter in ("gaussian", "box") else None,
                        )
                        common = get_common_metrics(deep, ncu_data=deep) if deep else {}
                        if common.get("time_ms", 0) > 0:
                            # Keep the device-event time primary; expose the
                            # profiled time under the reference's key name
                            # (app.py:391-427).
                            base_metrics["ncu_profiled_time_ms"] = common["time_ms"]
                        for key, value in common.items():
                            if key == "time_ms":
                                continue
                            base_metrics[key] = value
                        if deep:
                            base_metrics["ncu_data"] = deep
                    except Exception as exc:
                        logger.warning("Profiling failed for level %s: %s", level, exc)
                        base_metrics["profiling_error"] = str(exc)

                # Gaussian/box levels are bit-identical by invariant — when
                # the arrays match, reuse the previous level's PNG instead
                # of encoding the same pixels twice (~21 ms at 600x800).
                if prev_encoded is not None and np.array_equal(out, prev_out):
                    encoded = prev_encoded
                else:
                    encoded = encode_image_to_base64(out)
                    prev_out, prev_encoded = out, encoded
                results[f"level_{level}"] = FilterResponse(
                    processed_image=encoded,
                    metrics=base_metrics,
                    info=_info_dict(
                        req, level, height, width, channels, include_level_number=True
                    ),
                )
            except Exception as exc:
                logger.error(
                    "Error processing level %s: %s\n%s",
                    level,
                    exc,
                    traceback.format_exc(),
                )
                continue

        if not results:
            raise HTTPError(500, "Failed to process image with any optimization level")

        response = AllLevelsResponse(
            original_image=original_b64,
            results=results,
            image_info={
                "width": int(width),
                "height": int(height),
                "channels": int(channels),
                "filter": req.filter,
                "parameters": {
                    "sigma": req.sigma if req.filter == "gaussian" else None,
                    "radius": req.radius if req.filter in ("gaussian", "box") else None,
                },
            },
            profiling_available=profiling_available,
        )
        return 200, response.model_dump()

    @app.post("/api/process-batch")
    def process_batch(request: Request):
        """Batched filtering (an extension): many same-size images in one
        device program.  Body: {"images": [b64,...], "filter": ...,
        "level": 1|2, "sigma": f, "radius": n}."""
        _require_runtime()
        body = request.json
        if (not isinstance(body, dict) or not isinstance(body.get("images"), list)
                or not body["images"]):
            raise HTTPError(400, "Expected a JSON body with a non-empty 'images' list")
        fields = {k: v for k, v in body.items() if k != "images"}
        fields["image"] = body["images"][0]
        try:
            req = FilterRequest.from_json(fields)
        except SchemaError as exc:
            raise HTTPError(422, f"Invalid request: {exc}") from None
        _validate_request(req)
        decoded = []
        for idx, b64 in enumerate(body["images"]):
            try:
                decoded.append(decode_base64_image(b64))
            except ImageCodecError as exc:
                raise HTTPError(400, f"Image {idx}: {exc}") from None
        shapes = {arr.shape for arr in decoded}
        if len(shapes) != 1:
            raise HTTPError(
                400,
                f"All images in a batch must share one shape; got {sorted(shapes)}",
            )
        batch = np.stack(decoded)
        height, width, channels = batch.shape[1:]
        _note_served_shape(width, height)
        try:
            kwargs: dict[str, Any] = {"level": req.level}
            if req.filter == "gaussian":
                kwargs.update(sigma=req.sigma, radius=req.radius)
            elif req.filter == "box":
                kwargs.update(radius=req.radius)
            out, metrics = RUNTIME.run_batch(req.filter, batch, **kwargs)
        except ValidationError as exc:
            raise HTTPError(400, str(exc)) from None
        except Exception as exc:
            raise HTTPError(500, f"Processing failed: {exc}") from None
        base_metrics: dict[str, Any] = {
            **metrics.as_dict(),
            "batch_size": int(batch.shape[0]),
            "images_per_second": metrics.fps,
        }
        if req.enable_profiling:
            # Same merge contract as /api/process-all: the deep profile's
            # durations land under the reference's ncu_* key names and
            # NEVER override the device-timed time_ms.  The profiled
            # program is the batch executable itself (profiler.py::
            # profile_batch), not a single-image stand-in.
            try:
                from ..profiling.profiler import (
                    get_common_metrics,
                    profile_batch,
                )

                deep = profile_batch(
                    batch,
                    req.filter,
                    req.level,
                    req.sigma if req.filter == "gaussian" else None,
                    req.radius if req.filter in ("gaussian", "box") else None,
                )
                common = get_common_metrics(deep, ncu_data=deep) if deep else {}
                if common.get("time_ms", 0) > 0:
                    base_metrics["ncu_profiled_time_ms"] = common["time_ms"]
                for key, value in common.items():
                    if key == "time_ms":
                        continue
                    base_metrics[key] = value
                if deep:
                    base_metrics["ncu_data"] = deep
            except Exception as exc:
                logger.warning("Batch profiling failed: %s", exc)
                base_metrics["profiling_error"] = str(exc)
        return 200, {
            "processed_images": [encode_image_to_base64(img) for img in out],
            "metrics": base_metrics,
            "info": _info_dict(req, req.level, height, width, channels),
        }

    @app.post("/api/upload")
    def upload_image(request: Request):
        if "file" not in request.files:
            raise HTTPError(400, "Upload failed: no file field in request")
        _, data = request.files["file"]
        try:
            arr, width, height = load_image_file(data)
        except Exception as exc:
            raise HTTPError(500, f"Upload failed: {exc}") from None
        return 200, {
            "base64_image": encode_image_to_base64(
                arr if arr.shape[2] != 1 else arr[:, :, 0]
            ),
            "width": width,
            "height": height,
            "channels": arr.shape[2],
        }

    return app


# Warmed when precompile is requested without explicit shapes
# (GIP_PRECOMPILE=1): the demo workload plus the two most common
# upload resolutions.  Shapes are bucketed by the runtime, so each entry
# warms its whole shape bucket.
DEFAULT_PRECOMPILE_SHAPES = [(800, 600), (1280, 720), (1920, 1080)]


def _parse_precompile(spec: str) -> list[tuple[int, int]]:
    """\"WxH,WxH,...\" -> [(w, h), ...]; malformed entries are skipped.

    Boolean-ish tokens (1/true/yes/on/default) expand to
    DEFAULT_PRECOMPILE_SHAPES so `GIP_PRECOMPILE=1` means "warm the
    defaults" rather than logging a malformed-shape warning.
    """
    shapes = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok in ("1", "true", "yes", "on", "default"):
            shapes.extend(DEFAULT_PRECOMPILE_SHAPES)
            continue
        try:
            w_s, h_s = tok.split("x", 1)
            w, h = int(w_s), int(h_s)
        except ValueError:
            logger.warning("Ignoring malformed precompile shape %r", tok)
            continue
        if 3 <= w <= 16384 and 3 <= h <= 16384:
            shapes.append((w, h))
        else:
            logger.warning("Ignoring out-of-range precompile shape %r", tok)
    return shapes


def precompile_shapes(shapes: list[tuple[int, int]]) -> int:
    """Compile the serving executables for the given (w, h) image shapes.

    Cold-start mitigation: the first request at a novel shape bucket pays
    the XLA compile.  Warming every filter x level moves that cost to
    startup.
    The runtime's build lock means a real request arriving mid-warm for the
    same bucket waits for the warm compile instead of duplicating it.
    Returns the number of (shape, filter) combinations warmed.
    """
    from ..runtime.dispatch import RUNTIME

    warmed = 0
    for w, h in shapes:
        img = np.zeros((h, w, 3), np.uint8)  # content never affects tracing
        for filt in ("gaussian", "box", "sobel"):
            ok = True
            for level in config.REQUEST_LEVELS:
                try:
                    RUNTIME.run(filt, img, level=level)
                except Exception as exc:
                    ok = False
                    logger.warning("Precompile %sx%s %s L%s failed: %s",
                                   w, h, filt, level, exc)
            warmed += ok
    return warmed


def _rss_mb() -> float:
    """This process's resident set in MB (linux /proc; ru_maxrss fallback
    only reports the high-water mark, good enough to trip the watchdog)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def watchdog_threshold_mb() -> int:
    """RSS high-water (MB) above which the server recycles itself; 0 = off.

    Opt-in through GIP_MAX_RSS_MB; off by default."""
    env = os.environ.get("GIP_MAX_RSS_MB", "").strip()
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            logger.warning("Ignoring malformed GIP_MAX_RSS_MB=%r", env)
    return 0


# ---------------------------------------------------------------------------
# Warm-state handoff across worker recycles: the exiting generation records
# the image shapes it actually served; the next generation precompiles
# exactly those, so post-recycle first requests hit warm executables
# instead of paying compile/load latency (observed as the p99 tail on the
# wave spanning a recycle).
# ---------------------------------------------------------------------------

_SERVED_SHAPES: set = set()
_SERVED_SHAPES_CAP = 32  # arbitrary-size traffic must not grow this forever


def _note_served_shape(width: int, height: int) -> None:
    if len(_SERVED_SHAPES) < _SERVED_SHAPES_CAP:
        _SERVED_SHAPES.add((int(width), int(height)))


def _warm_shapes_path() -> str:
    import tempfile

    return os.path.join(os.environ.get("GIP_RUN_DIR",
                                       tempfile.gettempdir()),
                        "gip_warm_shapes.json")


def _dump_served_shapes() -> None:
    if not _SERVED_SHAPES:
        return
    try:
        with open(_warm_shapes_path(), "w") as f:
            _json.dump(sorted(_SERVED_SHAPES), f)
    except OSError:  # pragma: no cover - /tmp unwritable
        pass


def _load_warm_shapes(max_age_s: float = 3600.0) -> list[tuple[int, int]]:
    """Previous generation's served shapes, if recent (stale traffic from
    hours ago is not worth compile time)."""
    path = _warm_shapes_path()
    try:
        if _time.time() - os.path.getmtime(path) > max_age_s:
            return []
        with open(path) as f:
            raw = _json.load(f)
        return [(int(w), int(h)) for w, h in raw][:_SERVED_SHAPES_CAP]
    except (OSError, ValueError, TypeError):
        return []


def _startup_precompile_shapes(spec: str, supervised: bool) -> list[tuple[int, int]]:
    """What to warm at boot: the explicit --precompile/env set, plus -- for
    a supervised worker (i.e. one likely replacing a recycled generation)
    -- the shapes the previous generation actually served."""
    shapes = _parse_precompile(spec)
    if supervised:
        for wh in _load_warm_shapes():
            if wh not in shapes:
                shapes.append(wh)
    return shapes


def _rss_watchdog(server, threshold_mb: int, recycle_flag,
                  poll_s: float = 5.0) -> None:
    """Daemon thread: when RSS crosses the high-water mark, stop accepting
    connections (serve_forever in the main thread returns) and flag a
    recycle; main() then drains in-flight requests and exits with
    config.EXIT_RECYCLE for the supervisor (scripts/serve.py) to restart.
    The gunicorn max-RSS worker-recycling pattern."""
    import time

    while True:
        time.sleep(poll_s)
        rss = _rss_mb()
        if rss > threshold_mb:
            logger.warning(
                "RSS %.0f MB > high-water %d MB: recycling worker "
                "(draining in-flight requests, then exit %d for the "
                "supervisor to restart)", rss, threshold_mb,
                config.EXIT_RECYCLE)
            recycle_flag.set()
            # serve_forever may not have built the httpd yet (tiny
            # thresholds trip on the first poll); a shutdown() then would
            # no-op and the recycle would never happen.
            while getattr(server, "_httpd", None) is None:
                time.sleep(0.1)
            server.shutdown()  # must come from a non-serving thread
            return


def build_server(host: str, port: int, precompile: str = "",
                 listen_fd: int | None = None):
    """The serving stack `main` runs: (AppServer, recycle Event).

    Starts background precompilation of the requested shapes and, when
    GIP_MAX_RSS_MB is set, the RSS watchdog.  The caller runs
    `server.serve_forever()` (main does so on the main thread; an embedding
    process may run it on a thread of its own).
    """
    import threading

    from .http import AppServer

    config.check_env()
    if RUNTIME_AVAILABLE:
        # Explicit --precompile/env shapes; supervised workers also warm
        # the shapes the PREVIOUS generation served (warm-state handoff --
        # cuts the post-recycle first-request tail).
        shapes = _startup_precompile_shapes(precompile,
                                            supervised=listen_fd is not None)
        if shapes:
            # Background: the server binds immediately; a request hitting a
            # still-warming bucket waits on the runtime build lock rather
            # than compiling twice.
            threading.Thread(
                target=precompile_shapes, args=(shapes,),
                name="gip-precompile", daemon=True,
            ).start()

    server = AppServer(create_app(), host, port, listen_fd=listen_fd)
    recycle = threading.Event()
    threshold = watchdog_threshold_mb()
    if threshold > 0:
        print(f"RSS watchdog armed: recycle above {threshold} MB")
        threading.Thread(
            target=_rss_watchdog, args=(server, threshold, recycle),
            name="gip-rss-watchdog", daemon=True,
        ).start()
    return server, recycle


def main() -> None:
    """Server entry point (uvicorn __main__ analog, app.py:526-543)."""
    import argparse
    import signal
    import threading

    parser = argparse.ArgumentParser(description="GPU Image Processing API Server")
    parser.add_argument("--host", default=config.BACKEND_HOST)
    parser.add_argument("--port", type=int, default=config.BACKEND_PORT)
    parser.add_argument(
        "--precompile",
        default=os.environ.get("GIP_PRECOMPILE", ""),
        help="Comma-separated WxH image shapes to compile at startup in the "
             "background (e.g. '800x600,1024x1024'); also via "
             "GIP_PRECOMPILE.",
    )
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)
    print("=" * 70)
    print("GPU Image Processing API Server")
    print("=" * 70)
    print(f"Filter runtime available: {RUNTIME_AVAILABLE}")
    print(f"\nStarting server on http://{args.host}:{args.port}")
    print("=" * 70 + "\n")

    # Supervisor-held listener (scripts/serve.py supervise): adopt its fd
    # so connections queue, not drop, while a recycled worker starts.
    fd_env = os.environ.get("GIP_LISTEN_FD", "").strip()
    listen_fd = int(fd_env) if fd_env.isdigit() else None
    if listen_fd is not None:
        print(f"Adopting supervisor listener (fd {listen_fd})")

    server, recycle = build_server(args.host, args.port, args.precompile,
                                   listen_fd)

    # Graceful SIGTERM/SIGINT (scripts/serve.py stop, terminal Ctrl-C):
    # stop accepting, drain, exit cleanly.  shutdown() must not run on the
    # main thread (it blocks until serve_forever returns), hence the helper
    # thread.
    def _term(_sig, _frm):
        def _stop():
            while getattr(server, "_httpd", None) is None:
                _time.sleep(0.1)
            server.shutdown()

        threading.Thread(target=_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    server.serve_forever()

    # Drain: serve_forever stopped accepting and every response from here
    # closes its keep-alive connection (http.py draining flag); wait for
    # one quiet second of zero in-flight requests so a request that lands
    # on a still-open connection right at the edge completes too.  The
    # bound is generous (10 min): an unwarmed-shape compile can hold a
    # request for a while.
    deadline = _time.time() + 600.0
    quiet_since = None
    while _time.time() < deadline:
        if server.in_flight.value == 0:
            if quiet_since is None:
                quiet_since = _time.time()
            elif _time.time() - quiet_since >= 1.0:
                break
        else:
            quiet_since = None
        _time.sleep(0.2)
    # Warm-state handoff: whatever ends this worker (recycle or graceful
    # stop), leave the served-shape list for the next generation.
    _dump_served_shapes()
    if recycle.is_set():
        logger.info("Worker recycling (exit %d)", config.EXIT_RECYCLE)
        logging.shutdown()
        # os._exit, NOT sys.exit: skip interpreter teardown so the
        # supervisor always sees the clean EXIT_RECYCLE code.  Responses
        # are flushed (drain above), the warm-shape file is written and
        # logs are shut down; the device is released by process exit.
        os._exit(config.EXIT_RECYCLE)


if __name__ == "__main__":
    main()
