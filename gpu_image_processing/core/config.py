"""Central configuration for the image-processing service.

The CUDA reference scatters parameter defaults/ranges across five places that
must stay in sync (bindings defaults `backend/cuda_bindings/bindings.cpp:245-247`,
pydantic defaults `backend/app.py:49-52`, the `/api/filters` catalog
`backend/app.py:147-172`, HTML slider bounds `frontend/index.html:88,97`, and
C++ validation `tests/test_real_image.cu:77-85`).  Here there is exactly one
source of truth; every other layer imports from this module.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default

# ---------------------------------------------------------------------------
# Parameter defaults and ranges (reference: backend/app.py:147-172)
# ---------------------------------------------------------------------------

DEFAULT_SIGMA: float = 2.0
DEFAULT_RADIUS: int = 3
DEFAULT_LEVEL: int = 1

SIGMA_RANGE: tuple[float, float] = (0.5, 20.0)
RADIUS_RANGE: tuple[int, int] = (1, 15)

# The CUDA reference caps the Gaussian weight table at 64 constant-memory
# floats, i.e. radius <= 31 (cuda_lib/src/image_filters.cu:13,729-732).  We
# keep the same hard cap so oversize requests fail the same way.
MAX_KERNEL_TAPS: int = 64

VALID_CHANNELS: tuple[int, ...] = (1, 3, 4)
#: Levels the comparison endpoints iterate over (backend/app.py:332).
VALID_LEVELS: tuple[int, ...] = (1, 2)
#: Levels a single /api/process request may ask for (4 = ADVANCED tier,
#: declared-but-unimplemented in the reference, image_filters.h:28).
REQUEST_LEVELS: tuple[int, ...] = (1, 2, 4)

# ---------------------------------------------------------------------------
# Serving (reference: start_servers.sh:16-17, frontend/js/app.js:2)
# ---------------------------------------------------------------------------

BACKEND_HOST: str = os.environ.get("GIP_BACKEND_HOST", "0.0.0.0")
BACKEND_PORT: int = _env_int("GIP_BACKEND_PORT", 8000)
FRONTEND_PORT: int = _env_int("GIP_FRONTEND_PORT", 8080)

#: Exit code the backend uses to request a worker recycle (RSS high-water
#: reached -- see server/app.py watchdog).  scripts/serve.py's supervisor
#: restarts the backend on exactly this code; anything else is a real exit.
EXIT_RECYCLE: int = 43


# ---------------------------------------------------------------------------
# Environment settings
# ---------------------------------------------------------------------------

#: Every GIP_* environment variable the program reads (docs/API.md).
ENV_VARS: frozenset[str] = frozenset({
    "GIP_BACKEND_HOST", "GIP_BACKEND_PORT", "GIP_BUCKET_RATIO",
    "GIP_DISABLE_TRACE_TIER", "GIP_DRYRUN_DEVICES", "GIP_FRONTEND_PORT",
    "GIP_LISTEN_FD", "GIP_MAX_BODY_MB", "GIP_MAX_IN_FLIGHT",
    "GIP_MAX_RSS_MB", "GIP_MESH_BATCH", "GIP_MESH_SPATIAL",
    "GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD", "GIP_NATIVE_LIB",
    "GIP_NO_BUCKETING", "GIP_PRECOMPILE", "GIP_RECYCLE_MIN_UPTIME_S",
    "GIP_RUN_DIR", "GIP_WORKER_GENERATION",
})


def check_env(environ=None) -> None:
    """Raise on any GIP_* variable the program does not read.

    The settings once carried a longer prefix (GIP_<platform>_MAX_RSS_MB is
    now GIP_MAX_RSS_MB); a deployment still setting an old name would lose
    that setting without a word, so the error names the current one.
    """
    environ = os.environ if environ is None else environ
    problems = []
    for name in sorted(k for k in environ
                       if k.startswith("GIP_") and k not in ENV_VARS):
        parts = name.split("_")
        renamed = [n for n in ("_".join(["GIP", *parts[i:]])
                               for i in range(2, len(parts)))
                   if n in ENV_VARS]
        problems.append(f"{name} (renamed {renamed[0]})" if renamed
                        else f"{name} (no longer read)")
    if problems:
        raise ValueError("unknown GIP_* environment settings: "
                         + ", ".join(problems))
