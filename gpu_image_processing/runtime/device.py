"""Device selection, the platform rule, and the persistent compile cache.

Platform selection is JAX's own (``JAX_PLATFORMS``).  The runtime serves on
a GPU.  It runs on the CPU backend only when ``JAX_PLATFORMS`` names
``cpu`` alone (tests, rehearsal), and Pallas kernels then run in interpret
mode.  Any other platform is an error that names what JAX found.
"""

from __future__ import annotations

import functools
import os

import jax

#: Fixed in-checkout compile-cache directory, used when
#: JAX_COMPILATION_CACHE_DIR is unset (the path is part of the cache key,
#: so it must not move between processes).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_compilation_cache() -> str:
    """Enable XLA's persistent compilation cache; returns its directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set (or
    the directory was configured before this module loaded) nothing is
    changed here.  Otherwise the cache goes to DEFAULT_CACHE_DIR.
    """
    configured = jax.config.jax_compilation_cache_dir
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or configured:
        return configured or os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_CACHE_DIR


setup_compilation_cache()


def cpu_requested(platforms: str | None = None) -> bool:
    """Whether JAX_PLATFORMS (or the jax_platforms setting) is exactly cpu."""
    if platforms is None:
        platforms = jax.config.jax_platforms or ""
    return [p.strip().lower() for p in platforms.split(",") if p.strip()] == [
        "cpu"]


def check_platform(plat: str, platforms: str | None = None) -> str:
    """Return `plat` if the runtime may serve on it, else raise.

    gpu always serves; cpu serves only when asked for explicitly.
    """
    if plat == "gpu" or (plat == "cpu" and cpu_requested(platforms)):
        return plat
    raise RuntimeError(
        f"no GPU found: JAX's default platform is {plat!r}. Run on a "
        "machine with a CUDA GPU, or set JAX_PLATFORMS=cpu to run on the "
        "CPU backend (Pallas kernels then run in interpret mode).")


@functools.lru_cache(maxsize=1)
def default_device() -> jax.Device:
    """The device all single-image filtering runs on (device 0, the analog
    of the reference pinning CUDA device 0, ncu_profiler.py:147)."""
    dev = jax.devices()[0]
    check_platform(dev.platform)
    return dev


def platform() -> str:
    return default_device().platform


def use_interpret() -> bool:
    """Pallas kernels run in interpret mode exactly on the CPU backend."""
    return platform() == "cpu"
