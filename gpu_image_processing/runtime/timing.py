"""Device-time measurement by loop delta: the CUDA-event analog.

CUDA events time the kernels on-stream, excluding launch latency
(image_filters.cu:804-894).  `device_time_ms` runs the op inside ONE jitted
`lax.fori_loop` (uint8 image in == out, so iterations chain) at TWO loop
lengths and reports the slope (T(hi) - T(lo)) / (hi - lo), which cancels
the per-call dispatch and synchronization cost.  Medians over the
repetition samples, not minima: min pairs an unlucky-fast baseline with
the true larger loop and systematically underestimates.  Used by the deep
profiler and bench.py; served `time_ms` is the host clock of one call
(runtime/dispatch.py).
"""

from __future__ import annotations

import statistics
import tempfile
import time
from typing import Callable, Sequence

import jax
from jax import lax


def _loop_samples(
    apply: Callable, args: Sequence, n_iters: int, sync_reps: int,
) -> list[float]:
    """`sync_reps` wall times of an n_iters fori_loop of `apply`."""
    def fn(x, *rest):
        return lax.fori_loop(0, n_iters, lambda i, a: apply(a, *rest), x)

    compiled = jax.jit(fn).lower(*args).compile()
    compiled(*args).block_until_ready()   # program load
    out = []
    for _ in range(sync_reps):
        t0 = time.perf_counter()
        compiled(*args).block_until_ready()
        out.append(time.perf_counter() - t0)
    return out


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def device_time_ms(
    apply: Callable,
    args: Sequence,
    iters: int = 16,
    sync_reps: int = 4,
) -> float:
    """Per-iteration device time (ms) of `apply(img, *rest) -> img`.

    `iters` sets the larger loop length; the smaller is iters//4.  Larger
    values buy noise rejection with wall time (the loop runs sync_reps
    times at each length).
    """
    args = list(args)
    jax.block_until_ready(args)
    lo = max(1, iters // 4)
    hi = max(lo + 1, iters)
    t_lo = _median(_loop_samples(apply, args, lo, sync_reps))
    t_hi = _median(_loop_samples(apply, args, hi, sync_reps))
    return max((t_hi - t_lo) / (hi - lo) * 1000.0, 1e-4)


def interleaved_host_ms(arms: dict[str, Callable], args: Sequence,
                        runs: int) -> dict[str, float]:
    """Median host-clock ms per call of each arm, every call ending in
    `block_until_ready`.  The arms alternate within each round, and the
    order of the round reverses every round, so drift and order effects
    fall on every arm alike."""
    names = list(arms)
    for fn in arms.values():
        jax.block_until_ready(fn(*args))
    samples: dict[str, list[float]] = {k: [] for k in names}
    for i in range(runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(arms[name](*args))
            samples[name].append((time.perf_counter() - t0) * 1000.0)
    return {k: statistics.median(v) for k, v in samples.items()}


def trace_device_ms(fn: Callable, args: Sequence, runs: int) -> float:
    """Device ms per call of `fn`: the kernels of a profiler trace of
    `runs` calls, summed and divided by `runs`."""
    from ..profiling.xplane import serving_kernel_durations

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory(prefix="gip_trace_") as out_dir:
        with jax.profiler.trace(out_dir):
            for _ in range(runs):
                jax.block_until_ready(fn(*args))
        kernels = serving_kernel_durations(out_dir)
    return sum(k["total_ms"] for k in kernels.values()) / runs
