"""Flagship benchmark: Gaussian blur sigma=2.0 radius=3 on 3239x2146 RGB,
level 2 -- the reference README's headline workload (README.md:234-235:
22.157 ms naive / 0.953 ms optimized on an RTX 4050 Laptop GPU).

Prints ONE JSON line:
    {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <speedup>}
where vs_baseline > 1 means faster than the reference's optimized level-2
CUDA kernel time.

Methodology -- the device-side analog of CUDA-event timing
(image_filters.cu:804-894: events bracket kernels only, no transfers):
the filter is iterated inside ONE jitted `lax.fori_loop` program (uint8
image in, uint8 image out, so iterations chain) at two loop lengths;
per-iteration device time = the median slope (runtime/timing.py).  This
excludes host->device transfers, PNG codecs, compilation and per-call
dispatch.  The reported value is the MIN of ROUNDS such measurements.
A line before the JSON names the card and its power limit; a device
without published peaks (profiling/profiler.py::DEVICE_PEAKS) is an error.

Run `python bench.py --full` for the whole README table (stderr).
"""

from __future__ import annotations

import json
import sys

_METRIC = "gaussian_blur_l2_3239x2146_rgb_time_ms"
BASELINE_GAUSSIAN_L2_MS = 0.953   # README.md:235
BASELINES_FULL = {
    ("gaussian", 1): 22.157,
    ("gaussian", 2): 0.953,
    ("box", 1): 12.311,
    ("box", 2): 2.766,
    ("sobel", 1): 18.339,
    ("sobel", 2): 0.528,
    # Level 4 (ADVANCED) is declared-but-unimplemented in the reference
    # (README.md:316); compared against its fastest published number for
    # each filter (the level-2 kernel time).
    ("gaussian", 4): 0.953,
    ("box", 4): 2.766,
    ("sobel", 4): 0.528,
}
H, W, C = 2146, 3239, 3          # README workload: 3239x2146 RGB
BOX_RADIUS = 5                    # README.md:242
GAUSS_SIGMA, GAUSS_RADIUS = 2.0, 3
LOOP_ITERS = 64
ROUNDS = 5


def _apply_fn(filter_name: str, level: int, width: int = W, channels: int = C,
              height: int = H):
    """(img_u8, *rest) -> img_u8: THE served rows function
    (runtime/dispatch.py::rows_fn) on the (H, W*C) serving boundary."""
    from gpu_image_processing.runtime.dispatch import rows_fn

    radius = {"gaussian": GAUSS_RADIUS, "box": BOX_RADIUS}.get(filter_name, 0)
    return rows_fn(filter_name, level, radius, width, channels)


def program_fingerprint(filter_name: str, level: int, img) -> str:
    """sha256 of the traced program (jaxpr) `measure_ms` would time.

    Rows with equal fingerprints execute IDENTICAL device code, so their
    timing samples are exchangeable (e.g. box L2 vs L4: the same kernel).
    Used by benchmarks/run_benchmarks.py to pool same-session samples
    across such rows.  The jaxpr string is trace-deterministic and captures
    everything routing can change (kernel bodies, geometry, interpret
    flags, compiler params); jax version + backend are folded in so
    fingerprints never match across toolchains or platforms.
    """
    import hashlib

    import jax
    import numpy as np

    h, w_, c = img.shape
    fn = _apply_fn(filter_name, level, width=w_, channels=c, height=h)
    spec = [jax.ShapeDtypeStruct((h, w_ * c), np.uint8)]
    if filter_name == "gaussian":
        spec.append(
            jax.ShapeDtypeStruct((2 * GAUSS_RADIUS + 1,), np.float32))
    txt = (f"jax={jax.__version__} backend={jax.default_backend()}\n"
           + str(jax.make_jaxpr(fn)(*spec)))
    return hashlib.sha256(txt.encode()).hexdigest()


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi unavailable ({exc})"
    import jax

    d = jax.devices()[0]
    return f"{out} | jax: {d.platform} {d.device_kind} x{len(jax.devices())}"


def measure_ms(filter_name: str, level: int, img, rounds: int = ROUNDS) -> float:
    """Min of `rounds` slope-based device timings (see module docstring)."""
    import jax
    import numpy as np

    from gpu_image_processing.ops.weights import gaussian_kernel_f32
    from gpu_image_processing.profiling.profiler import device_peaks
    from gpu_image_processing.runtime.device import default_device
    from gpu_image_processing.runtime.timing import device_time_ms

    peaks = device_peaks()
    if peaks is None:
        raise RuntimeError(
            f"no published peaks for device kind "
            f"{default_device().device_kind!r} (profiling/profiler.py::"
            "DEVICE_PEAKS); bench.py measures only known devices")
    h, w_, c = img.shape
    fn = _apply_fn(filter_name, level, width=w_, channels=c, height=h)
    args = [jax.device_put(np.ascontiguousarray(img).reshape(h, w_ * c),
                           default_device())]
    if filter_name == "gaussian":
        args.append(
            jax.device_put(
                gaussian_kernel_f32(GAUSS_RADIUS, GAUSS_SIGMA), default_device()
            )
        )

    # Physical floor: any filter must at least read + write the image once,
    # so per-iteration times below those bytes at TWICE the device's HBM
    # roofline are measurement artifacts (a spike during the SHORT loop
    # drives the slope to ~zero), not fast kernels.
    floor_ms = 2 * img.nbytes / (2 * peaks[0] * 1e9) * 1e3

    def take(n):
        return [device_time_ms(fn, args, iters=LOOP_ITERS) for _ in range(n)]

    samples = take(rounds)
    valid = [s for s in samples if s >= floor_ms]
    if not valid:  # whole batch degenerate: one retry (executables cached)
        samples = take(rounds)
        valid = [s for s in samples if s >= floor_ms] or samples
    valid = sorted(valid)
    med = valid[len(valid) // 2]
    return min(s for s in valid if s >= med / 3.0)


def main() -> None:
    import numpy as np

    rng = np.random.default_rng(12345)
    img = rng.integers(0, 256, size=(H, W, C), dtype=np.uint8)

    if "--full" in sys.argv:
        print(
            f"{'filter':10} {'level':5} {'ours (ms)':>10} {'ref (ms)':>9} {'speedup':>8}",
            file=sys.stderr,
        )
        for (fname, level), ref_ms in BASELINES_FULL.items():
            ms = measure_ms(fname, level, img)
            print(
                f"{fname:10} {level:5} {ms:10.3f} {ref_ms:9.3f} {ref_ms / ms:8.2f}x",
                file=sys.stderr,
            )

    ms = measure_ms("gaussian", 2, img)
    print(device_line())
    print(json.dumps({
        "metric": _METRIC,
        "value": round(ms, 4),
        "unit": "ms",
        "vs_baseline": round(BASELINE_GAUSSIAN_L2_MS / ms, 3),
    }))


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # device unreachable, init failure, ...
        # Still emit ONE machine-readable JSON line recording WHY there is
        # no number.  Never fabricate a value.
        print(json.dumps({
            "metric": _METRIC,
            "value": None,
            "unit": "ms",
            "vs_baseline": None,
            "error": f"{type(exc).__name__}: {exc}",
        }))
        raise
