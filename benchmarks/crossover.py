#!/usr/bin/env python3
"""Where each hand-written kernel beats the plain XLA version on the GPU.

For every (filter, radius, image size) of a grid, times the Pallas kernel
(ops/pallas/blur.py, ops/pallas/sobel.py) against the XLA tier of the same
numerics (ops/interleaved.py) in one process: the median host clock of
interleaved single calls of each compiled program, each ending in
`block_until_ready` (the served `time_ms`, runtime/dispatch.py), and the
device time per call from a profiler trace.  The routing rule that picks
one of the two for served programs (ops/pallas/api.py::kernel_serves) is
read off this table; PERF.md keeps it with the card's name and power limit.

Usage: python benchmarks/crossover.py [--runs 40] [--rounds 1]
           [--sizes 1023x1024x4,...] [--cases gaussian:3,box:15,...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (H, W, C): small to flagship; 1024x1023 RGBA is the reference's example
#: request, 3239x2146 RGB its flagship image.
SIZES = ((256, 256, 3), (512, 512, 3), (724, 724, 3), (1023, 1024, 4),
         (1448, 1448, 3), (2048, 2048, 3), (2146, 3239, 3))
CASES = tuple(("gaussian", r) for r in (1, 2, 3, 5, 7, 10, 15)) + tuple(
    ("box", r) for r in (1, 3, 5, 7, 10, 12, 15)) + (("sobel", 0),)
SIGMA = 2.0


def arms(filt: str, radius: int, width: int, channels: int,
         operands: list) -> dict:
    """{"kernel": exe, "xla": exe}: each arm compiled for `operands`, the
    (H, W*C) rows (gaussian: + weights), as the runtime compiles it."""
    from gpu_image_processing.ops import interleaved as il
    from gpu_image_processing.ops.pallas import blur, sobel
    from gpu_image_processing.runtime.dispatch import FilterExecutable

    c = channels
    if filt == "gaussian":
        kern = lambda x, w: blur.gaussian_rows(x, w, radius, c)
        xla = lambda x, w: il.gaussian_rows(x, w, radius, c)
    elif filt == "box":
        kern = lambda x: blur.box_rows(x, radius, c)
        xla = lambda x: il.box_rows(x, radius, c, doubling=True)
    else:
        kern = lambda x: sobel.sobel_rows(x, c, quantize_gray=True)
        xla = lambda x: il.sobel_rows(x, 2, width, c)
    return {"kernel": FilterExecutable(kern).compiled(*operands),
            "xla": FilterExecutable(xla).compiled(*operands)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=40)
    parser.add_argument("--rounds", type=int, default=1,
                        help="repeat the whole grid, to see run-to-run spread")
    parser.add_argument("--sizes", default="",
                        help="HxWxC,... (default: the built-in grid)")
    parser.add_argument("--cases", default="",
                        help="filter:radius,... (default: the built-in grid)")
    parser.add_argument("--out", default="")
    args = parser.parse_args()

    import jax
    import numpy as np

    from gpu_image_processing.ops.weights import gaussian_kernel_f32
    from gpu_image_processing.runtime.timing import (interleaved_host_ms,
                                                     trace_device_ms)

    if jax.devices()[0].platform != "gpu":
        print("crossover.py measures on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    sizes = ([tuple(int(v) for v in s.split("x"))
              for s in args.sizes.split(",")] if args.sizes else SIZES)
    cases = ([(f, int(r)) for f, r in (c.split(":")
                                       for c in args.cases.split(","))]
             if args.cases else CASES)
    rows_out = []
    grid = [size for _ in range(args.rounds) for size in sizes]
    for h, w, c in grid:
        rows = jax.device_put(rng.integers(0, 256, (h, w * c), np.uint8))
        for filt, radius in cases:
            operands = [rows]
            if filt == "gaussian":
                operands.append(jax.device_put(
                    gaussian_kernel_f32(radius, SIGMA)))
            fns = arms(filt, radius, w, c, operands)
            host = interleaved_host_ms(fns, operands, args.runs)
            dev = {k: trace_device_ms(fn, operands, 10)
                   for k, fn in fns.items()}
            rec = {"filter": filt, "radius": radius, "shape": [h, w, c],
                   "pixels": h * w, "host_ms": host, "device_ms": dev}
            rows_out.append(rec)
            print(f"{w}x{h}x{c} {filt} r={radius}: host kernel "
                  f"{host['kernel']:.4f} xla {host['xla']:.4f} | device "
                  f"kernel {dev['kernel']:.4f} xla {dev['xla']:.4f}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": args.runs, "cases": rows_out},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
