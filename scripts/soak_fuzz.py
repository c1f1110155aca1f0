#!/usr/bin/env python3
"""Randomized serving-runtime soak vs the numpy oracle (CPU, one-off).

Gates:
  box L1/L2: exact.  sobel: the suite's FMA-envelope gate.  gaussian and
  level 4: maxdiff <= 1.

Why gaussian is gated at <= 1 and not exact: XLA contracts a*b+c chains
into FMAs (as nvcc does for the CUDA reference); when a pass sum lands
within half an ulp of an x.5 rounding boundary, floor(x+0.5) flips by one
at that pixel.  Measured incidence: ~1 pixel in 3e4-9e4 at ARBITRARY
sigmas (four cases in one soak, each maxdiff=1 count=1).  The
fixed-sigma suite matrices are deterministic bit-exact; this is
the same numerical class the reference's own maxdiff<=1 comparison gate
exists for (tests/test_comparison.cu:204-221).
"""
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from gpu_image_processing.runtime.dispatch import RUNTIME
from tests import oracle_numpy as oracle
from gpu_image_processing.ops.weights import gaussian_kernel_f32

rng = np.random.default_rng(20260817)
fails = 0
N = int(sys.argv[1]) if len(sys.argv) > 1 else 150
for trial in range(N):
    # bias toward band-boundary heights (the row-fill bug zone)
    if trial % 3 == 0:
        base = int(rng.integers(1, 4)) * 64
        h = base + int(rng.integers(-3, 4))
        h = max(h, 1)
    else:
        h = int(rng.integers(1, 200))
    w = int(rng.integers(3, 200))
    c = int(rng.choice([1, 3, 4]))
    img = rng.integers(0, 256, (h, w, c), np.uint8)
    kind = int(rng.integers(0, 3))
    lvl = int(rng.choice([1, 2, 4]))
    r = 0
    try:
        if kind == 0:
            r = int(rng.integers(1, 16))
            sigma = float(rng.uniform(0.5, 8))
            out, _ = RUNTIME.gaussian_blur(img, sigma=sigma, radius=r, level=lvl)
            want = oracle.gaussian_blur(img, gaussian_kernel_f32(r, sigma), r)
        elif kind == 1:
            r = int(rng.integers(1, 30))
            out, _ = RUNTIME.box_blur(img, radius=r, level=lvl)
            want = oracle.box_blur(img, r)
        else:
            # level 4 sobel serves the LEVEL-1 numerics (float gray, no
            # u8 quantization) through the optimized route -- exercise it
            # as level 4 and compare against the L1 oracle.
            out, _ = RUNTIME.sobel_edge_detection(img, level=lvl)
            want = oracle.sobel(img, 1 if lvl == 4 else lvl)
    except Exception as exc:
        print(f"[{trial}] EXC h={h} w={w} c={c} kind={kind} lvl={lvl}: {exc}")
        fails += 1
        continue
    if kind == 0:
        d = int(np.abs(out.astype(int) - want.astype(int)).max())
        if d > 1:  # FMA tie-break envelope; see module docstring
            print(f"[{trial}] GAUSS MISMATCH h={h} w={w} c={c} r={r} lvl={lvl} maxdiff={d}")
            fails += 1
    elif kind == 1:
        if lvl == 4:
            d = np.abs(out.astype(int) - want.astype(int)).max()
            ok = d <= 1
        else:
            ok = np.array_equal(out, want)
        if not ok:
            print(f"[{trial}] BOX MISMATCH h={h} w={w} c={c} r={r} lvl={lvl}")
            fails += 1
    else:
        d = int(np.abs(out.astype(int) - want.astype(int)).max())
        if c == 1:
            # grayscale has no FMA-contractible multiply chain: exact
            # (tests/sobel_tolerance.py contract).
            ok = d == 0
        else:
            # maxdiff gate only: the suite's 0.1% diff-fraction gate is
            # calibrated for full-size images and binomially noisy on the
            # tiny random shapes here (e.g. w=15: 12 FMA-tie px = 1.3e-3).
            ok = d <= 6
        if not ok:
            print(f"[{trial}] SOBEL MISMATCH h={h} w={w} c={c} lvl={lvl} maxdiff={d}")
            fails += 1

# gaussian with matched sigma, focused on bug-zone heights
for trial in range(N // 2):
    base = int(rng.integers(1, 4)) * 64
    h = max(base + int(rng.integers(-3, 4)), 1)
    w = int(rng.integers(3, 160))
    c = int(rng.choice([1, 3, 4]))
    r = int(rng.integers(1, 16))
    sigma = float(rng.uniform(0.5, 8))
    lvl = int(rng.choice([1, 2, 4]))
    img = rng.integers(0, 256, (h, w, c), np.uint8)
    try:
        out, _ = RUNTIME.gaussian_blur(img, sigma=sigma, radius=r, level=lvl)
    except Exception as exc:
        print(f"[g{trial}] EXC h={h} w={w} c={c} r={r} s={sigma:.2f} lvl={lvl}: {exc}")
        fails += 1
        continue
    want = oracle.gaussian_blur(img, gaussian_kernel_f32(r, sigma), r)
    d = int(np.abs(out.astype(int) - want.astype(int)).max())
    if d > 1:  # FMA tie-break envelope; see module docstring
        print(f"[g{trial}] GAUSS MISMATCH h={h} w={w} c={c} r={r} s={sigma:.2f} lvl={lvl} maxdiff={d}")
        fails += 1

print(f"SOAK DONE: {fails} failures")
sys.exit(1 if fails else 0)
