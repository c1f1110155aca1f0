#!/usr/bin/env python3
"""Reproduce the reference README's performance table on the GPU.

Reference numbers (RTX 4050 Laptop GPU, CUDA-event kernel timing,
/root/reference/README.md:229-253) vs this framework's device times,
measured with bench.py's loop-delta methodology.

Usage:
    python benchmarks/run_benchmarks.py [--out results.json] [--merge]

--merge folds this run into an existing results file by keeping each row's
MINIMUM time across runs: the least-contended window, matching the
reference's idle-GPU CUDA-event conditions (bench.py takes the min across
rounds within one run for the same reason).
Only rows measuring the same implementation may merge -- bump _IMPL_REV
whenever a timed code path changes so stale minima are discarded; rows
additionally persist the lowered-program fingerprint, and a stored row
whose fingerprint differs from today's never merges even at the same rev
(a forgotten rev bump is detected instead of silently pooling stale minima).

Dispersion: every row keeps `sessions` (this row's direct per-session
samples), `median_ms` (the number a fresh run should reproduce within
noise), and `n_sessions`, alongside `time_ms` (the min -- "best observed").
README quotes the median; the min is reported as best-observed.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (repo-root bench.py)


# Revision of the set of timed implementations.  results.json entries from a
# different revision never merge (they measured different code).  History:
# 2 = level 1 timed through the interleaved rows tier (was planar oracle).
_IMPL_REV = 2

# Per-row revision overrides: when ONE timed path changes, bump only its
# row so the other rows keep their least-contended minima across sessions.
# A row's rev is _IMPL_REV unless overridden here; rows whose stored rev
# differs from the current rev never merge.  History:
# ("sobel", 1) rev 3 = input-replicated phase-0 gray (1.38x, 2026-08-17).
# ("gaussian", 4) rev 3 = an earlier L4 kernel.
_ROW_REV_OVERRIDES = {("sobel", 1): 3,
                      # rev 4: every L2/L4 row times THE SERVED rows
                      # program via dispatch's own rows_fn.
                      ("gaussian", 2): 4, ("box", 2): 4, ("sobel", 2): 4,
                      ("gaussian", 4): 4, ("box", 4): 4, ("sobel", 4): 4}

# Same, for the extended cases (keyed by case label).  History:
# r15 L4 rev 3 = an earlier L4 kernel.
_EXT_REV_OVERRIDES = {"gaussian r15 L4 (maxdiff<=1)": 3}


def _ext_rev(case: str) -> int:
    return _EXT_REV_OVERRIDES.get(case, _IMPL_REV)

# When bumping _IMPL_REV (all rows re-measure), DELETE the overrides whose
# value the new global would collide with -- a stale override equal to the
# new _IMPL_REV would merge minima measured on different code.
assert all(v > _IMPL_REV for v in
           list(_ROW_REV_OVERRIDES.values()) + list(_EXT_REV_OVERRIDES.values())), (
    "_ROW_REV_OVERRIDES must stay ahead of _IMPL_REV; clear stale overrides "
    "when bumping the global rev")


def _row_rev(key) -> int:
    return _ROW_REV_OVERRIDES.get(key, _IMPL_REV)


def _merge_rows(rows, prev_rows, key_fields):
    """Per-entry min-time merge of `prev_rows` into `rows` (in place).

    Rows merge only when their impl revs match (a stored row without a
    `rev` field predates per-row revs and carries the file's global
    impl_rev, which the caller has already checked equals _IMPL_REV) AND,
    when both sides carry a lowered-program fingerprint, the fingerprints
    match -- the exchangeability claim is checked, not assumed on rev-bump
    discipline alone.  Also accumulates each row's per-session sample
    history (`sessions`) for dispersion reporting."""
    prev = {tuple(r.get(k) for k in key_fields): r for r in prev_rows}
    for r in rows:
        p = prev.get(tuple(r.get(k) for k in key_fields))
        if p and p.get("rev", _IMPL_REV) != r.get("rev", _IMPL_REV):
            continue
        if (p and r.get("fingerprint") and p.get("fingerprint")
                and r["fingerprint"] != p["fingerprint"]):
            key = tuple(r.get(k) for k in key_fields)
            print(f"WARNING {key}: stored fingerprint differs at the same "
                  f"rev (missed rev bump?); history discarded", flush=True)
            continue
        if p:
            # Stored sample history; a pre-dispersion row contributes its
            # time_ms as one sample UNLESS it was pooled (then the stored
            # min was not this row's own direct measurement).
            hist = p.get("sessions")
            if hist is None:
                hist = [] if p.get("pooled") else [p["time_ms"]]
            mine = r.get("sessions", [r["time_ms"]])
        if p and p.get("time_ms", float("inf")) < r["time_ms"]:
            keep_wall = r.get("wall_s")
            r.update({k: v for k, v in p.items() if k != "wall_s"})
            if keep_wall is not None:
                r["wall_s"] = keep_wall
            if "pooled" in r and "pooled" not in p:
                del r["pooled"]  # stored min was its own direct sample
                r.pop("pooled_from", None)
        if p:
            r["sessions"] = (hist + mine)[-_MAX_SESSIONS:]


# Per-session sample history cap: enough for dispersion (median stabilizes
# well before this) without the results file growing unboundedly.
_MAX_SESSIONS = 24


def _pool_identical_programs(rows, img) -> None:
    """Share same-session samples across rows that lowered to the
    byte-identical device program (bench.program_fingerprint): any sample
    of one is a valid sample of the other, so each takes the group min.
    Concretely this covers box L2 vs L4 (the same kernel), where
    independent per-row minima otherwise drift apart between sessions and
    publish one tier as slower than the identical program of the other.

    Side effect: stores each row's `fingerprint`, which _merge_rows then
    uses to gate historical merging on checked program identity."""
    groups: dict = {}
    for r in rows:
        fp = r.get("fingerprint")
        if not fp:
            try:
                fp = bench.program_fingerprint(r["filter"], r["level"], img)
            except Exception as exc:  # pooling is an optimization, never fatal
                print(f"fingerprint failed for {r['filter']} L{r['level']}: "
                      f"{exc}", flush=True)
                continue
            r["fingerprint"] = fp
        groups.setdefault(fp, []).append(r)
    for group in groups.values():
        if len(group) < 2:
            continue
        best = min(r["time_ms"] for r in group)
        src = min(group, key=lambda r: r["time_ms"])
        src_name = f"{src['filter']} L{src['level']}"
        names = ", ".join(f"{r['filter']} L{r['level']}" for r in group)
        print(f"pooled identical programs ({names}): {best:.4f} ms",
              flush=True)
        for r in group:
            if r["time_ms"] > best:
                r["time_ms"] = best
                r["speedup_vs_reference"] = round(
                    r["reference_ms"] / best, 3)
                r["pooled"] = True
                r["pooled_from"] = src_name


def _finalize_dispersion(rows) -> None:
    """Emit {median_ms, n_sessions} from each row's sample history.
    `time_ms` stays the cross-session MIN (best observed / least-contended
    window); `median_ms` is what a fresh run should reproduce within noise
    -- README quotes the median (VERDICT r2 #2).

    Medians of fingerprint-identical rows are taken over the UNION of the
    group's session samples -- the same exchangeability argument that
    pools the min: the rows time the identical device program, so pooling
    only the min while medianing disjoint per-row session lists would
    reintroduce (on the now-headline median) the per-row window-luck
    artifact pooling exists to remove.  `sessions` stays each row's own
    direct history; `median_pooled_over` records the union size when it
    differs."""
    import statistics

    for r in rows:
        s = [round(float(v), 4) for v in r.get("sessions", [r["time_ms"]])]
        r["sessions"] = s[-_MAX_SESSIONS:]
    union: dict = {}
    for r in rows:
        fp = r.get("fingerprint")
        if fp:
            union.setdefault(fp, []).extend(r["sessions"])
    for r in rows:
        pool = union.get(r.get("fingerprint")) or r["sessions"]
        r["median_ms"] = round(statistics.median(pool), 4)
        r["n_sessions"] = len(r["sessions"])
        if len(pool) > len(r["sessions"]):
            r["median_pooled_over"] = len(pool)
        else:
            r.pop("median_pooled_over", None)
        if "reference_ms" in r:
            r["speedup_median"] = round(
                r["reference_ms"] / r["median_ms"], 3)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="benchmarks/results.json")
    parser.add_argument("--merge", action="store_true",
                        help="keep per-row min across runs (see docstring)")
    args = parser.parse_args()

    import numpy as np

    from gpu_image_processing.runtime.device import default_device

    rng = np.random.default_rng(12345)
    img = rng.integers(0, 256, size=(bench.H, bench.W, bench.C), dtype=np.uint8)

    rows = []
    for (fname, level), ref_ms in bench.BASELINES_FULL.items():
        t0 = time.time()
        ms = bench.measure_ms(fname, level, img)
        rows.append({
            "filter": fname,
            "level": level,
            "rev": _row_rev((fname, level)),
            "time_ms": round(ms, 4),
            "sessions": [round(ms, 4)],
            "reference_ms": ref_ms,
            "speedup_vs_reference": round(ref_ms / ms, 3),
            "wall_s": round(time.time() - t0, 1),
        })
        print(f"{fname:10} L{level}: {ms:9.3f} ms  (ref {ref_ms:7.3f} ms, "
              f"{ref_ms / ms:6.2f}x)", flush=True)

    _pool_identical_programs(rows, img)

    # Extended (beyond the reference's table): large-radius gaussian.  No
    # reference number exists (the reference only published radius-3).
    from gpu_image_processing.ops.weights import gaussian_kernel_f32
    from gpu_image_processing.runtime.timing import device_time_ms

    import jax

    from gpu_image_processing.ops.pallas.api import level2_impls, level4_impls

    w15 = jax.device_put(gaussian_kernel_f32(15, 4.0), default_device())
    img_dev = jax.device_put(img, default_device())
    ext_arms = [
        ("gaussian r15 L2 (bit-exact)",
         lambda x, w: level2_impls(False)["gaussian"](x, w, 15)),
        ("gaussian r15 L4 (maxdiff<=1)",
         lambda x, w: level4_impls(False)["gaussian"](x, w, 15)),
    ]

    # Serving-scale batch path (beyond the reference: it processes one
    # image per request).  Batch of 4 README images through the natively
    # batched rows kernel; reported per image.
    from gpu_image_processing.ops.pallas.blur import gaussian_rows
    from gpu_image_processing.ops.weights import gaussian_kernel_f32 as _gk

    def rows_batch_operands(h_, w_, batch):
        return jax.device_put(
            np.stack([rng.integers(0, 256, (h_, w_ * bench.C), dtype=np.uint8)
                      for _ in range(batch)]), default_device())

    def rows_batch_ms(rows_in, w_dev, iters=16):
        return device_time_ms(
            lambda x, w: gaussian_rows(x, w, 3, bench.C),
            [rows_in, w_dev], iters=iters)

    BATCH = 4
    rows_b = rows_batch_operands(bench.H, bench.W, BATCH)
    w3 = jax.device_put(_gk(3, 2.0), default_device())
    batch_samples: list[float] = []
    # Arms interleaved WITHIN rounds: drift between rounds then falls on
    # every arm alike, which the L2-vs-L4 comparison needs.
    ext_samples: dict[str, list] = {label: [] for label, _ in ext_arms}
    for _ in range(3):
        for label, impl in ext_arms:
            ext_samples[label].append(
                device_time_ms(impl, [img_dev, w15], iters=48))
        batch_samples.append(rows_batch_ms(rows_b, w3))
    extended = []
    for label, _ in ext_arms:
        s = sorted(ext_samples[label])
        ms = s[len(s) // 2]
        extended.append({"case": label, "rev": _ext_rev(label),
                         "time_ms": round(ms, 4),
                         "sessions": [round(ms, 4)]})
        print(f"{label}: {ms:.3f} ms", flush=True)
    bms = sorted(batch_samples)[len(batch_samples) // 2] / BATCH
    _c = f"gaussian r3 L2 batch{BATCH} (per image)"
    extended.append({
        "case": _c,
        "rev": _ext_rev(_c),
        "time_ms": round(bms, 4),
        "sessions": [round(bms, 4)],
        "images_per_sec": round(1000.0 / bms, 1),
    })
    print(f"gaussian r3 L2 batch{BATCH}: {bms:.3f} ms/image "
          f"({1000.0 / bms:.0f} img/s)", flush=True)

    # The reference's only other published number: its example /api/process
    # response (/root/reference/README.md:204-215) -- gaussian L2 on
    # 1024x1023 RGB: 0.293 ms / 3415.67 fps.  Measured single-image and
    # batch-16 (small images underfill the card alone; the batch rides the
    # kernel's grid, so throughput is the serving-relevant number).
    REF_EX_MS, REF_EX_FPS = 0.293, 3415.67
    img_small = rng.integers(0, 256, size=(1023, 1024, 3), dtype=np.uint8)
    ms_small = bench.measure_ms("gaussian", 2, img_small)
    _c = "gaussian r3 L2 1024x1023 (reference example-API workload)"
    extended.append({
        "case": _c,
        "rev": _ext_rev(_c),
        "time_ms": round(ms_small, 4),
        "sessions": [round(ms_small, 4)],
        "fps": round(1000.0 / ms_small, 1),
        "reference_ms": REF_EX_MS,
        "speedup_vs_reference": round(REF_EX_MS / ms_small, 3),
    })
    print(f"gaussian r3 L2 1024x1023: {ms_small:.3f} ms "
          f"(ref {REF_EX_MS} ms, {REF_EX_MS / ms_small:.2f}x)", flush=True)
    SMALL_BATCH = 16
    rows_small = rows_batch_operands(1023, 1024, SMALL_BATCH)
    small_samples = sorted(rows_batch_ms(rows_small, w3) for _ in range(3))
    sms = small_samples[len(small_samples) // 2] / SMALL_BATCH
    _c = f"gaussian r3 L2 1024x1023 batch{SMALL_BATCH} (per image)"
    extended.append({
        "case": _c,
        "rev": _ext_rev(_c),
        "time_ms": round(sms, 4),
        "sessions": [round(sms, 4)],
        "images_per_sec": round(1000.0 / sms, 1),
        "reference_fps": REF_EX_FPS,
        "throughput_vs_reference": round((1000.0 / sms) / REF_EX_FPS, 3),
    })
    print(f"gaussian r3 L2 1024x1023 batch{SMALL_BATCH}: {sms:.3f} ms/image "
          f"({1000.0 / sms:.0f} img/s vs ref {REF_EX_FPS} fps)", flush=True)

    payload = {
        "workload": f"{bench.W}x{bench.H} RGB",
        "device": str(default_device()),
        "host": platform.node(),
        "impl_rev": _IMPL_REV,
        "rows": rows,
        "extended": extended,
    }
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if (prev.get("impl_rev") == _IMPL_REV
                and prev.get("workload") == payload["workload"]
                and prev.get("device") == payload["device"]):
            _merge_rows(rows, prev.get("rows", []), ("filter", "level"))
            _merge_rows(extended, prev.get("extended", []), ("case",))
            print("merged with previous results (per-row min, least-"
                  "contended window)")
            # Pool once more AFTER the merge: rows identical-by-fingerprint
            # today have been identical for this entire impl rev (the rev
            # gate above guarantees same-rev history measured this same
            # timed path), so their HISTORICAL minima are exchangeable too
            # -- e.g. box L4 inherits box L2's least-contended window
            # instead of waiting to luck into its own.
            _pool_identical_programs(rows, img)
        else:
            print("previous results are a different impl_rev/workload/device;"
                  " not merged")
    _finalize_dispersion(rows)
    _finalize_dispersion(extended)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"\nwritten: {args.out}")

    print("\n| Filter | Level | Median (ms) | Best (ms) | Reference (ms) "
          "| Speedup (median) | Sessions |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['filter']} | {r['level']} | {r['median_ms']:.3f} "
              f"| {r['time_ms']:.3f} | {r['reference_ms']:.3f} "
              f"| {r['speedup_median']:.2f}x | {r['n_sessions']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
