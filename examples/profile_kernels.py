#!/usr/bin/env python3
"""Deep-profile a filter and print the per-kernel duration rows.

On a GPU the rows come from an xplane trace of the ACTUAL served executable
(duration_source=xplane_trace); on the CPU backend the chain falls back to
the isolated-pass estimate or plain device timing -- the tag says which.

    python examples/profile_kernels.py [gaussian|box|sobel]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gpu_image_processing.profiling.profiler import (
    get_common_metrics,
    profile_filter,
)
from gpu_image_processing.runtime.device import warmup_transfers


def main() -> int:
    filt = sys.argv[1] if len(sys.argv) > 1 else "gaussian"
    warmup_transfers()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)

    kwargs = {"gaussian": dict(sigma=2.0, radius=3),
              "box": dict(radius=5), "sobel": {}}[filt]
    deep = profile_filter(img, filt, 2, **kwargs)
    common = get_common_metrics(deep)

    print(f"filter: {filt} L2 on {img.shape}")
    print(f"duration_source: {deep.get('duration_source')}")
    print(f"device time_ms: {deep['total_kernel_duration_ms']:.4f}")
    for name, ms in deep.get("kernel_durations_ms", {}).items():
        print(f"  {ms:8.4f} ms  {name[:100]}")
    if "per_pass_durations_ms" in deep:
        for k, v in deep["per_pass_durations_ms"].items():
            print(f"  {v:8.4f} ms  {k} pass (estimated)")
    for key in ("memory_throughput_gbps", "dram_throughput_pct",
                "occupancy_pct", "compute_throughput_pct"):
        if key in common:
            print(f"{key}: {common[key]:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
