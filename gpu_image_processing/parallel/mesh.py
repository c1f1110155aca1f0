"""Device-mesh construction for the multi-chip execution paths.

The reference is a single-GPU system (SURVEY 2.4: no NCCL/MPI, device 0
pinned); everything in `parallel/` is therefore an extension: a
`jax.sharding.Mesh` with named axes and XLA collectives (NCCL on GPUs).
Every card of a host reaches every other at the same rate, so the mesh
shape follows the algorithm, not an interconnect topology.

Axes:
    dp -- data parallel over a batch of images
    sp -- spatial parallel over image rows (halo exchange via ppermute)
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: int | None = None,
    dp: int | None = None,
    sp: int | None = None,
    devices: list | None = None,
) -> Mesh:
    """Build a (dp, sp) mesh over the first `n_devices` devices.

    If dp/sp are not given, chooses dp as the largest power-of-two divisor
    <= sqrt(n) so both axes get devices (e.g. 8 -> (2, 4)).  Raises when
    fewer than `n_devices` devices are present (tests get virtual devices
    from `--xla_force_host_platform_device_count` on the CPU backend).
    """
    if devices is None:
        devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} devices but only {len(devices)} present")
    if dp is None and sp is None:
        dp = 1
        while n % (dp * 2) == 0 and dp * 2 <= math.isqrt(n):
            dp *= 2
        sp = n // dp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n}")
    arr = np.array(devices[:n]).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))
