#!/usr/bin/env python3
"""Example: the wide-output loaders (stbi_load_16 / stbi_loadf analogs).

The native codec decodes 16-bit PNG/PSD samples and Radiance-HDR floats
natively (the vendored-stb API surface the reference links in,
/root/reference/external/stb_image.h:445-463); every other format falls
back to the u8 tier with stb's own conversion math.  This example builds
a 16-bit PNG and an HDR file in memory, loads them at full precision,
and runs a filter on the stb-reduced LDR view.
"""

import os
import struct
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from gpu_image_processing.utils.image import (decode_file_16,
                                                  decode_file_float)


def png16(arr16: np.ndarray) -> bytes:
    """Minimal 16-bit RGB PNG writer (filter-0 rows)."""
    h, w, _ = arr16.shape
    raw = b"".join(b"\x00" + arr16[y].astype(">u2").tobytes()
                   for y in range(h))

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def hdr(rgbe: np.ndarray) -> bytes:
    """Flat (old-format) Radiance HDR writer."""
    h, w, _ = rgbe.shape
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n"
    return head.encode() + rgbe.tobytes()


def main() -> None:
    rng = np.random.default_rng(0)

    wide_src = rng.integers(0, 65536, (96, 128, 3))
    a16 = decode_file_16(png16(wide_src))
    print(f"PNG16 -> {a16.dtype} {a16.shape}, range "
          f"[{a16.min()}, {a16.max()}] (native 16-bit samples)")
    assert np.array_equal(a16, wide_src.astype(np.uint16))

    rgbe = rng.integers(2, 256, (64, 96, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (64, 96))
    f = decode_file_float(hdr(rgbe))
    print(f"HDR   -> {f.dtype} {f.shape}, radiance range "
          f"[{f.min():.3g}, {f.max():.3g}] (linear, no tone map)")

    # Filter the stb-reduced LDR view (high byte / tone map).
    import gpu_filters

    ldr = (a16 >> 8).astype(np.uint8)
    r = gpu_filters.gaussian_blur(ldr, sigma=2.0, radius=3, level=2)
    print(f"gaussian L2 on the 16-bit image's high byte: "
          f"{r['image'].shape}, {r['time_ms']:.3f} ms")


if __name__ == "__main__":
    main()
