#!/usr/bin/env python3
"""Filter an image file from the command line.

The analog of the reference's `tests/test_real_image.cu` CLI (stb load ->
validate sigma/radius -> gaussianBlur -> write in the format chosen by the
output extension -> print metrics + 30/60 FPS verdicts, :59-281), extended
to all three filters.  Output format by extension: .png/.ppm/.pgm/.bmp/.tga
/.hdr via the native codec (stb_image_write's full set), anything else via
PIL.

Usage:
    python scripts/filter_image.py INPUT [OUTPUT] [--filter gaussian|box|sobel]
        [--level 1|2] [--sigma 2.0] [--radius 3]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from gpu_image_processing.core import config  # noqa: E402


def load_image(path: str) -> np.ndarray:
    from gpu_image_processing.utils import native_codec

    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm", ".tga") and native_codec.available():
        import ctypes as ct

        lib = native_codec.load()
        reader = lib.gip_ppm_read if ext in (".ppm", ".pgm") else lib.gip_tga_read
        buf = ct.c_void_p()
        h = ct.c_int()
        w = ct.c_int()
        c = ct.c_int()
        reader.restype = ct.c_int
        reader.argtypes = [ct.c_char_p, ct.POINTER(ct.c_void_p),
                           ct.POINTER(ct.c_int), ct.POINTER(ct.c_int),
                           ct.POINTER(ct.c_int)]
        rc = reader(path.encode(), ct.byref(buf), ct.byref(h),
                    ct.byref(w), ct.byref(c))
        if rc == 0:
            raw = ct.string_at(buf, h.value * w.value * c.value)
            lib.gip_free(buf)
            arr = np.frombuffer(raw, np.uint8).reshape(h.value, w.value, c.value)
            if arr.shape[2] == 4:
                # Strip alpha like the reference CLI (test_real_image.cu:122-125).
                arr = np.ascontiguousarray(arr[:, :, :3])
            return arr
    # Byte-sniffed native formats PIL cannot read (HDR, PIC) — plus the
    # no-PIL fallbacks for GIF/BMP/PSD — ride utils.image's tiering,
    # matching the reference CLI's "any format via stb" surface
    # (test_real_image.cu:100).
    try:
        with open(path, "rb") as fh:
            head = fh.read(16)
        if head[:2] == b"#?" or head[:4] == b"\x53\x80\xf6\x34":
            from gpu_image_processing.utils.image import load_image_file

            with open(path, "rb") as fh:
                arr, _, _ = load_image_file(fh.read())
            if arr.shape[2] == 4:
                arr = np.ascontiguousarray(arr[:, :, :3])
            return arr
    except OSError:
        pass
    from PIL import Image

    img = Image.open(path)
    if img.mode == "RGBA":
        # Strip alpha like the reference CLI (test_real_image.cu:122-125).
        img = img.convert("RGB")
    elif img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.array(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def save_image(path: str, arr: np.ndarray) -> None:
    from gpu_image_processing.utils import native_codec

    ext = os.path.splitext(path)[1].lower()
    lib = native_codec.load()
    if lib is not None and ext == ".hdr":
        # Radiance HDR output (stb_image_write's fifth format); PIL cannot
        # write it, so native is the only tier.
        if native_codec.hdr_write(path, arr):
            return
        raise RuntimeError(f"native HDR write failed: {path}")
    if lib is not None and ext in (".png", ".ppm", ".pgm", ".bmp", ".tga"):
        h, w, c = arr.shape
        flat = np.ascontiguousarray(arr, np.uint8)
        import ctypes as ct

        if ext == ".png":
            data = native_codec.png_encode(flat)
            if data:
                with open(path, "wb") as f:
                    f.write(data)
                return
        elif ext in (".ppm", ".pgm"):
            lib.gip_ppm_write.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int,
                                          ct.c_int, ct.c_int]
            if lib.gip_ppm_write(path.encode(),
                                 flat.ctypes.data_as(ct.c_char_p), h, w, c) == 0:
                return
        elif ext == ".bmp":
            lib.gip_bmp_write.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int,
                                          ct.c_int, ct.c_int]
            if lib.gip_bmp_write(path.encode(),
                                 flat.ctypes.data_as(ct.c_char_p), h, w, c) == 0:
                return
        elif ext == ".tga":
            lib.gip_tga_write.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int,
                                          ct.c_int, ct.c_int]
            if lib.gip_tga_write(path.encode(),
                                 flat.ctypes.data_as(ct.c_char_p), h, w, c) == 0:
                return
    if lib is not None and ext in (".jpg", ".jpeg"):
        # PIL's libjpeg-turbo is preferred when present (SIMD, ~8x the
        # scalar baseline encoder); the native tier keeps .jpg output
        # working PIL-less (stb_image_write writes jpg natively too).
        try:
            from PIL import Image  # noqa: F401
        except ImportError:
            # jpeg_encode returns None for several distinct causes; name
            # the actual one so PIL-less failures are diagnosable.
            if not hasattr(lib, "gip_jpeg_encode"):
                raise RuntimeError(
                    "cannot write JPEG without PIL: the native library "
                    "predates the JPEG encoder — rebuild native/build"
                ) from None
            if arr.shape[2] not in (1, 3):
                raise RuntimeError(
                    f"cannot write {arr.shape[2]}-channel image as JPEG "
                    "(native encoder supports grayscale/RGB only)"
                ) from None
            data = native_codec.jpeg_encode(np.ascontiguousarray(arr, np.uint8))
            if data:
                with open(path, "wb") as f:
                    f.write(data)
                return
            raise RuntimeError(f"native JPEG write failed: {path}") from None
    from PIL import Image

    Image.fromarray(arr if arr.shape[2] != 1 else arr[:, :, 0]).save(path)


def load_frames(path: str):
    """(N, H, W, 3) frames + per-frame delays (ms): native tier first
    (utils/native_codec.py::gif_frames, the stbi_load_gif_from_memory
    analog — stb_image.h:433), PIL fallback otherwise."""
    from gpu_image_processing.utils import native_codec

    with open(path, "rb") as fh:
        data = fh.read()
    res = native_codec.gif_frames(data)
    if res is not None:
        frames, delays = res
        return frames[:, :, :, :3], delays, "native"
    import io

    from PIL import Image, ImageSequence

    img = Image.open(io.BytesIO(data))
    frames, delays = [], []
    for i, frame in enumerate(ImageSequence.Iterator(img)):
        frames.append(np.asarray(frame.convert("RGB")))
        delays.append(int(frame.info.get("duration", 0)))
    return np.stack(frames), delays, "pil"


def run_frames(args) -> int:
    frames, delays, tier = load_frames(args.input)
    n, h, w, _ = frames.shape
    print(f"Loaded {args.input}: {n} frame(s), {w}x{h} ({tier} tier), "
          f"delays(ms)={list(delays)}")

    import gpu_filters

    stem, _ = os.path.splitext(args.output or (
        os.path.splitext(args.input)[0] + f"_{args.filter}_l{args.level}.png"))
    total_ms = 0.0
    for i in range(n):
        img = np.ascontiguousarray(frames[i])
        if args.filter == "gaussian":
            result = gpu_filters.gaussian_blur(
                img, sigma=args.sigma, radius=args.radius, level=args.level)
        elif args.filter == "box":
            result = gpu_filters.box_blur(img, radius=args.radius,
                                          level=args.level)
        else:
            result = gpu_filters.sobel_edge_detection(img, level=args.level)
        total_ms += result["time_ms"]
        out_path = f"{stem}_f{i:03d}.png"
        save_image(out_path, result["image"])
        print(f"  frame {i}: {result['time_ms']:.3f} ms -> {out_path}")
    print(f"Total device time: {total_ms:.3f} ms for {n} frames")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input")
    parser.add_argument("output", nargs="?", default=None)
    parser.add_argument("--filter", default="gaussian",
                        choices=["gaussian", "box", "sobel"])
    parser.add_argument("--level", type=int, default=2)
    parser.add_argument("--sigma", type=float, default=config.DEFAULT_SIGMA)
    parser.add_argument("--radius", type=int, default=config.DEFAULT_RADIUS)
    parser.add_argument("--frames", action="store_true",
                        help="decode an animated GIF and filter EVERY frame "
                             "(stbi_load_gif_from_memory analog); outputs "
                             "OUT_f000.png, OUT_f001.png, ...")
    parser.add_argument("--load", choices=["ldr", "16", "float"],
                        default="ldr",
                        help="decode tier: 'ldr' = 8-bit (default); "
                             "'16' = stbi_load_16 analog (PNG/PSD decode "
                             "their native 16-bit samples, others upscale "
                             "v*257; reports the u16 range, filters the "
                             "high byte); 'float' = stbi_loadf analog "
                             "(Radiance HDR decodes to LINEAR floats, LDR "
                             "converts (v/255)^2.2; reports the radiance "
                             "range, filters the stb tone-mapped LDR)")
    args = parser.parse_args()

    # Same CLI-side validation as test_real_image.cu:77-85.
    lo, hi = config.SIGMA_RANGE
    if not (lo <= args.sigma <= hi):
        print(f"Error: sigma must be in [{lo}, {hi}]")
        return 1
    rlo, rhi = config.RADIUS_RANGE
    if not (rlo <= args.radius <= rhi):
        print(f"Error: radius must be in [{rlo}, {rhi}]")
        return 1

    if args.frames:
        return run_frames(args)

    if args.load != "ldr":
        from gpu_image_processing.utils.image import (decode_file_16,
                                                          decode_file_float)

        with open(args.input, "rb") as f:
            raw = f.read()
        if args.load == "16":
            wide = decode_file_16(raw)
            print(f"Loaded {args.input} as uint16: range "
                  f"[{int(wide.min())}, {int(wide.max())}] "
                  f"({wide.shape[2]} channel(s))")
            # stb's 16->8 reduction (v >> 8) feeds the u8 filter path.
            img = (wide >> 8).astype(np.uint8)
        else:
            wide = decode_file_float(raw)
            print(f"Loaded {args.input} as linear float32: range "
                  f"[{wide.min():.4g}, {wide.max():.4g}] "
                  f"({wide.shape[2]} channel(s))")
            # stb's hdr_to_ldr default tone map (gamma 2.2, scale 1).
            ldr = np.power(np.clip(wide, 0.0, None),
                           np.float32(1 / 2.2)) * 255.0 + 0.5
            img = np.clip(ldr, 0, 255).astype(np.uint8)
        if img.shape[2] == 4:
            img = np.ascontiguousarray(img[:, :, :3])
        elif img.shape[2] == 2:
            img = np.ascontiguousarray(img[:, :, :1])
    else:
        img = load_image(args.input)
    h, w, c = img.shape
    print(f"Loaded {args.input}: {w}x{h}, {c} channel(s)")

    import gpu_filters

    if args.filter == "gaussian":
        result = gpu_filters.gaussian_blur(img, sigma=args.sigma,
                                           radius=args.radius, level=args.level)
    elif args.filter == "box":
        result = gpu_filters.box_blur(img, radius=args.radius, level=args.level)
    else:
        result = gpu_filters.sobel_edge_detection(img, level=args.level)

    out_path = args.output or (
        os.path.splitext(args.input)[0] + f"_{args.filter}_l{args.level}.png"
    )
    save_image(out_path, result["image"])

    t = result["time_ms"]
    print(f"Filter: {args.filter} level {args.level}")
    print(f"  Time:      {t:.3f} ms")
    print(f"  Bandwidth: {result['bandwidth_gbps']:.2f} GB/s")
    print(f"  FPS:       {result['fps']:.2f}")
    # 30/60 FPS verdicts, as in test_real_image.cu:259-265.
    for target in (30, 60):
        budget = 1000.0 / target
        verdict = "meets" if t <= budget else "misses"
        print(f"  {verdict} {target} FPS target ({budget:.1f} ms budget)")
    print(f"Saved: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
