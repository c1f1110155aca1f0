"""ctypes binding for the native codec library (native/src/gip_codec.cpp).

The native tier accelerates the serving hot path's byte work (PNG
encode/decode, base64); every entry point has a pure-Python fallback in
utils/image.py, so the framework works with or without the built library.

Build: ``cmake -S native -B native/build && cmake --build native/build``,
or ``build()`` below, which compiles the library directly with the C++
compiler when cmake is absent.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False
# dlopen-on-existing-file failures retry (transient: concurrent rebuild,
# memory pressure) but only this many times -- a durably broken .so
# (wrong arch, ABI mismatch, corrupt) must eventually cache the miss like
# a missing file does, not re-stat + re-dlopen on every request forever.
_DLOPEN_ATTEMPTS_LEFT = 5


def _find_library() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        os.environ.get("GIP_NATIVE_LIB", ""),
        os.path.join(here, "native", "build", "libgip_codec.so"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    return None


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _SEARCHED, _DLOPEN_ATTEMPTS_LEFT
    if _SEARCHED:
        return _LIB
    path = _find_library()
    if path is None:
        # Genuinely absent: cache the miss (a later build lands in a new
        # serving process; re-stat'ing every call buys nothing).
        _SEARCHED = True
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        # The file EXISTS but dlopen failed — usually transient (memory
        # pressure, a concurrent rebuild writing the .so).  Do NOT cache
        # the first few failures: a one-off failure here once demoted an
        # entire pytest session to the PIL tier (observed 2026-08-20).
        # But bound the retries — a durably unloadable library (corrupt /
        # wrong arch) must not add a stat+dlopen to every request forever.
        _DLOPEN_ATTEMPTS_LEFT -= 1
        if _DLOPEN_ATTEMPTS_LEFT <= 0:
            _SEARCHED = True
        return None

    lib.gip_free.argtypes = [ctypes.c_void_p]
    lib.gip_base64_encoded_size.restype = ctypes.c_size_t
    lib.gip_base64_encoded_size.argtypes = [ctypes.c_size_t]
    lib.gip_base64_encode.restype = ctypes.c_size_t
    lib.gip_base64_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.gip_base64_decode.restype = ctypes.c_longlong
    lib.gip_base64_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    lib.gip_png_encode.restype = ctypes.c_int
    lib.gip_png_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.gip_png_decode.restype = ctypes.c_int
    lib.gip_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    # Decoders added after the first library revision share one signature;
    # hasattr-guard each so a stale build of the .so still loads.
    for fn_name in (
        "gip_gif_decode",
        "gip_bmp_decode",
        "gip_psd_decode",
        "gip_hdr_decode",
        "gip_pic_decode",
        "gip_pnm_decode",
        "gip_tga_decode",
    ):
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
    fn = getattr(lib, "gip_gif_frames_decode", None)
    if fn is not None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
    try:
        lib.gip_jpeg_encode.restype = ctypes.c_int
        lib.gip_jpeg_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.gip_jpeg_decode.restype = ctypes.c_int
        lib.gip_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
    except AttributeError:  # stale pre-JPEG build of the library
        pass
    # Wide-output decoders (stbi_load_16 / stbi_loadf analogs); same
    # out-param shape as the u8 decoders, only the buffer element differs.
    for fn_name in ("gip_png_decode16", "gip_psd_decode16",
                    "gip_hdr_decodef"):
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
    # Publish _LIB BEFORE _SEARCHED: a concurrent load() that observes
    # _SEARCHED=True must never read _LIB while it is still None (that
    # window transiently demoted one request to the PIL tier).
    _LIB = lib
    _SEARCHED = True
    return _LIB


def available() -> bool:
    return load() is not None


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCES = ("gip_codec.cpp", "gip_jpeg.cpp", "gip_formats.cpp")


def build(timeout_s: float = 600.0) -> str:
    """Build native/build/libgip_codec.so from the repo's sources.

    Uses cmake when present, else the C++ compiler directly (same sources,
    -O2, zlib).  Returns how it was built ("present", "cmake" or "c++");
    raises on failure.  Call before the first load() of the process.
    """
    import shutil
    import subprocess

    src = os.path.join(_REPO, "native")
    out = os.path.join(src, "build")
    lib = os.path.join(out, "libgip_codec.so")
    if os.path.exists(lib):
        try:
            ctypes.CDLL(lib)
            return "present"
        except OSError:
            os.remove(lib)    # built elsewhere: rebuild from source
    if shutil.which("cmake"):
        subprocess.run(["cmake", "-S", src, "-B", out], check=True,
                       capture_output=True, timeout=timeout_s)
        subprocess.run(["cmake", "--build", out, "--target", "gip_codec"],
                       check=True, capture_output=True, timeout=timeout_s)
        return "cmake"
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("neither cmake nor a C++ compiler found")
    os.makedirs(out, exist_ok=True)
    tmp = lib + f".{os.getpid()}.tmp"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-o", tmp,
         *(os.path.join(src, "src", f) for f in _SOURCES), "-lz"],
        check=True, capture_output=True, timeout=timeout_s)
    os.replace(tmp, lib)
    return "c++"


def png_encode(img: np.ndarray, level: int = 1) -> Optional[bytes]:
    """HWC uint8 (C in 1/3/4) -> PNG bytes, or None if unavailable/failed."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    buf = ctypes.c_void_p()
    length = ctypes.c_size_t()
    rc = lib.gip_png_encode(
        img.ctypes.data_as(ctypes.c_char_p), h, w, c, level,
        ctypes.byref(buf), ctypes.byref(length),
    )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(buf, length.value)
    finally:
        lib.gip_free(buf)


def png_decode(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> HWC uint8 array, or None if unsupported (e.g. palette,
    16-bit, interlaced -- the PIL fallback handles those)."""
    lib = load()
    if lib is None:
        return None
    buf = ctypes.c_void_p()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.gip_png_decode(
        data, len(data), ctypes.byref(buf),
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(buf, h.value * w.value * c.value)
    finally:
        lib.gip_free(buf)
    return np.frombuffer(raw, dtype=np.uint8).reshape(h.value, w.value, c.value)


def jpeg_encode(img: np.ndarray, quality: int = 90) -> Optional[bytes]:
    """HWC uint8 (C in 1/3) -> baseline JPEG bytes (4:4:4), or None."""
    lib = load()
    if lib is None or not hasattr(lib, "gip_jpeg_encode"):
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c not in (1, 3):
        return None
    buf = ctypes.c_void_p()
    length = ctypes.c_size_t()
    rc = lib.gip_jpeg_encode(
        img.ctypes.data_as(ctypes.c_char_p), h, w, c, quality,
        ctypes.byref(buf), ctypes.byref(length),
    )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(buf, length.value)
    finally:
        lib.gip_free(buf)


def jpeg_decode(data: bytes) -> Optional[np.ndarray]:
    """Baseline JPEG bytes -> HWC uint8 (gray 1 / RGB 3), or None when the
    stream needs the PIL fallback (progressive, 12-bit, CMYK, ...)."""
    lib = load()
    if lib is None or not hasattr(lib, "gip_jpeg_decode"):
        return None
    buf = ctypes.c_void_p()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.gip_jpeg_decode(
        data, len(data), ctypes.byref(buf),
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(buf, h.value * w.value * c.value)
    finally:
        lib.gip_free(buf)
    return np.frombuffer(raw, dtype=np.uint8).reshape(h.value, w.value, c.value)


def _decode_out_params(fn_name: str, data: bytes) -> Optional[np.ndarray]:
    """Shared ctypes plumbing for the (buf, len) -> (HWC u8) decoders."""
    lib = load()
    if lib is None:
        return None
    fn = getattr(lib, fn_name, None)
    if fn is None:  # stale build of the library
        return None
    buf = ctypes.c_void_p()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = fn(data, len(data), ctypes.byref(buf),
            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(buf, h.value * w.value * c.value)
    finally:
        lib.gip_free(buf)
    return np.frombuffer(raw, dtype=np.uint8).reshape(h.value, w.value, c.value)


def gif_decode(data: bytes) -> Optional[np.ndarray]:
    """GIF87a/89a first frame composited onto the logical screen -> HWC u8
    (RGB, or RGBA when the frame declares a transparent index).  Parity
    target: stb_image's GIF path (/root/reference/external/stb_image.h:126)."""
    return _decode_out_params("gip_gif_decode", data)


def gif_frames(data: bytes, max_frames: int = 0):
    """GIF animation -> (frames, delays): frames is (N, H, W, 4) uint8 RGBA
    canvases composited with disposal semantics, delays is a list of N
    per-frame delays in MILLISECONDS.  The analog of stb's
    stbi_load_gif_from_memory (/root/reference/external/stb_image.h:433;
    stb also reports ms, scaling the GIF centiseconds by 10 at :6916).
    max_frames <= 0 decodes every frame.  Returns None when the library is
    unavailable or the stream is not a decodable GIF."""
    lib = load()
    if lib is None or not hasattr(lib, "gip_gif_frames_decode"):
        return None
    buf = ctypes.c_void_p()
    dbuf = ctypes.c_void_p()
    n = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.gip_gif_frames_decode(
        data, len(data), max_frames, ctypes.byref(buf), ctypes.byref(dbuf),
        ctypes.byref(n), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(buf, n.value * h.value * w.value * c.value)
        delays = list(ctypes.cast(
            dbuf, ctypes.POINTER(ctypes.c_int * n.value)).contents)
    finally:
        lib.gip_free(buf)
        lib.gip_free(dbuf)
    frames = np.frombuffer(raw, dtype=np.uint8).reshape(
        n.value, h.value, w.value, c.value)
    return frames, delays


def bmp_decode(data: bytes) -> Optional[np.ndarray]:
    """BMP (1/4/8-bit palette, 16/24/32-bit BI_RGB/BI_BITFIELDS) -> HWC u8.
    RLE-compressed BMPs return None (PIL fallback handles them)."""
    return _decode_out_params("gip_bmp_decode", data)


def psd_decode(data: bytes) -> Optional[np.ndarray]:
    """PSD composite image (RGB/gray, 8/16-bit, RAW or PackBits) -> HWC u8."""
    return _decode_out_params("gip_psd_decode", data)


def hdr_decode(data: bytes) -> Optional[np.ndarray]:
    """Radiance HDR (RGBE, old + new RLE) -> HWC u8 RGB via the stb-default
    LDR tone map (scale 1, gamma 2.2).  PIL has no HDR path: without this
    tier .hdr uploads fail outright."""
    return _decode_out_params("gip_hdr_decode", data)


def pic_decode(data: bytes) -> Optional[np.ndarray]:
    """Softimage PIC (8-bit packets, uncompressed/mixed RLE) -> HWC u8.
    PIL has no PIC path either; native is the only tier for it."""
    return _decode_out_params("gip_pic_decode", data)


def pnm_decode(data: bytes) -> Optional[np.ndarray]:
    """Binary PNM (P5 gray / P6 RGB, 8/16-bit) -> HWC u8.  stb-compatible
    semantics: raw values for maxval <= 255, high byte for 16-bit
    (stb_image.h:139)."""
    return _decode_out_params("gip_pnm_decode", data)


def tga_decode(data: bytes) -> Optional[np.ndarray]:
    """TGA from memory (truecolor/gray/colormapped, RLE, 15/16/24/32-bpp)
    -> HWC u8.  TGA has no magic bytes, so this tier is only tried last
    (utils/image.py::_tga_plausible), mirroring stb's ordering."""
    return _decode_out_params("gip_tga_decode", data)


def _decode_wide(fn_name: str, data: bytes,
                 dtype: np.dtype) -> Optional[np.ndarray]:
    """Out-param plumbing for the non-u8 decoders (u16 / f32 buffers)."""
    lib = load()
    if lib is None:
        return None
    fn = getattr(lib, fn_name, None)
    if fn is None:  # stale build of the library
        return None
    buf = ctypes.c_void_p()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = fn(data, len(data), ctypes.byref(buf),
            ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        return None
    itemsize = np.dtype(dtype).itemsize
    try:
        raw = ctypes.string_at(buf, h.value * w.value * c.value * itemsize)
    finally:
        lib.gip_free(buf)
    return np.frombuffer(raw, dtype=dtype).reshape(
        h.value, w.value, c.value)


def png_decode16(data: bytes) -> Optional[np.ndarray]:
    """PNG -> HWC uint16: the stbi_load_16_from_memory analog
    (/root/reference/external/stb_image.h:445-449).  Depth-16 samples are
    native (big-endian pairs -> host u16); 8-bit-and-below upscale
    v -> v*257 after the usual gray range expansion / palette lookup
    (stb's stbi__convert_8_to_16)."""
    return _decode_wide("gip_png_decode16", data, np.uint16)


def psd_decode16(data: bytes) -> Optional[np.ndarray]:
    """PSD -> HWC uint16 (stbi_load_16 analog): 16-bit planes native,
    8-bit planes upscaled v*257."""
    return _decode_wide("gip_psd_decode16", data, np.uint16)


def hdr_decodef(data: bytes) -> Optional[np.ndarray]:
    """Radiance HDR -> HWC float32 linear RGB: the stbi_loadf_from_memory
    analog (/root/reference/external/stb_image.h:458-463).  Per-channel
    m * 2^(e-136) RGBE math, NO tone map (the u8 tier applies stb's
    gamma-2.2 LDR reduction; this keeps the radiance values)."""
    return _decode_wide("gip_hdr_decodef", data, np.float32)


def hdr_write(path: str, img: np.ndarray) -> bool:
    """Write HWC uint8 as Radiance HDR (RGBE, new-RLE scanlines), inverting
    the decoder's gamma-2.2 LDR tone map.  Completes stb_image_write's
    format set (PNG/JPG/BMP/TGA/HDR)."""
    lib = load()
    if lib is None or not hasattr(lib, "gip_hdr_write"):
        return False
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    fn = lib.gip_hdr_write
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int]
    return fn(path.encode(), img.ctypes.data_as(ctypes.c_char_p), h, w, c) == 0


def b64_encode(data: bytes) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(lib.gip_base64_encoded_size(len(data)))
    n = lib.gip_base64_encode(data, len(data), out)
    return out.raw[:n]


def b64_decode(text: bytes) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer((len(text) // 4 + 1) * 3)
    n = lib.gip_base64_decode(text, len(text), out)
    if n < 0:
        return None
    return out.raw[:n]
