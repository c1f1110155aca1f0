"""Native decoders for the remaining stb_image format set (gip_formats.cpp).

The reference's C++ tier decodes GIF/BMP/PSD/HDR/PIC through vendored stb
(/root/reference/external/stb_image.h:118-139); these tests pin the native
native equivalents here.  Cross-validation strategy per format:

* GIF / BMP / PSD -- decode the same bytes with PIL and require byte
  equality (PIL is an independent implementation).
* HDR / PIC -- PIL has no decoder; inputs are hand-built in the test and
  compared against an independent numpy expectation.

Formats PIL cannot WRITE (interlaced GIF, 16-bit BMP, RLE PSD, HDR, PIC)
are built by minimal encoders local to this file, so the decoders' RLE and
interlace paths are exercised without any checked-in binary blobs.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from gpu_image_processing.utils import image as image_utils
from gpu_image_processing.utils import native_codec

needs_native = pytest.mark.skipif(
    not native_codec.available(), reason="native codec not built"
)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


# ---------------------------------------------------------------------------
# Minimal encoders (test-local; the product only ever DECODES these formats)
# ---------------------------------------------------------------------------


def _lzw_trivial(indices, min_code_size):
    """Valid GIF LZW: CLEAR before every literal so the table never grows.

    Grossly inefficient (that's fine for a test) but spec-conformant: the
    decoder must handle clear codes at any point.
    """
    clear = 1 << min_code_size
    end = clear + 1
    width = min_code_size + 1
    bits = []
    for k in indices:
        for code in (clear, int(k)):
            for b in range(width):
                bits.append((code >> b) & 1)
    for b in range(width):
        bits.append((end >> b) & 1)
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for j, bit in enumerate(bits[i : i + 8]):
            byte |= bit << j
        out.append(byte)
    return bytes(out)


def _gif_bytes(idx, palette, interlace=False, transparent=None):
    """Single-frame GIF89a covering the whole screen, global color table."""
    h, w = idx.shape
    pal_bits = max(2, int(np.ceil(np.log2(len(palette)))))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HH", w, h)
    out += bytes([0x80 | (pal_bits - 1), 0, 0])
    for i in range(1 << pal_bits):
        out += bytes(palette[i]) if i < len(palette) else b"\0\0\0"
    if transparent is not None:
        out += bytes([0x21, 0xF9, 4, 0x01, 0, 0, transparent, 0])
    out += bytes([0x2C]) + struct.pack("<HHHH", 0, 0, w, h)
    out += bytes([0x40 if interlace else 0x00])
    rows = idx
    if interlace:
        order = (
            list(range(0, h, 8))
            + list(range(4, h, 8))
            + list(range(2, h, 4))
            + list(range(1, h, 2))
        )
        rows = idx[order]
    mcs = max(2, pal_bits)
    out += bytes([mcs])
    data = _lzw_trivial(rows.ravel(), mcs)
    for i in range(0, len(data), 255):
        chunk = data[i : i + 255]
        out += bytes([len(chunk)]) + chunk
    out += bytes([0, 0x3B])
    return bytes(out)


def _gif_anim_bytes(screen_hw, palette, frames, bg=0):
    """Hand-built animated GIF89a (global color table only).

    ``frames`` is a list of dicts: ``idx`` (2-D index array), ``at``
    (fx, fy), ``delay_cs``, ``dispose``, ``transparent`` (index or None).
    Controlling the exact bytes matters because PIL's encoder rewrites
    frames/palettes/GCEs on save (it silently dropped a transparency
    index in testing), so round-tripping THROUGH PIL cannot pin down
    disposal semantics.
    """
    sh, sw = screen_hw
    pal_bits = max(2, int(np.ceil(np.log2(len(palette)))))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HH", sw, sh)
    out += bytes([0x80 | (pal_bits - 1), bg, 0])
    for i in range(1 << pal_bits):
        out += bytes(palette[i]) if i < len(palette) else b"\0\0\0"
    mcs = max(2, pal_bits)
    for fr in frames:
        idx = fr["idx"]
        fx, fy = fr.get("at", (0, 0))
        transparent = fr.get("transparent")
        gce_packed = (fr.get("dispose", 0) << 2) | (
            1 if transparent is not None else 0)
        out += bytes([0x21, 0xF9, 4, gce_packed])
        out += struct.pack("<H", fr.get("delay_cs", 0))
        out += bytes([transparent or 0, 0])
        fh, fw = idx.shape
        out += bytes([0x2C]) + struct.pack("<HHHH", fx, fy, fw, fh)
        out += bytes([0x00, mcs])
        data = _lzw_trivial(idx.ravel(), mcs)
        for i in range(0, len(data), 255):
            chunk = data[i: i + 255]
            out += bytes([len(chunk)]) + chunk
        out += bytes([0])
    out += bytes([0x3B])
    return bytes(out)


def _packbits(row):
    """PackBits with real run packets (not literal-only)."""
    out = bytearray()
    i = 0
    n = len(row)
    while i < n:
        run = 1
        while i + run < n and row[i + run] == row[i] and run < 127:
            run += 1
        if run >= 3:
            out += bytes([256 - (run - 1), row[i]])
            i += run
        else:
            j = i
            while (
                j < n
                and j - i < 128
                and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2])
            ):
                j += 1
            out += bytes([j - i - 1]) + bytes(row[i:j])
            i = j
    return bytes(out)


def _psd_bytes(arr, depth=8, compression=0):
    """Composite-only PSD: RGB(A) or grayscale, RAW or PackBits RLE."""
    h, w = arr.shape[:2]
    nch = 1 if arr.ndim == 2 else arr.shape[2]
    mode = 1 if nch <= 2 else 3
    out = bytearray(b"8BPS")
    out += struct.pack(">H", 1) + b"\0" * 6
    out += struct.pack(">HIIHH", nch, h, w, depth, mode)
    out += struct.pack(">I", 0) * 3  # color mode / resources / layers
    out += struct.pack(">H", compression)
    planes = [arr] if arr.ndim == 2 else [arr[:, :, k] for k in range(nch)]
    if compression == 0:
        for p in planes:
            if depth == 16:
                out += (p.astype(">u2") * 257).tobytes()
            else:
                out += p.tobytes()
    else:
        rows = [
            _packbits(p[y].tobytes()) for p in planes for y in range(h)
        ]
        for r in rows:
            out += struct.pack(">H", len(r))
        for r in rows:
            out += r
    return bytes(out)


def _hdr_bytes(rgbe, new_rle=False):
    """Radiance HDR from an (H, W, 4) RGBE array."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    if not new_rle:
        out += rgbe.tobytes()
        return bytes(out)
    for y in range(h):
        out += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
        for k in range(4):
            plane = rgbe[y, :, k]
            x = 0
            while x < w:
                run = 1
                while x + run < w and plane[x + run] == plane[x] and run < 127:
                    run += 1
                if run >= 4:
                    out += bytes([128 + run, plane[x]])
                    x += run
                else:
                    lit = min(128, w - x)
                    out += bytes([lit]) + plane[x : x + lit].tobytes()
                    x += lit
    return bytes(out)


def _pic_header(w, h):
    out = bytearray(struct.pack(">I", 0x5380F634))
    out += b"\0" * 4 + b"\0" * 80 + b"PICT"
    out += struct.pack(">HH", w, h) + b"\0" * 4 + struct.pack(">HH", 3, 0)
    return out


def _pic_bytes_uncompressed(arr):
    h, w, c = arr.shape
    out = _pic_header(w, h)
    mask = 0xE0 if c == 3 else 0xF0
    out += bytes([0, 8, 0, mask])
    for y in range(h):
        out += arr[y].tobytes()
    return bytes(out)


def _pic_bytes_rle(arr):
    """Mixed-RLE PIC with a chained RGB + alpha packet pair."""
    h, w, c = arr.shape
    assert c == 4
    out = _pic_header(w, h)
    out += bytes([1, 8, 2, 0xE0])  # chained, RLE, RGB
    out += bytes([0, 8, 2, 0x10])  # final, RLE, alpha

    def rle_rows(plane_w, get_px, nch):
        chunk = bytearray()
        x = 0
        while x < plane_w:
            px = get_px(x)
            run = 1
            while x + run < plane_w and get_px(x + run) == px and run < 1000:
                run += 1
            if run >= 2:
                if run > 128:
                    chunk += bytes([128]) + struct.pack(">H", run)
                else:
                    chunk += bytes([127 + run])
                chunk += bytes(px)
                x += run
            else:
                lit = 1
                while (
                    x + lit < plane_w
                    and lit < 128
                    and not (
                        x + lit + 1 < plane_w
                        and get_px(x + lit) == get_px(x + lit + 1)
                    )
                ):
                    lit += 1
                chunk += bytes([lit - 1])
                for i in range(lit):
                    chunk += bytes(get_px(x + i))
                x += lit
        return bytes(chunk)

    for y in range(h):
        row = arr[y]
        out += rle_rows(w, lambda x: tuple(int(v) for v in row[x, :3]), 3)
        out += rle_rows(w, lambda x: (int(row[x, 3]),), 1)
    return bytes(out)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


@needs_native
def test_gif_matches_pil(rng):
    arr = rng.integers(0, 255, size=(23, 31, 3), dtype=np.uint8)
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=200)
    buf = io.BytesIO()
    im.save(buf, format="GIF")
    mine = native_codec.gif_decode(buf.getvalue())
    pil = np.array(Image.open(buf).convert("RGB"))
    assert mine is not None and mine.shape[2] == 3
    np.testing.assert_array_equal(mine, pil)


@needs_native
def test_gif_transparency_matches_pil(rng):
    arr = rng.integers(0, 255, size=(19, 27, 3), dtype=np.uint8)
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=100)
    buf = io.BytesIO()
    im.save(buf, format="GIF", transparency=5)
    mine = native_codec.gif_decode(buf.getvalue())
    pil = np.array(Image.open(buf).convert("RGBA"))
    assert mine is not None and mine.shape[2] == 4
    np.testing.assert_array_equal(mine, pil)


@needs_native
def test_gif_interlaced(rng):
    # PIL cannot write interlaced GIFs; hand-build one and check that the
    # 4-pass row deinterleave reconstructs the source (PIL cross-checks it).
    pal = [(i * 7 % 256, i * 31 % 256, i * 13 % 256) for i in range(16)]
    idx = rng.integers(0, 16, size=(21, 17), dtype=np.uint8)
    data = _gif_bytes(idx, pal, interlace=True)
    mine = native_codec.gif_decode(data)
    expected = np.array([[pal[k] for k in row] for row in idx], dtype=np.uint8)
    assert mine is not None
    np.testing.assert_array_equal(mine, expected)
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(pil, expected)


@needs_native
def test_gif_real_lzw_stream(rng):
    # PIL's encoder emits a REAL adaptive-dictionary LZW stream (unlike the
    # clear-per-pixel trivial encoder above): growing code widths, KwKwK.
    arr = np.tile(rng.integers(0, 255, size=(4, 8, 3), dtype=np.uint8), (16, 16, 1))
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=64)
    buf = io.BytesIO()
    im.save(buf, format="GIF")
    mine = native_codec.gif_decode(buf.getvalue())
    pil = np.array(Image.open(buf).convert("RGB"))
    np.testing.assert_array_equal(mine, pil)


@needs_native
def test_gif_header_bomb_rejected():
    bomb = b"GIF89a" + struct.pack("<HH", 0xFFFF, 0xFFFF) + bytes([0, 0, 0])
    assert native_codec.gif_decode(bomb) is None


@needs_native
def test_gif_truncated_rejected(rng):
    pal = [(i, i, i) for i in range(4)]
    idx = rng.integers(0, 4, size=(9, 9), dtype=np.uint8)
    data = _gif_bytes(idx, pal)
    assert native_codec.gif_decode(data[: len(data) // 2]) is None


@needs_native
def test_gif_truncated_inside_gce_rejected():
    # File ends right after the GCE block-length byte: the still decoder
    # must bounds-check BEFORE peeking the packed/transparent-index bytes
    # (review-found heap OOB read, fixed alongside the frames decoder
    # which already guarded it).
    data = (b"GIF89a" + struct.pack("<HH", 4, 4) + bytes([0, 0, 0])
            + bytes([0x21, 0xF9, 0x04]))
    assert native_codec.gif_decode(data) is None
    assert native_codec.gif_frames(data) is None


# ---------------------------------------------------------------------------
# GIF animation (gip_gif_frames_decode — the stbi_load_gif_from_memory
# analog, /root/reference/external/stb_image.h:433,1444)
# ---------------------------------------------------------------------------


@needs_native
def test_gif_frames_full_replacement_matches_pil(rng):
    # Full-frame opaque replacements: every GIF loader agrees pixel-for-
    # pixel, so PIL is a sound oracle for frames AND delays (ms) here.
    frames_np = [rng.integers(0, 255, (24, 31, 3), dtype=np.uint8)
                 for _ in range(4)]
    ims = [Image.fromarray(f).quantize(colors=64) for f in frames_np]
    buf = io.BytesIO()
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:],
                duration=[100, 50, 70, 30], loop=0)
    data = buf.getvalue()

    res = native_codec.gif_frames(data)
    assert res is not None
    frames, delays = res
    assert frames.shape == (4, 24, 31, 4) and frames.dtype == np.uint8

    pil = Image.open(io.BytesIO(data))
    assert frames.shape[0] == pil.n_frames
    for i in range(pil.n_frames):
        pil.seek(i)
        assert delays[i] == pil.info["duration"]
        np.testing.assert_array_equal(frames[i], np.asarray(pil.convert("RGBA")))


@needs_native
def test_gif_frames_disposal_semantics():
    # Hand-built stream; expected canvases computed by an independent
    # numpy compositor following the spec (GIF89a sec. 23 + stb's model,
    # stb_image.h:6779-6906): dispose 1 keeps, 2 restores the pre-draw
    # snapshot over touched pixels, 3 restores the frame from two back.
    pal = [(10 * i, 20 * i, 5 * i) for i in range(8)]
    spec = [
        dict(idx=np.full((3, 4), 3, np.uint8), at=(1, 1), delay_cs=4,
             dispose=1),
        dict(idx=np.array([[4, 5, 4], [5, 4, 5]], np.uint8), at=(3, 2),
             delay_cs=6, dispose=2, transparent=5),
        dict(idx=np.full((2, 2), 6, np.uint8), at=(0, 0), delay_cs=2,
             dispose=3),
        dict(idx=np.full((1, 1), 7, np.uint8), at=(0, 0), delay_cs=8),
    ]
    data = _gif_anim_bytes((6, 8), pal, spec, bg=2)

    # Independent compositor.
    canvas = np.zeros((6, 8, 4), np.uint8)
    background = canvas.copy()
    history = np.zeros((6, 8), bool)
    expected = []
    prev_dispose = 0
    for k, fr in enumerate(spec):
        if k > 0:
            d = prev_dispose if not (prev_dispose == 3 and k < 2) else 2
            if d == 3:
                canvas[history] = expected[k - 2][history]
            elif d == 2:
                canvas[history] = background[history]
            background = canvas.copy()
        history[:] = False
        fx, fy = fr["at"]
        fh, fw = fr["idx"].shape
        for y in range(fh):
            for x in range(fw):
                v = fr["idx"][y, x]
                if fr.get("transparent") == v:
                    continue
                canvas[fy + y, fx + x] = (*pal[v], 255)
                history[fy + y, fx + x] = True
        if k == 0:  # untouched first-frame pixels take the bg color (bg=2)
            canvas[~history] = (*pal[2], 255)
        expected.append(canvas.copy())
        prev_dispose = fr.get("dispose", 0)

    res = native_codec.gif_frames(data)
    assert res is not None
    frames, delays = res
    assert delays == [40, 60, 20, 80]  # centiseconds x 10 = ms
    assert frames.shape == (4, 6, 8, 4)
    for k in range(4):
        np.testing.assert_array_equal(frames[k], expected[k], err_msg=f"frame {k}")


@needs_native
def test_gif_frames_count_and_delays_match_pil_on_disposal_mix(rng):
    # PIL's encoder rewrites pixels/palettes on save, so for a mixed
    # disposal+transparency fixture only the frame COUNT and per-frame
    # delays are loader-independent — the VERDICT-r3 #9 acceptance.
    pal = sum(([i * 5 % 256, i * 9 % 256, i * 13 % 256]
               for i in range(32)), [])
    base = Image.new("P", (16, 12))
    base.putpalette(pal)
    base.paste(2, (0, 0, 16, 12))
    f1 = Image.new("P", (16, 12)); f1.putpalette(pal); f1.paste(7, (3, 2, 10, 9))
    f2 = Image.new("P", (16, 12)); f2.putpalette(pal); f2.paste(12, (8, 4, 16, 12))
    buf = io.BytesIO()
    base.save(buf, format="GIF", save_all=True, append_images=[f1, f2],
              duration=[10, 20, 30], disposal=[1, 2, 3], transparency=0,
              loop=0)
    data = buf.getvalue()
    res = native_codec.gif_frames(data)
    assert res is not None
    frames, delays = res
    pil = Image.open(io.BytesIO(data))
    assert frames.shape[0] == pil.n_frames
    pil_durations = []
    for i in range(pil.n_frames):
        pil.seek(i)
        pil_durations.append(pil.info["duration"])
    assert delays == pil_durations
    assert frames.shape[1:] == (12, 16, 4)


@needs_native
def test_gif_frames_max_frames_cap(rng):
    frames_np = [rng.integers(0, 255, (9, 7, 3), dtype=np.uint8)
                 for _ in range(5)]
    ims = [Image.fromarray(f).quantize(colors=16) for f in frames_np]
    buf = io.BytesIO()
    ims[0].save(buf, format="GIF", save_all=True, append_images=ims[1:],
                duration=25, loop=0)
    full, d_full = native_codec.gif_frames(buf.getvalue())
    capped, d_cap = native_codec.gif_frames(buf.getvalue(), max_frames=2)
    assert full.shape[0] == 5 and capped.shape[0] == 2
    assert d_cap == d_full[:2]
    np.testing.assert_array_equal(capped, full[:2])


@needs_native
def test_gif_frames_animation_bomb_rejected():
    # 12 one-pixel frames on a 4000x4000 screen: each frame is under the
    # single-image pixel cap but the TOTAL (12 x 16M = 192M px) exceeds
    # kGipMaxDecodePixels — must reject, not allocate ~770 MB.
    pal = [(i, i, i) for i in range(4)]
    spec = [dict(idx=np.zeros((1, 1), np.uint8), delay_cs=1)
            for _ in range(12)]
    data = _gif_anim_bytes((4000, 4000), pal, spec)
    assert native_codec.gif_frames(data) is None
    # ...but a max_frames cap below the bomb threshold still decodes.
    res = native_codec.gif_frames(data, max_frames=2)
    assert res is not None and res[0].shape[0] == 2


@needs_native
def test_gif_frames_still_gif_single_frame(rng):
    # A plain still GIF through the frames API: one frame, delay 0, and
    # the RGB plane agrees with the still decoder where opaque.
    arr = rng.integers(0, 255, size=(13, 17, 3), dtype=np.uint8)
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=50)
    buf = io.BytesIO()
    im.save(buf, format="GIF")
    frames, delays = native_codec.gif_frames(buf.getvalue())
    assert frames.shape[0] == 1 and delays == [0]
    still = native_codec.gif_decode(buf.getvalue())
    np.testing.assert_array_equal(frames[0, :, :, :3], still[:, :, :3])


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


@needs_native
def test_bmp24_matches_pil(rng):
    arr = rng.integers(0, 255, size=(23, 31, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="BMP")
    mine = native_codec.bmp_decode(buf.getvalue())
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_bmp8_palette_matches_pil(rng):
    arr = rng.integers(0, 255, size=(13, 29, 3), dtype=np.uint8)
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=150)
    buf = io.BytesIO()
    im.save(buf, format="BMP")
    mine = native_codec.bmp_decode(buf.getvalue())
    pil = np.array(Image.open(buf).convert("RGB"))
    np.testing.assert_array_equal(mine, pil)


def _bmp_bytes(w, h, bpp, pixel_rows, compression=0, masks=b"", top_down=False):
    row_bytes = ((w * bpp + 31) // 32) * 4
    data = bytearray()
    for row in pixel_rows if top_down else reversed(pixel_rows):
        data += row + b"\0" * (row_bytes - len(row))
    off = 14 + 40 + len(masks)
    out = bytearray(b"BM")
    out += struct.pack("<IHHI", off + len(data), 0, 0, off)
    out += struct.pack(
        "<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, compression,
        len(data), 2835, 2835, 0, 0,
    )
    out += masks + data
    return bytes(out)


@needs_native
def test_bmp16_565_bitfields(rng):
    # 16-bit R5G6B5 via BI_BITFIELDS (PIL writes only 24-bit, so hand-build
    # and cross-check against PIL's own 16-bit decoder).
    w, h = 11, 7
    px = rng.integers(0, 1 << 16, size=(h, w), dtype=np.uint16)
    rows = [px[y].astype("<u2").tobytes() for y in range(h)]
    masks = struct.pack("<III", 0xF800, 0x07E0, 0x001F)
    data = _bmp_bytes(w, h, 16, rows, compression=3, masks=masks)
    mine = native_codec.bmp_decode(data)
    assert mine is not None

    def rep(x, bits):  # stb-style bit replication to 8 bits
        v = x << (8 - bits)
        return v | (v >> bits)

    expected = np.stack(
        [
            rep((px >> 11) & 31, 5),
            rep((px >> 5) & 63, 6),
            rep(px & 31, 5),
        ],
        axis=-1,
    ).astype(np.uint8)
    np.testing.assert_array_equal(mine, expected)
    # PIL truncates (x*255//31) instead of bit-replicating; both legitimate
    # conventions, so the cross-implementation gate is <=1.
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.abs(mine.astype(int) - pil.astype(int)).max() <= 1


@needs_native
def test_bmp32_alpha_and_topdown(rng):
    w, h = 9, 5
    arr = rng.integers(0, 255, size=(h, w, 4), dtype=np.uint8)
    arr[..., 3] = rng.integers(1, 255, size=(h, w))  # real alpha plane
    rows = [
        b"".join(
            bytes([arr[y, x, 2], arr[y, x, 1], arr[y, x, 0], arr[y, x, 3]])
            for x in range(w)
        )
        for y in range(h)
    ]
    data = _bmp_bytes(w, h, 32, rows, top_down=True)
    mine = native_codec.bmp_decode(data)
    assert mine is not None and mine.shape == (h, w, 4)
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_bmp32_zero_alpha_means_opaque(rng):
    w, h = 6, 4
    arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    rows = [
        b"".join(
            bytes([arr[y, x, 2], arr[y, x, 1], arr[y, x, 0], 0])
            for x in range(w)
        )
        for y in range(h)
    ]
    mine = native_codec.bmp_decode(_bmp_bytes(w, h, 32, rows))
    assert mine is not None and mine.shape == (h, w, 4)
    np.testing.assert_array_equal(mine[..., :3], arr)
    assert (mine[..., 3] == 255).all()


@needs_native
def test_bmp4_and_bmp1_palette():
    # 4-bit: 2 pixels per byte, high nibble first; 1-bit: MSB first.
    pal4 = b"".join(
        bytes([i * 16, i * 8, i * 4, 0]) for i in range(16)
    )  # BGRX quads
    rows4 = [bytes([0x01, 0x23, 0xF0]), bytes([0xAB, 0xCD, 0xE0])]
    out4 = bytearray(b"BM")
    data4 = bytearray()
    for row in reversed(rows4):
        data4 += row + b"\0" * (((5 * 4 + 31) // 32) * 4 - len(row))
    off = 14 + 40 + len(pal4)
    out4 += struct.pack("<IHHI", off + len(data4), 0, 0, off)
    out4 += struct.pack("<IiiHHIIiiII", 40, 5, 2, 1, 4, 0, len(data4), 0, 0, 16, 0)
    out4 += pal4 + data4
    mine = native_codec.bmp_decode(bytes(out4))
    pil = np.array(Image.open(io.BytesIO(bytes(out4))).convert("RGB"))
    np.testing.assert_array_equal(mine, pil)


@needs_native
def test_bmp_hostile_full_width_masks():
    # Fuzzer-found: a 32-bit-wide BI_BITFIELDS mask drove a shift-by-32
    # (UB).  Decode must survive and produce the identity-scaled field.
    w, h = 2, 1
    rows = [struct.pack("<II", 0x01020304, 0xA0B0C0D0)]
    masks = struct.pack("<III", 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)
    data = _bmp_bytes(w, h, 32, rows, compression=3, masks=masks)
    mine = native_codec.bmp_decode(data)
    assert mine is not None and mine.shape == (1, 2, 3)
    # width-32 field: value >> (32-8) == top byte, same for every channel
    np.testing.assert_array_equal(mine[0, 0], [0x01, 0x01, 0x01])
    np.testing.assert_array_equal(mine[0, 1], [0xA0, 0xA0, 0xA0])


@needs_native
def test_bmp_rle_falls_back():
    # compression=1 (RLE8) is outside the native subset -> None (PIL tier).
    data = _bmp_bytes(4, 2, 8, [b"\0\0\0\0", b"\0\0\0\0"], compression=1)
    assert native_codec.bmp_decode(data) is None


@needs_native
def test_bmp_header_bomb_rejected():
    out = bytearray(b"BM") + struct.pack("<IHHI", 0xFFFFFF, 0, 0, 54)
    out += struct.pack("<IiiHHIIiiII", 40, 2**30, 2**30, 1, 24, 0, 0, 0, 0, 0, 0)
    assert native_codec.bmp_decode(bytes(out)) is None


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------


@needs_native
def test_psd_raw_rgb_matches_pil(rng):
    arr = rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)
    data = _psd_bytes(arr)
    mine = native_codec.psd_decode(data)
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(mine, arr)
    np.testing.assert_array_equal(pil, arr)


@needs_native
def test_psd_rle_rgb_matches_pil(rng):
    # Runs + literals through the PackBits path; PIL independently decodes.
    base = rng.integers(0, 256, size=(17, 41, 3), dtype=np.uint8)
    base[:, 10:30] = 77  # guaranteed runs
    data = _psd_bytes(base, compression=1)
    mine = native_codec.psd_decode(data)
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(mine, base)
    np.testing.assert_array_equal(pil, base)


@needs_native
def test_psd_rgba(rng):
    arr = rng.integers(0, 256, size=(7, 11, 4), dtype=np.uint8)
    mine = native_codec.psd_decode(_psd_bytes(arr))
    assert mine is not None and mine.shape == (7, 11, 4)
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_psd_grayscale(rng):
    arr = rng.integers(0, 256, size=(8, 9), dtype=np.uint8)
    mine = native_codec.psd_decode(_psd_bytes(arr))
    assert mine is not None and mine.shape == (8, 9, 1)
    np.testing.assert_array_equal(mine[:, :, 0], arr)


@needs_native
def test_psd_16bit_takes_high_byte(rng):
    arr = rng.integers(0, 256, size=(6, 7, 3), dtype=np.uint8)
    mine = native_codec.psd_decode(_psd_bytes(arr, depth=16))
    # The encoder writes v*257 (= v<<8 | v), so the high byte is v exactly.
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_psd_header_bomb_rejected():
    hdr = b"8BPS" + struct.pack(">H", 1) + b"\0" * 6
    hdr += struct.pack(">HIIHH", 3, 2**30, 2**30, 8, 3)
    hdr += struct.pack(">I", 0) * 3 + struct.pack(">H", 0)
    assert native_codec.psd_decode(hdr) is None


# ---------------------------------------------------------------------------
# HDR (no PIL decoder exists; expectations are computed independently)
# ---------------------------------------------------------------------------


def _hdr_expected_u8(rgbe):
    e = rgbe[..., 3].astype(np.int32)
    f = rgbe[..., :3].astype(np.float64) * np.exp2(e - 136)[..., None]
    f[e == 0] = 0.0
    z = np.power(f, 1 / 2.2) * 255.0 + 0.5
    return np.clip(z, 0, 255).astype(np.uint8)


def _safe_rgbe(rng, h, w):
    rgbe = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(100, 140, size=(h, w))
    # avoid colliding with the old-format (1,1,1,n) run marker
    hit = (rgbe[..., 0] == 1) & (rgbe[..., 1] == 1) & (rgbe[..., 2] == 1)
    rgbe[..., 0][hit] = 2
    return rgbe


@needs_native
def test_hdr_flat_old_format(rng):
    rgbe = _safe_rgbe(rng, 5, 6)
    mine = native_codec.hdr_decode(_hdr_bytes(rgbe))
    np.testing.assert_array_equal(mine, _hdr_expected_u8(rgbe))


@needs_native
def test_hdr_new_rle(rng):
    rgbe = _safe_rgbe(rng, 7, 33)
    rgbe[:, 5:25, 0] = 44  # guaranteed runs in the red plane
    mine = native_codec.hdr_decode(_hdr_bytes(rgbe, new_rle=True))
    np.testing.assert_array_equal(mine, _hdr_expected_u8(rgbe))


@needs_native
def test_hdr_old_style_run_marker():
    # (1,1,1,n) repeats the previous pixel n times within a scanline; the
    # shift state resets on each literal pixel.
    w, h = 4, 2
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    px = bytes([64, 128, 255, 130])
    px2 = bytes([10, 20, 30, 128])
    stream = (
        px + bytes([1, 1, 1, 3])    # row 0: literal + run of 3
        + px2 + bytes([1, 1, 1, 3])  # row 1: literal + run of 3
    )
    rgbe = np.frombuffer(px * 4 + px2 * 4, dtype=np.uint8).reshape(h, w, 4)
    mine = native_codec.hdr_decode(head + stream)
    np.testing.assert_array_equal(mine, _hdr_expected_u8(rgbe))


@needs_native
def test_hdr_zero_exponent_is_black():
    w, h = 2, 1
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    data = head + bytes([200, 200, 200, 0, 10, 20, 30, 128])
    mine = native_codec.hdr_decode(data)
    assert (mine[0, 0] == 0).all()


@needs_native
def test_hdr_rejects_other_orientations():
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 1\n" + bytes(4)
    assert native_codec.hdr_decode(head) is None


@needs_native
def test_hdr_header_bomb_rejected():
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 99999 +X 99999\n"
    assert native_codec.hdr_decode(head) is None


# ---------------------------------------------------------------------------
# PIC (no PIL decoder exists)
# ---------------------------------------------------------------------------


@needs_native
def test_pic_uncompressed_rgb(rng):
    arr = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    mine = native_codec.pic_decode(_pic_bytes_uncompressed(arr))
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_pic_rle_rgba_chained_packets(rng):
    arr = rng.integers(0, 256, size=(6, 200, 4), dtype=np.uint8)
    arr[:, 20:180, :3] = 99  # long run -> exercises the 128/u16be count path
    arr[:, 50:150, 3] = 255
    mine = native_codec.pic_decode(_pic_bytes_rle(arr))
    assert mine is not None and mine.shape == (6, 200, 4)
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_pic_header_bomb_rejected():
    out = _pic_header(0xFFFF, 0xFFFF) + bytes([0, 8, 0, 0xE0])
    assert native_codec.pic_decode(bytes(out)) is None


# ---------------------------------------------------------------------------
# Serving-path routing + tier counters
# ---------------------------------------------------------------------------


def _b64(data):
    import base64

    return base64.b64encode(data).decode()


@needs_native
def test_hdr_serves_via_native_tier(rng):
    # PIL cannot decode HDR: without the native tier this upload FAILS.
    rgbe = _safe_rgbe(rng, 4, 9)
    image_utils.reset_decode_tier_counts()
    arr = image_utils.decode_base64_image(_b64(_hdr_bytes(rgbe)))
    assert arr.shape == (4, 9, 3)
    assert image_utils.decode_tier_counts()["native_hdr"] == 1


@needs_native
def test_pic_serves_via_native_tier(rng):
    arr0 = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    image_utils.reset_decode_tier_counts()
    arr = image_utils.decode_base64_image(_b64(_pic_bytes_uncompressed(arr0)))
    np.testing.assert_array_equal(arr, arr0)
    assert image_utils.decode_tier_counts()["native_pic"] == 1


def test_gif_still_serves_via_pil_tier(rng):
    # GIF keeps PIL first (measured-preferred); the native tier is fallback.
    arr = rng.integers(0, 255, size=(9, 11, 3), dtype=np.uint8)
    im = Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE, colors=32)
    buf = io.BytesIO()
    im.save(buf, format="GIF")
    image_utils.reset_decode_tier_counts()
    out = image_utils.decode_base64_image(_b64(buf.getvalue()))
    assert out.shape[2] == 3
    assert image_utils.decode_tier_counts()["pil"] == 1


@needs_native
def test_load_image_file_hdr(rng):
    rgbe = _safe_rgbe(rng, 3, 8)
    arr, w, h = image_utils.load_image_file(_hdr_bytes(rgbe))
    assert (h, w) == (3, 8) and arr.shape == (3, 8, 3)
    np.testing.assert_array_equal(arr, _hdr_expected_u8(rgbe))


@needs_native
def test_normalized_rgb_from_native_gif_alpha(rng):
    # RGBA GIF through the serving decode path must land as RGB.
    pal = [(i * 3 % 256, i * 5 % 256, i * 7 % 256) for i in range(8)]
    idx = rng.integers(0, 8, size=(6, 6), dtype=np.uint8)
    data = _gif_bytes(idx, pal, transparent=2)
    mine = native_codec.gif_decode(data)
    assert mine is not None and mine.shape[2] == 4
    arr = image_utils.decode_base64_image(_b64(data))
    assert arr.shape == (6, 6, 3)


# ---------------------------------------------------------------------------
# Binary PNM (P5/P6) -- stb_image.h:139 ".pnm (.ppm and .pgm binary only)"
# ---------------------------------------------------------------------------


@needs_native
def test_pnm_p6_matches_pil(rng):
    arr = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PPM")
    mine = native_codec.pnm_decode(buf.getvalue())
    np.testing.assert_array_equal(mine, arr)


@needs_native
def test_pnm_p5_matches_pil(rng):
    gray = rng.integers(0, 256, size=(9, 11), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, format="PPM")
    mine = native_codec.pnm_decode(buf.getvalue())
    np.testing.assert_array_equal(mine[:, :, 0], gray)
    assert mine.shape == (9, 11, 1)


@needs_native
def test_pnm_comments_and_packed_whitespace(rng):
    arr = rng.integers(0, 256, size=(2, 3, 3), dtype=np.uint8)
    data = b"P6 # trailing comment\n#full line\n 3 \n# another\n2\t255 " + arr.tobytes()
    np.testing.assert_array_equal(native_codec.pnm_decode(data), arr)


@needs_native
def test_pnm_16bit_takes_high_byte(rng):
    vals = rng.integers(0, 65536, size=(3, 4), dtype=np.uint16)
    data = b"P5 4 3 65535\n" + vals.astype(">u2").tobytes()
    mine = native_codec.pnm_decode(data)
    # stb's 16->8 conversion is the high byte (stbi__convert_16_to_8).
    np.testing.assert_array_equal(mine[:, :, 0], (vals >> 8).astype(np.uint8))


@needs_native
def test_pnm_header_bomb_rejected():
    assert native_codec.pnm_decode(b"P6 2000000 2000000 255 ") is None


@needs_native
def test_pnm_truncated_rejected(rng):
    arr = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PPM")
    assert native_codec.pnm_decode(buf.getvalue()[:-7]) is None


@needs_native
def test_pnm_serves_native_when_pil_absent(rng):
    arr = rng.integers(0, 256, size=(5, 6, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PPM")
    orig = image_utils.PIL_AVAILABLE
    image_utils.PIL_AVAILABLE = False
    try:
        image_utils.reset_decode_tier_counts()
        out = image_utils.decode_base64_image(_b64(buf.getvalue()))
        np.testing.assert_array_equal(out, arr)
        assert image_utils.decode_tier_counts()["native_pnm"] == 1
    finally:
        image_utils.PIL_AVAILABLE = orig


# ---------------------------------------------------------------------------
# TGA from memory (type 1/2/3 + RLE variants; stb_image.h:122)
# ---------------------------------------------------------------------------


@needs_native
def test_tga_mem_rle_matches_pil(rng):
    arr = rng.integers(0, 256, size=(10, 7, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TGA", compression="tga_rle")
    np.testing.assert_array_equal(native_codec.tga_decode(buf.getvalue()), arr)


@needs_native
def test_tga_mem_rgba_and_gray_match_pil(rng):
    rgba = rng.integers(0, 256, size=(6, 5, 4), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, format="TGA")
    np.testing.assert_array_equal(native_codec.tga_decode(buf.getvalue()), rgba)
    gray = rng.integers(0, 256, size=(4, 9), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, format="TGA")
    np.testing.assert_array_equal(
        native_codec.tga_decode(buf.getvalue())[:, :, 0], gray
    )


def _tga_colormapped_bytes(idx, pal_rgb, origin=0, rle=False):
    """Hand-built type-1/9 TGA (8-bit indices, 24-bit BGR palette)."""
    h, w = idx.shape
    n = len(pal_rgb)
    hdr = struct.pack(
        "<BBBHHBHHHHBB",
        0, 1, 9 if rle else 1,
        origin, n, 24,
        0, 0, w, h, 8, 0x20,  # top-down
    )
    pal = b"".join(bytes((b, g, r)) for (r, g, b) in pal_rgb)
    if rle:
        body = b"".join(bytes((0x80, int(k))) for k in idx.reshape(-1))  # runs of 1
    else:
        body = idx.astype(np.uint8).tobytes()
    return hdr + pal + body


@needs_native
def test_tga_colormapped(rng):
    pal = [(int(i * 7 % 256), int(i * 13 % 256), int(i * 29 % 256)) for i in range(16)]
    idx = rng.integers(0, 16, size=(6, 8), dtype=np.uint8)
    mine = native_codec.tga_decode(_tga_colormapped_bytes(idx, pal))
    expect = np.array(pal, dtype=np.uint8)[idx]
    np.testing.assert_array_equal(mine, expect)
    # RLE variant decodes identically.
    mine_rle = native_codec.tga_decode(_tga_colormapped_bytes(idx, pal, rle=True))
    np.testing.assert_array_equal(mine_rle, expect)


@needs_native
def test_tga_colormapped_origin_offset(rng):
    pal = [(10, 20, 30), (200, 100, 50)]
    idx = np.array([[4, 5], [5, 4]], dtype=np.uint8)  # indices offset by 4
    mine = native_codec.tga_decode(_tga_colormapped_bytes(idx, pal, origin=4))
    expect = np.array(pal, dtype=np.uint8)[idx - 4]
    np.testing.assert_array_equal(mine, expect)


@needs_native
def test_tga_16bpp_bit_replication():
    # A1R5G5B5 little-endian; 5-bit fields scale by bit replication
    # (matching the BMP 16-bit path's scale_field).
    px = struct.pack("<HH", 0x7C00, 0x03E0)  # pure R, pure G
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 2, 1, 16, 0x20)
    mine = native_codec.tga_decode(hdr + px)
    np.testing.assert_array_equal(mine[0, 0], [255, 0, 0])
    np.testing.assert_array_equal(mine[0, 1], [0, 255, 0])


@needs_native
def test_tga_serves_native_when_pil_absent(rng):
    arr = rng.integers(0, 256, size=(5, 6, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="TGA", compression="tga_rle")
    orig = image_utils.PIL_AVAILABLE
    image_utils.PIL_AVAILABLE = False
    try:
        image_utils.reset_decode_tier_counts()
        out = image_utils.decode_base64_image(_b64(buf.getvalue()))
        np.testing.assert_array_equal(out, arr)
        assert image_utils.decode_tier_counts()["native_tga"] == 1
    finally:
        image_utils.PIL_AVAILABLE = orig


def test_tga_plausibility_rejects_text():
    # TGA has no magic; the plausibility sniff must not route text/garbage.
    assert not image_utils._tga_plausible(b"hello world, this is not an image")
    assert not image_utils._tga_plausible(b"{\"json\": true, \"x\": 12345678}")
    fn, _ = image_utils._sniff_native_fallback(b"plain text payload here...")
    assert fn is None


@needs_native
def test_tga_header_bomb_rejected():
    # 65535x65535 (> kGipMaxDecodePixels) must reject, not allocate 12 GB.
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 65535, 65535, 24, 0x20)
    assert native_codec.tga_decode(hdr + b"\0" * 64) is None


# ---------------------------------------------------------------------------
# HDR writer (stb_image_write's fifth format; stb_image_write.h:140-170)
# ---------------------------------------------------------------------------


def _hdr_write_model(img_rgb):
    """Numpy model of hdr_write + hdr_decode: u8 -> linear (gamma 2.2) ->
    RGBE (truncated mantissa, shared exponent) -> LDR tone map."""
    lin = np.power(img_rgb.astype(np.float32) / np.float32(255.0), np.float32(2.2))
    m = lin.max(axis=-1)
    e = np.zeros(m.shape, np.int32)
    f = np.zeros(m.shape, np.float32)
    nz = m >= 1e-32
    f[nz], e[nz] = np.frexp(m[nz])
    scale = np.where(nz, f * np.float32(256.0) / np.where(nz, m, 1), 0).astype(np.float32)
    q = np.minimum(lin * scale[..., None], 255.0).astype(np.uint8)
    rgbe = np.concatenate([q, np.where(nz, e + 128, 0)[..., None]], axis=-1)
    return _hdr_expected_u8(rgbe.astype(np.uint8))


@needs_native
def test_hdr_write_roundtrip_matches_model(rng, tmp_path):
    for shape in [(21, 33, 3), (5, 4, 3)]:  # RLE width and flat (<8) width
        src = rng.integers(0, 256, size=shape, dtype=np.uint8)
        path = str(tmp_path / "out.hdr")
        assert native_codec.hdr_write(path, src)
        back = native_codec.hdr_decode(open(path, "rb").read())
        model = _hdr_write_model(src)
        # C float vs numpy float32 can differ by 1 at truncation boundaries.
        assert np.abs(back.astype(int) - model.astype(int)).max() <= 1


@needs_native
def test_hdr_write_gray_ramp_within_one(tmp_path):
    # On gray pixels all three channels are the max channel: the RGBE
    # roundtrip must reproduce every level within +-1.
    ramp = np.tile(np.arange(256, dtype=np.uint8)[None, :, None], (2, 1, 3))
    path = str(tmp_path / "ramp.hdr")
    assert native_codec.hdr_write(path, ramp)
    back = native_codec.hdr_decode(open(path, "rb").read())
    assert np.abs(back.astype(int) - ramp.astype(int)).max() <= 1


@needs_native
def test_hdr_write_gray_and_rgba_inputs(rng, tmp_path):
    gray = rng.integers(0, 256, size=(7, 9, 1), dtype=np.uint8)
    path = str(tmp_path / "g.hdr")
    assert native_codec.hdr_write(path, gray)
    back = native_codec.hdr_decode(open(path, "rb").read())
    assert np.abs(back.astype(int) - np.repeat(gray, 3, axis=2).astype(int)).max() <= 1
    rgba = rng.integers(0, 256, size=(4, 8, 4), dtype=np.uint8)
    assert native_codec.hdr_write(path, rgba)  # alpha dropped
    assert native_codec.hdr_decode(open(path, "rb").read()).shape == (4, 8, 3)


# ---------------------------------------------------------------------------
# PNG variant matrix (VERDICT r3 item 3): the native decoder covers the full
# stb set -- gray 1/2/4/8/16, palette 1/2/4/8 (+tRNS alpha), RGB/GA/RGBA
# 8/16, interlace none + Adam7 (stb_image.h:24,4861,5134).  stb-matching
# reductions: 16-bit takes the HIGH byte, sub-8-bit gray scales to 0..255.
# PIL writes none of the exotic combos, so a minimal spec-direct writer
# lives here and PIL serves as the independent DECODER for cross-checks.
# ---------------------------------------------------------------------------

_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def _png_bytes(arr, depth, color, interlace=0, palette=None, trns=None):
    """Minimal PNG writer (filter 0 rows, optional Adam7 layout)."""
    import zlib

    h, w = arr.shape[:2]
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    a = arr.reshape(h, w, samples)

    def pack_rows(sub):
        ph, pw = sub.shape[:2]
        out = bytearray()
        for y in range(ph):
            out.append(0)  # filter None
            if depth == 16:
                out += sub[y].astype(">u2").tobytes()
            elif depth == 8:
                out += sub[y].astype(np.uint8).tobytes()
            else:
                bits = "".join(
                    format(int(v), f"0{depth}b") for v in sub[y, :, 0])
                bits += "0" * (-len(bits) % 8)
                if bits:
                    out += int(bits, 2).to_bytes(len(bits) // 8, "big")
        return bytes(out)

    if interlace:
        raw = b"".join(
            pack_rows(a[y0::dy, x0::dx]) for (x0, y0, dx, dy) in _ADAM7
            if a[y0::dy, x0::dx].shape[0] and a[y0::dy, x0::dx].shape[1])
    else:
        raw = pack_rows(a)

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d)))

    png = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        png += chunk(b"PLTE", bytes(palette.flatten()))
    if trns is not None:
        png += chunk(b"tRNS", bytes(trns))
    return png + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _pil_u8(data, mode=None):
    img = Image.open(io.BytesIO(data))
    if mode:
        img = img.convert(mode)
    arr = np.array(img)
    if arr.dtype == np.uint16:
        arr = (arr >> 8).astype(np.uint8)   # high byte, like stb
    if arr.dtype == bool:
        arr = arr.astype(np.uint8) * 255
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


@needs_native
@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_gray_depths(rng, depth, interlace):
    g = rng.integers(0, 1 << min(depth, 16), (13, 17))
    nat = native_codec.png_decode(_png_bytes(g, depth, 0, interlace))
    assert nat is not None and nat.shape == (13, 17, 1)
    np.testing.assert_array_equal(
        nat, _pil_u8(_png_bytes(g, depth, 0, interlace)))


@needs_native
@pytest.mark.parametrize("color,channels", [(2, 3), (4, 2), (6, 4)])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_multisample_depths(rng, color, channels, depth):
    a = rng.integers(0, 1 << depth, (11, 19, channels))
    nat = native_codec.png_decode(_png_bytes(a, depth, color))
    assert nat is not None and nat.shape == (11, 19, channels)
    want = (a >> 8 if depth == 16 else a).astype(np.uint8)
    np.testing.assert_array_equal(nat, want)


@needs_native
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_palette_matches_pil(rng, depth, interlace):
    n = 1 << depth
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    idx = rng.integers(0, n, (13, 17))
    data = _png_bytes(idx, depth, 3, interlace, palette=pal)
    nat = native_codec.png_decode(data)
    assert nat is not None and nat.shape == (13, 17, 3)
    np.testing.assert_array_equal(nat, _pil_u8(data, "RGB"))


@needs_native
def test_png_palette_trns_alpha(rng):
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    trns = list(rng.integers(0, 256, 5))
    idx = rng.integers(0, 16, (9, 14))
    data = _png_bytes(idx, 4, 3, palette=pal, trns=trns)
    nat = native_codec.png_decode(data)
    assert nat is not None and nat.shape == (9, 14, 4)
    np.testing.assert_array_equal(nat, _pil_u8(data, "RGBA"))


@needs_native
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (7, 5), (8, 9), (16, 16)])
def test_png_adam7_degenerate_passes(rng, hw):
    """Sub-8x8 images leave some Adam7 passes empty; every geometry must
    still reassemble exactly (cross-checked against PIL's interlace
    reader)."""
    a = rng.integers(0, 256, (*hw, 3))
    data = _png_bytes(a, 8, 2, interlace=1)
    nat = native_codec.png_decode(data)
    np.testing.assert_array_equal(nat, a.astype(np.uint8)[:, :, :])
    np.testing.assert_array_equal(nat, _pil_u8(data))


@needs_native
def test_png_16bit_interlaced(rng):
    a = rng.integers(0, 65536, (13, 17, 4))
    nat = native_codec.png_decode(_png_bytes(a, 16, 6, interlace=1))
    np.testing.assert_array_equal(nat, (a >> 8).astype(np.uint8))


@needs_native
def test_png_malformed_variants_rejected(rng):
    # Palette image without PLTE; index past the palette; illegal
    # depth/color combos -- all must fail cleanly, not crash.
    idx = rng.integers(0, 4, (5, 5))
    assert native_codec.png_decode(_png_bytes(idx, 2, 3)) is None
    pal = rng.integers(0, 256, (2, 3)).astype(np.uint8)
    bad_idx = np.full((4, 4), 3)  # palette has 2 entries
    assert native_codec.png_decode(
        _png_bytes(bad_idx, 2, 3, palette=pal)) is None
    rgb = rng.integers(0, 256, (4, 4, 3))
    data = bytearray(_png_bytes(rgb, 8, 2))
    data[24] = 4  # depth 4 with color 2: illegal per spec table 11.1
    assert native_codec.png_decode(bytes(data)) is None


# ---------------------------------------------------------------------------
# Wide-output loaders: stbi_load_16 / stbi_loadf analogs (round 5; closes
# the last vendored-stb API delta, stb_image.h:445-463)
# ---------------------------------------------------------------------------


@needs_native
def test_png16_gray_native_matches_pil(rng):
    """16-bit gray PNG: native u16 samples cross-validated against PIL's
    I;16 read of the same bytes."""
    a = rng.integers(0, 65536, (13, 11), np.uint16)
    png = _png_bytes(a[..., None].astype(np.int64), 16, 0)
    out = native_codec.png_decode16(png)
    assert out is not None and out.dtype == np.uint16
    assert out.shape == (13, 11, 1)
    pil = np.array(Image.open(io.BytesIO(png))).astype(np.uint16)
    np.testing.assert_array_equal(out[:, :, 0], pil)


@needs_native
def test_png16_rgb_and_rgba_native_samples(rng):
    for color, c in ((2, 3), (6, 4)):
        a = rng.integers(0, 65536, (7, 5, c))
        out = native_codec.png_decode16(_png_bytes(a, 16, color))
        np.testing.assert_array_equal(out, a.astype(np.uint16))


@needs_native
def test_png16_adam7_native_samples(rng):
    a = rng.integers(0, 65536, (13, 17, 3))
    out = native_codec.png_decode16(_png_bytes(a, 16, 2, interlace=1))
    np.testing.assert_array_equal(out, a.astype(np.uint16))


@needs_native
def test_png16_of_8bit_sources_upscales_v257(rng):
    """8-bit and sub-8-bit PNGs upscale v -> v*257 (stb's
    stbi__convert_8_to_16), AFTER gray range expansion / palette lookup."""
    rgb = rng.integers(0, 256, (9, 6, 3))
    out = native_codec.png_decode16(_png_bytes(rgb, 8, 2))
    np.testing.assert_array_equal(out, rgb.astype(np.uint16) * 257)
    # 2-bit gray: 0..3 expands to 0/85/170/255 then *257.
    g2 = rng.integers(0, 4, (8, 8))
    out = native_codec.png_decode16(_png_bytes(g2, 2, 0))
    np.testing.assert_array_equal(
        out[:, :, 0], (g2 * 85).astype(np.uint16) * 257)
    # Palette (+tRNS alpha): entries are 8-bit -> *257.
    pal = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    idx = rng.integers(0, 4, (6, 7))
    trns = bytes([255, 128, 0, 7])
    out = native_codec.png_decode16(
        _png_bytes(idx, 8, 3, palette=pal, trns=trns))
    assert out.shape == (6, 7, 4)
    np.testing.assert_array_equal(
        out[:, :, :3], pal[idx].astype(np.uint16) * 257)
    np.testing.assert_array_equal(
        out[:, :, 3],
        np.frombuffer(trns, np.uint8)[idx].astype(np.uint16) * 257)


@needs_native
def test_png16_high_byte_consistency_with_u8_tier(rng):
    """The u8 tier's 16->8 reduction is the high byte; decode16 >> 8 must
    reproduce it exactly on the same bytes."""
    a = rng.integers(0, 65536, (11, 9, 3))
    png = _png_bytes(a, 16, 2)
    wide = native_codec.png_decode16(png)
    narrow = native_codec.png_decode(png)
    np.testing.assert_array_equal((wide >> 8).astype(np.uint8), narrow)


@needs_native
def test_psd16_native_and_8bit_upscale(rng):
    """PSD depth-16 planes decode natively; depth-8 planes upscale v*257.
    (_psd_bytes writes u8 input as v*257 16-bit samples, so both paths
    must agree with arr*257.)"""
    arr = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    for depth in (8, 16):
        out = native_codec.psd_decode16(_psd_bytes(arr, depth=depth))
        assert out is not None and out.dtype == np.uint16
        np.testing.assert_array_equal(out, arr.astype(np.uint16) * 257)
    # 16-bit high-byte consistency with the u8 tier.
    wide = native_codec.psd_decode16(_psd_bytes(arr, depth=16))
    narrow = native_codec.psd_decode(_psd_bytes(arr, depth=16))
    np.testing.assert_array_equal((wide >> 8).astype(np.uint8), narrow)


@needs_native
def test_hdr_decodef_matches_numpy_rgbe_math(rng):
    """Linear float output cross-validated against independent numpy RGBE
    math: m * 2^(e-136), exact zero when e == 0."""
    # Width >= 8: the new-RLE scanline form is only legal for widths in
    # [8, 32767] (the decoder correctly refuses it below that).
    rgbe = _safe_rgbe(rng, 5, 16)
    rgbe[:, :, 3] = rng.integers(100, 145, (5, 16))
    rgbe[0, 0, 3] = 0  # exponent 0 -> exact 0.0
    for new_rle in (False, True):
        f = native_codec.hdr_decodef(_hdr_bytes(rgbe, new_rle=new_rle))
        assert f is not None and f.dtype == np.float32
        m = rgbe[:, :, :3].astype(np.float64)
        e = rgbe[:, :, 3:4].astype(np.int64)
        expect = np.where(e == 0, 0.0, m * np.exp2(e - 136.0))
        np.testing.assert_allclose(f, expect, rtol=1e-6)
    assert f[0, 0, 0] == 0.0


@needs_native
def test_hdr_float_tone_map_consistency(rng):
    """The u8 tier is exactly the float tier through stb's default tone
    map (clamp(pow(v, 1/2.2)*255 + 0.5))."""
    rgbe = _safe_rgbe(rng, 4, 6)
    rgbe[:, :, 3] = rng.integers(120, 140, (4, 6))
    data = _hdr_bytes(rgbe)
    f = native_codec.hdr_decodef(data).astype(np.float64)
    u8 = native_codec.hdr_decode(data)
    z = np.power(np.maximum(f, 0.0), 1 / 2.2) * 255.0 + 0.5
    expect = np.clip(np.nan_to_num(z), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(u8, expect)


@needs_native
def test_decode_file_16_generic(rng):
    """The format-generic stbi_load_16 analog: PNG/PSD native, everything
    else through the u8 tier * 257."""
    a = rng.integers(0, 65536, (6, 5, 3))
    assert np.array_equal(
        image_utils.decode_file_16(_png_bytes(a, 16, 2)),
        a.astype(np.uint16))
    arr8 = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    assert np.array_equal(
        image_utils.decode_file_16(_psd_bytes(arr8, depth=16)),
        arr8.astype(np.uint16) * 257)
    # A format with no native-16 path (GIF): u8 decode * 257.
    pal = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]],
                   np.uint8)
    idx = rng.integers(0, 4, (4, 4)).astype(np.uint8)
    wide = image_utils.decode_file_16(_gif_bytes(idx, pal))
    assert wide.dtype == np.uint16
    np.testing.assert_array_equal(wide, pal[idx].astype(np.uint16) * 257)


@needs_native
def test_decode_file_float_generic(rng):
    """The format-generic stbi_loadf analog: HDR native linear floats,
    LDR formats through (v/255)^2.2 (stb ldr_to_hdr, gamma 2.2 scale 1)."""
    rgbe = _safe_rgbe(rng, 4, 4)
    rgbe[:, :, 3] = 130
    f = image_utils.decode_file_float(_hdr_bytes(rgbe))
    assert f.dtype == np.float32 and f.max() > 1.0  # radiance, not LDR
    arr8 = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    f = image_utils.decode_file_float(_png_bytes(arr8, 8, 2))
    np.testing.assert_allclose(
        f, (arr8.astype(np.float32) / 255.0) ** np.float32(2.2), rtol=1e-6)
