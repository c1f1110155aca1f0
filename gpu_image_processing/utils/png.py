"""PNG writer and reader on numpy and the standard library's zlib.

The tier under the native codec (utils/native_codec.py) when that library
is not built, so the served path never needs Pillow.  The writer emits
8-bit gray, RGB or RGBA with filter type None on every row.  The reader
takes non-interlaced 8-bit gray, gray+alpha, RGB and RGBA whose rows use
filter types None, Sub or Up (the ones a row can undo with vector
operations); anything else raises PngError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit layouts the reader takes.
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


class PngError(ValueError):
    """A PNG this reader does not take (or a broken one)."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, C) uint8, C in {1, 3, 4} -> PNG bytes."""
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    height, width, channels = arr.shape
    if channels not in _COLOR_TYPE:
        raise PngError(f"cannot write {channels}-channel PNG")
    rows = np.zeros((height, 1 + width * channels), np.uint8)  # filter 0
    rows[:, 1:] = arr.reshape(height, width * channels)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPE[channels],
                       0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with the file's own channel count."""
    if data[:8] != _SIGNATURE:
        raise PngError("not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PngError("truncated chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise PngError("missing IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise PngError(f"unsupported PNG layout (bit depth {depth}, colour "
                       f"type {color}, interlace {interlace})")
    channels = _CHANNELS[color]
    stride = width * channels
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise PngError(f"corrupt image data: {exc}") from None
    if len(raw) < height * (stride + 1):
        raise PngError("image data shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:   # Sub: running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(width, channels), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:   # Up
            cur = line + prior
        else:
            raise PngError(f"unsupported PNG row filter {int(kind)}")
        out[y] = cur
        prior = out[y]
    return out.reshape(height, width, channels)
