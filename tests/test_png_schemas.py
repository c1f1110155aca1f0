"""The stdlib PNG tier (utils/png.py) and the dataclass request schemas
(server/schemas.py): the served path needs neither Pillow nor pydantic."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gpu_image_processing.server.schemas import (
    AllLevelsResponse,
    FilterRequest,
    FilterResponse,
    SchemaError,
)
from gpu_image_processing.utils import image as image_utils
from gpu_image_processing.utils import native_codec
from gpu_image_processing.utils import png

from .conftest import make_image


def _png_with_filters(img: np.ndarray, kinds) -> bytes:
    """Hand-built PNG whose row y uses filter kinds[y % len(kinds)]."""
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = bytearray()
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        line = img[y].reshape(-1)
        kind = kinds[y % len(kinds)]
        if kind == 0:
            filt = line
        elif kind == 1:
            left = np.concatenate([np.zeros(c, np.uint8), line[:-c]])
            filt = line - left
        else:
            filt = line - prior
        raw += bytes([kind]) + filt.astype(np.uint8).tobytes()
        prior = line

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_round_trip(rng, c):
    img = make_image(rng, 23, 37, c)
    data = png.encode(img)
    np.testing.assert_array_equal(png.decode(data), img)
    # Pillow reads the writer's files too.
    via_pil = np.array(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(via_pil.reshape(img.shape), img)


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (1, 2, 0)])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_reader_undoes_none_sub_up(rng, kinds, c):
    img = make_image(rng, 9, 13, c)
    np.testing.assert_array_equal(png.decode(_png_with_filters(img, kinds)),
                                  img)


def test_png_reader_rejects_average_and_paeth(rng):
    img = make_image(rng, 4, 5, 3)
    # Re-encode with filter byte 4 (Paeth) on every row.
    h, w, c = img.shape
    rows = b"".join(b"\x04" + img[y].tobytes() for y in range(h))
    good = png.encode(img)
    start = good.index(b"IDAT") - 4
    end = good.index(b"IEND") - 4
    comp = zlib.compress(rows)
    body = (struct.pack(">I", len(comp)) + b"IDAT" + comp
            + struct.pack(">I", zlib.crc32(b"IDAT" + comp) & 0xFFFFFFFF))
    data = good[:start] + body + good[end:]
    with pytest.raises(png.PngError, match="row filter 4"):
        png.decode(data)


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d[:8] + b"junk", "missing IHDR"),
    (lambda d: b"GIF89a" + d[6:], "not a PNG"),
    (lambda d: d[:24] + b"\x10" + d[25:], "unsupported PNG layout"),
    (lambda d: d[:-30], "truncated|corrupt|shorter|missing"),
])
def test_png_reader_errors(rng, mutate, match):
    data = png.encode(make_image(rng, 6, 7, 3))
    with pytest.raises(png.PngError, match=match):
        png.decode(mutate(data))


def test_png_writer_rejects_two_channels(rng):
    with pytest.raises(png.PngError):
        png.encode(make_image(rng, 4, 4, 2))


def test_served_codec_uses_stdlib_tier_without_pillow_or_native(
        rng, monkeypatch):
    """With neither the native library nor Pillow, PNG uploads decode and
    results encode through utils/png.py; an unsupported PNG is a clean
    codec error (the server's 400)."""
    monkeypatch.setattr(image_utils, "PIL_AVAILABLE", False)
    monkeypatch.setattr(native_codec, "load", lambda: None)
    img = make_image(rng, 11, 17, 3)
    before = image_utils.decode_tier_counts()["stdlib_png"]
    url = image_utils.encode_image_to_base64(img)
    np.testing.assert_array_equal(image_utils.decode_base64_image(url), img)
    assert image_utils.decode_tier_counts()["stdlib_png"] == before + 1
    # Pillow's writer picks adaptive row filters (Average/Paeth among them).
    buf = io.BytesIO()
    Image.fromarray(make_image(rng, 40, 40, 3)).save(buf, format="PNG")
    import base64

    with pytest.raises(image_utils.ImageCodecError, match="row filter"):
        image_utils.decode_base64_image(base64.b64encode(buf.getvalue()).decode())


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------


def test_filter_request_defaults():
    req = FilterRequest.from_json({"image": "abc", "filter": "box"})
    assert (req.level, req.sigma, req.radius, req.enable_profiling) == (
        1, 2.0, 3, False)


def test_filter_request_coerces_like_pydantic_lax_mode():
    req = FilterRequest.from_json({
        "image": "abc", "filter": "gaussian", "level": "2", "sigma": "1.5",
        "radius": 4.0, "enable_profiling": "true", "extra": [1, 2]})
    assert (req.level, req.sigma, req.radius, req.enable_profiling) == (
        2, 1.5, 4, True)
    assert FilterRequest.from_json(
        {"image": "a", "filter": "box", "sigma": None}).sigma is None


@pytest.mark.parametrize("body,match", [
    ([], "JSON object"),
    ({"filter": "box"}, "missing field"),
    ({"image": "a"}, "missing field"),
    ({"image": 5, "filter": "box"}, "image"),
    ({"image": "a", "filter": "box", "level": 2.5}, "level"),
    ({"image": "a", "filter": "box", "level": True}, "level"),
    ({"image": "a", "filter": "box", "radius": "wide"}, "radius"),
    ({"image": "a", "filter": "box", "sigma": [1]}, "sigma"),
    ({"image": "a", "filter": "box", "enable_profiling": "maybe"},
     "enable_profiling"),
])
def test_filter_request_rejects(body, match):
    with pytest.raises(SchemaError, match=match):
        FilterRequest.from_json(body)


def test_responses_dump_to_plain_dicts():
    r = FilterResponse(processed_image="x", metrics={"time_ms": 1.0},
                       info={"filter": "box"})
    assert r.model_dump() == {"processed_image": "x",
                              "metrics": {"time_ms": 1.0},
                              "info": {"filter": "box"}}
    all_levels = AllLevelsResponse(original_image="o",
                                   results={"level_1": r}, image_info={})
    dumped = all_levels.model_dump()
    assert dumped["results"]["level_1"]["processed_image"] == "x"
    assert dumped["profiling_available"] is False
