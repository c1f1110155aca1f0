"""Command-line tools: filter_image.py end-to-end over real processes."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "scripts", "filter_image.py")

ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def _run(*args, timeout=240):
    return subprocess.run(
        [sys.executable, CLI, *args], env=ENV, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.slow
def test_filter_image_roundtrip(rng):
    workdir = tempfile.mkdtemp(prefix="gip_cli_")
    src = os.path.join(workdir, "in.png")
    dst = os.path.join(workdir, "out.ppm")
    img = rng.integers(0, 256, (48, 60, 3), dtype=np.uint8)
    Image.fromarray(img).save(src)

    r = _run(src, dst, "--filter", "gaussian", "--level", "2",
             "--sigma", "2.0", "--radius", "3")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Time:" in r.stdout and "FPS" in r.stdout
    assert os.path.exists(dst)
    with open(dst, "rb") as f:
        assert f.read(2) == b"P6"


@pytest.mark.slow
def test_filter_image_validates_ranges(rng):
    workdir = tempfile.mkdtemp(prefix="gip_cli_")
    src = os.path.join(workdir, "in.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(src)
    r = _run(src, "--sigma", "99")
    assert r.returncode == 1
    assert "sigma must be in" in r.stdout
    r = _run(src, "--radius", "40")
    assert r.returncode == 1
    assert "radius must be in" in r.stdout


@pytest.mark.slow
def test_filter_image_hdr_output(rng):
    # .hdr output rides the native Radiance writer (stb_image_write's
    # fifth format); PIL cannot write it at all.
    from gpu_image_processing.utils import native_codec

    if not native_codec.available():
        pytest.skip("native codec not built")
    workdir = tempfile.mkdtemp(prefix="gip_cli_")
    src = os.path.join(workdir, "in.png")
    dst = os.path.join(workdir, "out.hdr")
    img = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(src)

    r = _run(src, dst, "--filter", "sobel", "--level", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    with open(dst, "rb") as f:
        head = f.read(16)
    assert head.startswith(b"#?RADIANCE")
    # And the CLI can read its own HDR back in (native-first sniff).
    r2 = _run(dst, os.path.join(workdir, "out2.png"), "--filter", "box")
    assert r2.returncode == 0, r2.stdout + r2.stderr


def test_save_image_jpg_without_pil(rng, monkeypatch, tmp_path):
    """PIL-less .jpg output rides the native baseline encoder (the
    stb_image_write parity set includes jpg); with PIL present the
    libjpeg-turbo path is preferred and this branch must stay dormant."""
    from gpu_image_processing.utils import native_codec

    if not native_codec.available():
        pytest.skip("native codec not built")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "filter_image_for_test",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "filter_image.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    dst = str(tmp_path / "out.jpg")
    # Block PIL for the save call only: None in sys.modules makes
    # `from PIL import Image` raise ImportError.
    monkeypatch.setitem(sys.modules, "PIL", None)
    mod.save_image(dst, img)
    monkeypatch.undo()

    with open(dst, "rb") as f:
        raw = f.read()
    assert raw[:2] == b"\xff\xd8" and raw[-2:] == b"\xff\xd9"
    back = native_codec.jpeg_decode(raw)
    assert back is not None and back.shape == img.shape
    # Lossy but sane: baseline q90 on random noise stays within u8 range
    # errors far below a corrupted-stream blowup.
    assert float(np.abs(back.astype(np.int16) - img.astype(np.int16)).mean()) < 24.0
