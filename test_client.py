#!/usr/bin/env python3
"""Live-API test client: sequential checks against a running server.

The analog of the reference's backend/test_client.py:202-258 -- six
end-to-end tests against http://localhost:8000, saving returned images and
printing a PASS/FAIL summary with a matching exit code.

Usage: python test_client.py [--base http://localhost:8000] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys
import tempfile
import urllib.request

import numpy as np
from PIL import Image

RESULTS: list[tuple[str, bool, str]] = []


def record(name: str, ok: bool, detail: str = "") -> None:
    RESULTS.append((name, ok, detail))
    print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f" -- {detail}" if detail else ""))


def http_json(url: str, payload: dict | None = None, timeout: float = 600.0):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url,
        data=data,
        headers={"Content-Type": "application/json"} if data else {},
        method="POST" if data else "GET",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def make_test_image() -> str:
    """A synthetic photo-like test card (gradient + shapes), as a data URL."""
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack(
        [
            (xx * 255 / w).astype(np.uint8),
            (yy * 255 / h).astype(np.uint8),
            ((xx + yy) * 255 / (w + h)).astype(np.uint8),
        ],
        axis=2,
    )
    img[60:180, 80:240] = [255, 255, 255]
    img[100:140, 120:200] = [0, 0, 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def save_png(data_url: str, path: str) -> None:
    raw = base64.b64decode(data_url.split(",", 1)[1])
    with open(path, "wb") as f:
        f.write(raw)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", default="http://localhost:8000")
    parser.add_argument(
        "--outdir",
        default=os.path.join(tempfile.gettempdir(), "gip_client_test"))
    args = parser.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    base = args.base.rstrip("/")
    image_b64 = make_test_image()

    # 1. root
    try:
        status, body = http_json(f"{base}/")
        record("root endpoint", status == 200 and body.get("status") == "running")
    except Exception as exc:
        record("root endpoint", False, str(exc))
        print("Server unreachable; aborting.")
        return 1

    # 2. health
    try:
        status, body = http_json(f"{base}/api/health")
        record("health check", status == 200 and body.get("status") == "healthy",
               f"accelerator={body.get('gpu_available')}")
    except Exception as exc:
        record("health check", False, str(exc))

    # 3. filter catalog
    try:
        status, body = http_json(f"{base}/api/filters")
        ok = status == 200 and set(body.get("filters", {})) == {"gaussian", "box", "sobel"}
        record("filter catalog", ok)
    except Exception as exc:
        record("filter catalog", False, str(exc))

    # 4. gaussian level 2
    t_l2 = None
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "gaussian", "level": 2,
            "sigma": 2.0, "radius": 3,
        })
        ok = status == 200 and body["metrics"]["time_ms"] > 0
        t_l2 = body["metrics"]["time_ms"] if ok else None
        if ok:
            save_png(body["processed_image"], f"{args.outdir}/gaussian_l2.png")
        record("gaussian blur level 2", ok,
               f"{body['metrics']['time_ms']:.3f} ms" if ok else "")
    except Exception as exc:
        record("gaussian blur level 2", False, str(exc))

    # 5. box blur level 2
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "box", "level": 2, "radius": 5,
        })
        ok = status == 200 and body["info"]["level"] == "shared_memory"
        if ok:
            save_png(body["processed_image"], f"{args.outdir}/box_l2.png")
        record("box blur level 2", ok)
    except Exception as exc:
        record("box blur level 2", False, str(exc))

    # 6. gaussian level-1 vs level-2 comparison via process-all
    try:
        status, body = http_json(f"{base}/api/process-all", {
            "image": image_b64, "filter": "gaussian", "sigma": 2.0, "radius": 3,
        })
        r = body["results"]
        ok = status == 200 and "level_1" in r and "level_2" in r
        if ok:
            t1 = r["level_1"]["metrics"]["time_ms"]
            t2 = r["level_2"]["metrics"]["time_ms"]
            save_png(r["level_1"]["processed_image"], f"{args.outdir}/gaussian_l1.png")
            record("process-all L1 vs L2", True,
                   f"L1={t1:.3f} ms, L2={t2:.3f} ms, speedup={t1 / t2:.2f}x")
        else:
            record("process-all L1 vs L2", False, f"status={status}")
    except Exception as exc:
        record("process-all L1 vs L2", False, str(exc))

    # 7. batch endpoint (an extension)
    try:
        status, body = http_json(f"{base}/api/process-batch", {
            "images": [image_b64, image_b64], "filter": "box", "level": 2,
            "radius": 3,
        })
        ok = status == 200 and body["metrics"]["batch_size"] == 2
        record("batch endpoint", ok,
               f"{body['metrics']['images_per_second']:.1f} img/s" if ok else "")
    except Exception as exc:
        record("batch endpoint", False, str(exc))

    # 8. ADVANCED level (the enum the reference declares but never
    # implements; here it serves the relaxed-numerics fast tier)
    try:
        status, body = http_json(f"{base}/api/process", {
            "image": image_b64, "filter": "sobel", "level": 4,
        })
        ok = status == 200 and body["info"]["level"] == "advanced"
        if ok:
            save_png(body["processed_image"], f"{args.outdir}/sobel_l4.png")
        record("sobel ADVANCED level", ok)
    except Exception as exc:
        record("sobel ADVANCED level", False, str(exc))

    # 9. format breadth: Radiance HDR has NO PIL decoder -- serving it at
    # all proves the native codec tier end-to-end (utils/image.py).
    try:
        rgbe = np.zeros((24, 32, 4), np.uint8)
        rgbe[..., 0] = 64
        rgbe[..., 1] = np.linspace(0, 255, 32, dtype=np.uint8)
        rgbe[..., 3] = 128
        hdr = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 24 +X 32\n"
               + rgbe.tobytes())
        status, body = http_json(f"{base}/api/process", {
            "image": base64.b64encode(hdr).decode(),
            "filter": "gaussian", "level": 2, "sigma": 2.0, "radius": 3,
        })
        ok = status == 200 and body["metrics"]["time_ms"] > 0
        tiers = {}
        if ok:
            _, stats = http_json(f"{base}/api/stats")
            tiers = stats.get("decode_tiers", {})
            ok = tiers.get("native_hdr", 0) >= 1
        record("HDR upload via native tier", ok,
               f"native_hdr={tiers.get('native_hdr')}" if tiers else "")
    except Exception as exc:
        record("HDR upload via native tier", False, str(exc))

    # 10. stats endpoint (observability extension)
    try:
        status, body = http_json(f"{base}/api/stats")
        record("stats endpoint", status == 200 and body["requests_total"] > 0,
               f"{body.get('compiled_executables', 0)} executables cached")
    except Exception as exc:
        record("stats endpoint", False, str(exc))

    passed = sum(1 for _, ok, _ in RESULTS if ok)
    print(f"\n{passed}/{len(RESULTS)} tests passed; images in {args.outdir}")
    return 0 if passed == len(RESULTS) else 1


if __name__ == "__main__":
    sys.exit(main())
