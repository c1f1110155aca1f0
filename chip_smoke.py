#!/usr/bin/env python3
"""End-to-end smoke test of the served filter path on one NVIDIA GPU.

Runs in ONE process (the REST server runs on a thread, built by the same
function `python -m gpu_image_processing.server.app` uses), so only one
process ever holds the card.  Phases, each printing its findings:

  1. card check     nvidia-smi name and power limit; the JAX devices.
  2. native codec   build native/build/libgip_codec.so; which codec served.
  3. correctness    seeded 3239x2146 RGB, 1024x1023 RGBA, 2048x1536 gray
                    images; gaussian r=3/15, box r=5/15, sobel at levels
                    1/2/4 through `gpu_filters` and `RUNTIME.run`, against
                    tests/oracle_numpy.py on the host.
  4. HTTP           /api/health, /api/process per filter, /api/process-all,
                    /api/process-batch (8 images), one profiled request.
  5. kernel vs XLA  each hand-written kernel against the plain XLA version
                    of the same numerics, interleaved, median of 200 runs
                    (host clock ending in block_until_ready) plus the
                    device time read from a profiler trace.
  6. card tests     pytest -m gpu on tests/test_gpu.py, in this process.

`--multi` (four cards) runs only the multi-device serving paths
(GIP_MESH_BATCH data parallel batches, GIP_MESH_SPATIAL row
sharding) and compares them bit for bit with single-card serving.

Usage: python chip_smoke.py [--multi]
Exits non-zero, printing no result, without a GPU.  The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = (2146, 3239, 3)          # H, W, C: the reference README image
SHAPES = {"3239x2146 RGB": FLAGSHIP,
          "1024x1023 RGBA": (1023, 1024, 4),
          "2048x1536 gray": (1536, 2048, 1)}
BLURS = (("gaussian", 3), ("gaussian", 15), ("box", 5), ("box", 15))
SIGMA = 2.0
RUNS = 200


class SmokeError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def _images(seed: int = 0) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, 256, shape, dtype=np.uint8)
            for name, shape in SHAPES.items()}


def _oracle(img, filt: str, radius: int, level: int):
    from gpu_image_processing.ops.weights import gaussian_kernel_f32
    from tests import oracle_numpy as oracle

    if filt == "gaussian":
        return oracle.gaussian_blur(img, gaussian_kernel_f32(radius, SIGMA),
                                    radius)
    if filt == "box":
        return oracle.box_blur(img, radius)
    return oracle.sobel(img, 2 if level == 2 else 1)


def _compare(got, want, filt: str, level: int, label: str) -> None:
    """Tolerances: blurs at L1/L2 maxdiff <= 1 on <= 1e-4 of pixels (FMA
    contraction at rounding boundaries), L4 maxdiff <= 1; Sobel on color
    maxdiff <= 6 on <= 0.1% (gray quantization ties), on gray <= 1 on
    <= 1e-4."""
    import numpy as np

    _check(got.shape == want.shape and got.dtype == np.uint8,
           f"{label}: shape {got.shape} {got.dtype} != {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    maxdiff, ndiff = int(diff.max()), int((diff > 0).sum())
    frac = ndiff / diff.size
    print(f"  {label}: maxdiff={maxdiff} differing={ndiff} ({frac:.2e})")
    if filt == "sobel" and want.shape[-1] > 1:
        ok = maxdiff <= 6 and frac <= 1e-3
    elif level == 4 and filt != "sobel":
        ok = maxdiff <= 1
    else:
        ok = maxdiff <= 1 and frac <= 1e-4
    _check(ok, f"{label}: outside tolerance (maxdiff {maxdiff}, "
               f"fraction {frac:.2e})")


def phase_card() -> object:
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    devs = jax.devices()
    d = devs[0]
    print(f"jax devices: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}")
    return d


def phase_codec() -> None:
    import numpy as np

    from gpu_image_processing.utils import image as image_utils
    from gpu_image_processing.utils import native_codec

    # A failed build fails the phase: serving would fall back to the
    # slower stdlib PNG tier without a word.
    print(f"native codec: {native_codec.build()}")
    img = np.random.default_rng(1).integers(0, 256, (64, 80, 3), np.uint8)
    back = image_utils.decode_base64_image(image_utils.encode_image_to_base64(img))
    _check(np.array_equal(back, img), "codec round trip changed pixels")
    _check(native_codec.available(), "native codec built but not loaded")
    tiers = {k: v for k, v in image_utils.decode_tier_counts().items() if v}
    print(f"codec tier: native={native_codec.available()} decode tiers "
          f"{tiers}")


def phase_correctness(images: dict) -> None:
    import gpu_filters
    from gpu_image_processing.runtime.dispatch import RUNTIME

    for name, img in images.items():
        for filt, radius in BLURS + (("sobel", 0),):
            wants = {}
            for level in (1, 2, 4):
                key = 2 if filt == "sobel" and level == 2 else 1
                if key not in wants:
                    wants[key] = _oracle(img, filt, radius, level)
                want = wants[key] if filt == "sobel" else wants[1]
                if filt == "gaussian":
                    api = gpu_filters.gaussian_blur(img, SIGMA, radius, level)
                    run = RUNTIME.run(filt, img, level, sigma=SIGMA,
                                      radius=radius)
                elif filt == "box":
                    api = gpu_filters.box_blur(img, radius, level)
                    run = RUNTIME.run(filt, img, level, radius=radius)
                else:
                    api = gpu_filters.sobel_edge_detection(img, level)
                    run = RUNTIME.run(filt, img, level)
                tag = f"{name} {filt} r={radius} L{level}"
                _compare(api["image"], want, filt, level, f"{tag} gpu_filters")
                _compare(run[0], want, filt, level, f"{tag} RUNTIME.run")
                print(f"    time_ms={api['time_ms']:.4f}")
    h, w, c = FLAGSHIP
    from gpu_image_processing.runtime import dispatch

    key = dispatch.executable_cache_key(
        "gaussian", 2, dispatch._bucket(h), dispatch._bucket(w), c, 3)
    print(f"flagship gaussian L2 memory_analysis: "
          f"{RUNTIME._cache[key]._compiled.memory_analysis()}")


def _post(url: str, payload: dict, timeout: float = 600.0) -> tuple[int, dict, float]:
    data = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = json.loads(resp.read())
            status = resp.status
    except urllib.error.HTTPError as exc:
        body, status = {"detail": exc.read().decode(errors="replace")}, exc.code
    return status, body, (time.perf_counter() - t0) * 1000.0


def phase_http(images: dict) -> None:
    import numpy as np

    from gpu_image_processing.server.app import build_server
    from gpu_image_processing.utils.image import (decode_base64_image,
                                                      encode_image_to_base64)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server, _ = build_server("127.0.0.1", port)
    server.start_background()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/api/health", timeout=60) as r:
            health = json.loads(r.read())
            _check(r.status == 200 and health.get("status") == "healthy",
                   f"/api/health: {health}")
        print(f"  /api/health 200 {health}")
        flag = images["3239x2146 RGB"]
        flag_b64 = encode_image_to_base64(flag)
        params = {"gaussian": {"sigma": SIGMA, "radius": 3},
                  "box": {"radius": 5}, "sobel": {}}
        for filt, extra in params.items():
            st, body, wall = _post(base + "/api/process",
                                   {"image": flag_b64, "filter": filt,
                                    "level": 2, **extra})
            _check(st == 200, f"/api/process {filt}: {st} {body}")
            got = decode_base64_image(body["processed_image"])
            _compare(got, _oracle(flag, filt, extra.get("radius", 0), 2),
                     filt, 2, f"/api/process {filt} L2")
            print(f"    time_ms={body['metrics']['time_ms']:.4f} "
                  f"wall_ms={wall:.1f}")
        st, body, wall = _post(base + "/api/process-all",
                               {"image": flag_b64, "filter": "gaussian",
                                "sigma": SIGMA, "radius": 3})
        _check(st == 200, f"/api/process-all: {st} {body}")
        want = _oracle(flag, "gaussian", 3, 1)
        for lv, res in sorted(body["results"].items()):
            _compare(decode_base64_image(res["processed_image"]), want,
                     "gaussian", int(lv[-1]), f"/api/process-all {lv}")
            print(f"    time_ms={res['metrics']['time_ms']:.4f}")
        print(f"    wall_ms={wall:.1f}")
        small = images["1024x1023 RGBA"][..., :3]
        batch = [np.roll(small, 7 * i, axis=1) for i in range(8)]
        st, body, wall = _post(base + "/api/process-batch",
                               {"images": [encode_image_to_base64(b)
                                           for b in batch],
                                "filter": "box", "level": 2, "radius": 5})
        _check(st == 200, f"/api/process-batch: {st} {body}")
        for i, enc in enumerate(body["processed_images"]):
            _compare(decode_base64_image(enc), _oracle(batch[i], "box", 5, 2),
                     "box", 2, f"/api/process-batch image {i}")
        print(f"    time_ms={body['metrics']['time_ms']:.4f} "
              f"wall_ms={wall:.1f}")
        st, body, wall = _post(base + "/api/process-all",
                               {"image": flag_b64, "filter": "sobel",
                                "enable_profiling": True})
        _check(st == 200, f"profiled /api/process-all: {st} {body}")
        for lv, res in sorted(body["results"].items()):
            m = res["metrics"]
            _compare(decode_base64_image(res["processed_image"]),
                     _oracle(flag, "sobel", 0, int(lv[-1])), "sobel",
                     int(lv[-1]), f"profiled /api/process-all sobel {lv}")
            src = m.get("kernel_duration_source")
            print(f"    {lv}: time_ms={m['time_ms']:.4f} kernel source={src} "
                  f"kernels={m.get('kernel_durations')} "
                  f"profiled_ms={m.get('ncu_profiled_time_ms')} "
                  f"peak note={m.get('ncu_data', {}).get('config', {}).get('Peak Table')}")
            _check(src == "xplane_trace",
                   f"profiled {lv}: kernel times not read from a GPU trace "
                   f"(source {src}, error {m.get('profiling_error')})")
        print(f"    wall_ms={wall:.1f}")
    finally:
        server.shutdown()


def phase_kernels(images: dict) -> None:
    import jax
    import jax.numpy as jnp

    from gpu_image_processing.ops import interleaved as il
    from gpu_image_processing.ops.pallas import api, blur, sobel
    from gpu_image_processing.ops.weights import gaussian_kernel_f32
    from gpu_image_processing.runtime import dispatch
    from gpu_image_processing.runtime.timing import (interleaved_host_ms,
                                                     trace_device_ms)

    for name in ("3239x2146 RGB", "1024x1023 RGBA"):
        # The served program: the image padded to its bucket, each arm
        # compiled and timed as the runtime compiles and times it.
        img = dispatch._pad_to_bucket(images[name])[0]
        h, w, c = img.shape
        rows = jax.device_put(img.reshape(h, w * c))
        for filt, radius in BLURS + (("sobel", 0),):
            args = [rows]
            if filt == "gaussian":
                args.append(jax.device_put(gaussian_kernel_f32(radius, SIGMA)))
                kern = lambda x, wt, r=radius: blur.gaussian_rows(x, wt, r, c)
                xla = lambda x, wt, r=radius: il.gaussian_rows(x, wt, r, c)
            elif filt == "box":
                kern = lambda x, r=radius: blur.box_rows(x, r, c)
                xla = lambda x, r=radius: il.box_rows(x, r, c, doubling=True)
            else:
                kern = lambda x: sobel.sobel_rows(x, c, quantize_gray=True)
                xla = lambda x: il.sobel_rows(x, 2, w, c)
            arms = {"kernel": dispatch.FilterExecutable(kern).compiled(*args),
                    "xla": dispatch.FilterExecutable(xla).compiled(*args)}
            host = interleaved_host_ms(arms, args, RUNS)
            dev = {k: trace_device_ms(fn, args, 10) for k, fn in arms.items()}
            served = "kernel" if api.kernel_serves(filt, radius, h * w) else "xla"
            print(f"  KERNEL {name} (served {w}x{h}) {filt} r={radius} L2: "
                  f"kernel {host['kernel']:.4f} ms (device {dev['kernel']:.4f}) "
                  f"| xla {host['xla']:.4f} ms (device {dev['xla']:.4f}) "
                  f"| served: {served}")
        sob = jax.jit(lambda x: il.sobel_rows(x, 2, w, c))
        txt = sob.lower(rows).compile().as_text()
        entry = txt[txt.index("ENTRY"):]
        fusions = sum(" fusion(" in ln for ln in entry.splitlines())
        copy = jax.jit(lambda x: x ^ jnp.uint8(1))
        t = interleaved_host_ms({"copy": copy}, [rows], RUNS)["copy"]
        print(f"  XLA sobel {name}: {fusions} fusions in its entry "
              f"computation; device copy of the image {t:.4f} ms "
              f"(device {trace_device_ms(copy, [rows], 10):.4f})")


def phase_gpu_tests() -> None:
    import jax
    import pytest

    # The tests' conftest defaults JAX_PLATFORMS to cpu; this process
    # already runs on the card, and the card tests must see it.
    os.environ["JAX_PLATFORMS"] = jax.devices()[0].client.platform

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    _check(rc == 0, f"pytest -m gpu failed (exit {rc})")


def phase_multi(images: dict) -> None:
    import numpy as np

    import jax
    from gpu_image_processing.ops.pallas import api
    from gpu_image_processing.runtime import dispatch
    from gpu_image_processing.runtime.dispatch import RUNTIME

    n = len(jax.devices())
    _check(n >= 4, f"--multi needs 4 devices, found {n}")
    img = images["3239x2146 RGB"]
    small = images["1024x1023 RGBA"]
    batch = np.stack([np.roll(small, 5 * i, axis=0) for i in range(8)])
    # Radius 15 puts the whole image on the kernel's side of the routing
    # and each device's share on the XLA side, so shards and single-card
    # serving run different programs that must still agree bit for bit.
    cases = [(f, dict(sigma=SIGMA, radius=r)) for f, r in BLURS
             if f == "gaussian"]
    cases += [(f, dict(radius=r)) for f, r in BLURS if f == "box"]
    cases.append(("sobel", {}))
    pixels = {"GIP_MESH_SPATIAL": (
        dispatch._bucket(img.shape[0]) * dispatch._bucket(img.shape[1]), n),
        "GIP_MESH_BATCH": (len(batch) * dispatch._bucket(small.shape[0])
                           * dispatch._bucket(small.shape[1]), n)}
    for env, label in (("GIP_MESH_SPATIAL", "row-sharded"),
                       ("GIP_MESH_BATCH", "dp batch")):
        for filt, kw in cases:
            radius = kw.get("radius", 0)
            total, shards = pixels[env]
            route = "/".join(
                "kernel" if api.kernel_serves(filt, radius, p) else "xla"
                for p in (total, total // shards))
            for level in (1, 2, 4):
                os.environ.pop(env, None)
                if env == "GIP_MESH_BATCH":
                    want = RUNTIME.run_batch(filt, batch, level, **kw)[0]
                    os.environ[env] = "1"
                    got, m = RUNTIME.run_batch(filt, batch, level, **kw)
                else:
                    want = RUNTIME.run(filt, img, level, **kw)[0]
                    os.environ[env] = "1"
                    got, m = RUNTIME.run(filt, img, level, **kw)
                os.environ.pop(env, None)
                same = np.array_equal(got, want)
                print(f"  {label} {filt} r={radius} L{level}: bit-equal={same} "
                      f"time_ms={m.time_ms:.4f}"
                      + (f" route one card/shard={route}" if level > 1 else ""))
                _check(same, f"{label} {filt} r={radius} L{level} differs "
                             "from single-card serving")
    used = sorted({k[0] for k in RUNTIME._cache})
    _check("spatial" in used, "row-sharded path never ran")
    _check(any(k[0] == "batch" and k[-1] >= 4 for k in RUNTIME._cache),
           "dp batch path never ran")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card serving paths")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(REPO, "gpu_image_processing")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1

    phases = [("card check", lambda: phase_card())]
    images = _images()
    if args.multi:
        phases.append(("multi-device serving", lambda: phase_multi(images)))
    else:
        phases += [("native codec", phase_codec),
                   ("correctness", lambda: phase_correctness(images)),
                   ("HTTP", lambda: phase_http(images)),
                   ("kernel vs XLA", lambda: phase_kernels(images)),
                   ("card-only tests", phase_gpu_tests)]
    for name, run in phases:
        t0 = time.time()
        print(f"== phase: {name}", flush=True)
        try:
            run()
        except Exception as exc:
            print(f"== phase {name} FAILED: {type(exc).__name__}: {exc}",
                  flush=True)
            import traceback

            traceback.print_exc()
            return 1
        print(f"== phase {name} ok ({time.time() - t0:.1f} s)", flush=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
