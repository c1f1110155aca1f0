"""The platform rule, the compile-cache location and the device mesh.

gpu serves compiled kernels; cpu serves only when JAX_PLATFORMS names it
alone, with Pallas kernels in interpret mode; anything else raises.
"""

import os
import subprocess
import sys

import jax
import pytest

from gpu_image_processing.parallel.mesh import make_mesh
from gpu_image_processing.runtime import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("plat,platforms,ok", [
    ("gpu", "", True),
    ("gpu", "cuda", True),
    ("gpu", "cuda,cpu", True),
    ("cpu", "cpu", True),
    ("cpu", " CPU ", True),
    ("cpu", "", False),
    ("cpu", "cuda,cpu", False),
    ("rocm", "rocm", False),
    ("metal", "cpu", False),
    ("rocm", "", False),
])
def test_check_platform(plat, platforms, ok):
    if ok:
        assert device.check_platform(plat, platforms) == plat
    else:
        with pytest.raises(RuntimeError, match=f"platform is {plat!r}"):
            device.check_platform(plat, platforms)


@pytest.mark.parametrize("plat,interpret", [("gpu", False), ("cpu", True)])
def test_interpret_mode_exactly_on_cpu(monkeypatch, plat, interpret):
    monkeypatch.setattr(device, "platform", lambda: plat)
    assert device.use_interpret() is interpret


def test_other_platform_raises_at_first_use(monkeypatch):
    class FakeDevice:
        platform = "rocm"

    device.default_device.cache_clear()
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    try:
        with pytest.raises(RuntimeError, match="no GPU found"):
            device.default_device()
    finally:
        monkeypatch.undo()
        device.default_device.cache_clear()
    assert device.default_device().platform == "cpu"


def test_cpu_requested_reads_jax_platforms():
    assert device.cpu_requested("cpu")
    assert not device.cpu_requested("cuda")
    assert not device.cpu_requested("")
    assert device.cpu_requested()          # the test session runs on cpu


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, gpu_image_processing.runtime.device as d; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(d.setup_compilation_cache())"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honors_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_child(want) == [want, want]


def test_compile_cache_default_is_fixed_in_checkout():
    got = _cache_dir_in_child(None)
    assert got == [device.DEFAULT_CACHE_DIR] * 2
    assert os.path.dirname(device.DEFAULT_CACHE_DIR) == REPO


def test_make_mesh_raises_on_too_few_devices():
    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"only {n} present"):
        make_mesh(n + 1)
    with pytest.raises(ValueError, match="only 2 present"):
        make_mesh(4, devices=jax.devices()[:2])


@pytest.mark.parametrize("n,shape", [(8, (2, 4)), (4, (2, 2)), (2, (1, 2)),
                                     (1, (1, 1))])
def test_make_mesh_default_split(n, shape):
    mesh = make_mesh(n)
    assert mesh.devices.shape == shape
    assert mesh.axis_names == ("dp", "sp")


def test_make_mesh_rejects_bad_split():
    with pytest.raises(ValueError, match="dp\\*sp"):
        make_mesh(8, dp=3, sp=2)


@pytest.mark.parametrize("env,problem", [
    ({"GIP_MAX_RSS_MB": "100", "PATH": "/bin"}, None),
    ({"GIP_OLD_MAX_RSS_MB": "100"}, "GIP_OLD_MAX_RSS_MB (renamed GIP_MAX_RSS_MB)"),
    ({"GIP_OLD_MESH_SPATIAL_MIN_ROWS_PER_SHARD": "8"},
     "renamed GIP_MESH_SPATIAL_MIN_ROWS_PER_SHARD"),
    ({"GIP_OLD_RETRY_S": "5"}, "GIP_OLD_RETRY_S (no longer read)"),
])
def test_check_env_names_renamed_and_unknown_settings(env, problem):
    from gpu_image_processing.core import config

    if problem is None:
        config.check_env(env)
    else:
        with pytest.raises(ValueError, match=problem.replace("(", r"\(")
                           .replace(")", r"\)")):
            config.check_env(env)


def test_every_setting_read_is_known():
    # Every GIP_* name in the program's sources is one check_env accepts.
    import re

    from gpu_image_processing.core import config

    names = set()
    for top in ("gpu_image_processing", "scripts"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(root, f)) as fh:
                        names |= set(re.findall(r"GIP_[A-Z0-9_]*[A-Z0-9]",
                                                fh.read()))
    assert names - config.ENV_VARS == set()


def test_server_refuses_unknown_setting(monkeypatch):
    from gpu_image_processing.server.app import build_server

    monkeypatch.setenv("GIP_OLD_MESH_BATCH", "1")
    with pytest.raises(ValueError, match="renamed GIP_MESH_BATCH"):
        build_server("127.0.0.1", 0)
