"""Process orchestration (scripts/serve.py): start -> status -> stop cycle
over real processes, on the CPU platform (the analog of the reference's
start_servers.sh/stop_servers.sh lifecycle, SURVEY 3.5)."""

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = os.path.join(REPO, "scripts", "serve.py")


@pytest.mark.slow
def test_start_status_stop_cycle():
    run_dir = tempfile.mkdtemp(prefix="gip_orch_")
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "GIP_RUN_DIR": run_dir,
        # Own port: must not collide with a live server on the default
        # 8000 (config honors GIP_BACKEND_PORT).
        "GIP_BACKEND_PORT": "8481",
    }
    try:
        start = subprocess.run(
            [sys.executable, SERVE, "start", "--no-frontend"],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert start.returncode == 0, start.stdout + start.stderr
        assert "healthy" in start.stdout

        with urllib.request.urlopen(
            "http://127.0.0.1:8481/api/health", timeout=10
        ) as resp:
            assert json.loads(resp.read())["status"] == "healthy"

        status = subprocess.run(
            [sys.executable, SERVE, "status"],
            env=env, capture_output=True, text=True, timeout=60,
        )
        assert "port_8481=up" in status.stdout
    finally:
        stop = subprocess.run(
            [sys.executable, SERVE, "stop"],
            env=env, capture_output=True, text=True, timeout=60,
        )
    assert "Stopped backend" in stop.stdout or "not running" in stop.stdout
    deadline = time.time() + 15
    import socket

    while time.time() < deadline:
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", 8481)) != 0:
                break
        time.sleep(1)
    else:
        pytest.fail("backend port still open after stop")
