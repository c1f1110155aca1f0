"""Worker-recycle machinery: opt-in RSS watchdog (server/app.py) +
supervisor restart loop (scripts/serve.py).

A deployment that sees its worker's memory grow can recycle it at an RSS
high-water mark -- the gunicorn max-RSS pattern.  These tests run the real
processes on CPU with a 1 MB threshold (any process exceeds it instantly)
to drive the trigger deterministically.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest

from gpu_image_processing.core import config
from gpu_image_processing.server.app import (
    _rss_mb,
    watchdog_threshold_mb,
)
from gpu_image_processing.server.http import InFlightGauge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = os.path.join(REPO, "scripts", "serve.py")


def test_rss_mb_reports_resident_set():
    rss = _rss_mb()
    assert 10.0 < rss < 1_000_000.0


def test_threshold_env_override(monkeypatch):
    monkeypatch.setenv("GIP_MAX_RSS_MB", "512")
    assert watchdog_threshold_mb() == 512
    monkeypatch.setenv("GIP_MAX_RSS_MB", "0")
    assert watchdog_threshold_mb() == 0


def test_threshold_default_off(monkeypatch):
    """The watchdog defaults OFF; a malformed env falls through to that
    default."""
    monkeypatch.delenv("GIP_MAX_RSS_MB", raising=False)
    assert watchdog_threshold_mb() == 0
    monkeypatch.setenv("GIP_MAX_RSS_MB", "not-a-number")
    assert watchdog_threshold_mb() == 0


def test_in_flight_gauge_counts_nested_contexts():
    g = InFlightGauge()
    assert g.value == 0
    with g:
        with g:
            assert g.value == 2
        assert g.value == 1
    assert g.value == 0


def test_appserver_adopts_supervisor_listener():
    """AppServer(listen_fd=...) serves on an externally bound socket -- the
    mechanism that keeps client connections queued (not refused) while a
    recycled worker boots."""
    import json
    import socket
    import urllib.request

    from gpu_image_processing.server.http import AppServer, Router

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    port = lsock.getsockname()[1]

    app = Router()

    @app.get("/ping")
    def ping(_req):
        return 200, {"pong": True}

    # dup mirrors what fd inheritance gives a child process: the adopted
    # socket object owns its own descriptor, separate from lsock's.
    server = AppServer(app, "127.0.0.1", port, listen_fd=os.dup(lsock.fileno()))
    server.start_background()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/ping", timeout=10
        ) as resp:
            assert json.loads(resp.read()) == {"pong": True}
    finally:
        server.shutdown()
        lsock.close()


@pytest.mark.slow
def test_watchdog_exits_with_recycle_code():
    """A backend whose RSS exceeds the high-water mark drains and exits
    with config.EXIT_RECYCLE (the supervisor's restart signal)."""
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "GIP_MAX_RSS_MB": "1",  # any live process exceeds this
    }
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_image_processing.server.app",
         "--host", "127.0.0.1", "--port", "8491"],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == config.EXIT_RECYCLE, out
    assert "RSS watchdog armed" in out


@pytest.mark.slow
def test_supervisor_restarts_on_recycle_and_stops_on_sigterm():
    """serve.py supervise restarts the backend on EXIT_RECYCLE (new pid in
    the pid file), sequentially, and exits 0 on SIGTERM."""
    run_dir = tempfile.mkdtemp(prefix="gip_recycle_")
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "GIP_RUN_DIR": run_dir,
        "GIP_BACKEND_PORT": "8492",
        "GIP_MAX_RSS_MB": "1",
        "GIP_RECYCLE_MIN_UPTIME_S": "0",  # disarm the crash-loop guard
    }
    pid_path = os.path.join(run_dir, "gip_backend.pid")
    sup = subprocess.Popen(
        [sys.executable, SERVE, "supervise"],
        env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        seen = set()
        deadline = time.time() + 180
        while len(seen) < 2 and time.time() < deadline:
            try:
                with open(pid_path) as f:
                    seen.add(int(f.read().strip()))
            except (OSError, ValueError):
                pass
            assert sup.poll() is None, sup.communicate()[0]
            time.sleep(1)
        assert len(seen) >= 2, f"no recycle observed; pids: {seen}"
    finally:
        sup.send_signal(signal.SIGTERM)
        try:
            out, _ = sup.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            sup.kill()
            raise
    assert sup.returncode == 0, out
    assert "restarting" in out


def test_warm_shape_handoff_roundtrip(monkeypatch, tmp_path):
    """The exiting generation's served shapes reach the next generation's
    precompile list (supervised boots only)."""
    from gpu_image_processing.server import app as app_mod

    monkeypatch.setenv("GIP_RUN_DIR", str(tmp_path))
    monkeypatch.setattr(app_mod, "_SERVED_SHAPES", set())
    app_mod._note_served_shape(800, 600)
    app_mod._note_served_shape(1024, 1023)
    app_mod._note_served_shape(800, 600)  # dedup
    app_mod._dump_served_shapes()

    got = app_mod._load_warm_shapes()
    assert sorted(got) == [(800, 600), (1024, 1023)]

    # supervised boot merges them; unsupervised boot does not
    sup = app_mod._startup_precompile_shapes("320x240", supervised=True)
    assert (320, 240) in sup and (800, 600) in sup and (1024, 1023) in sup
    unsup = app_mod._startup_precompile_shapes("320x240", supervised=False)
    assert unsup == [(320, 240)]


def test_warm_shapes_stale_file_ignored(monkeypatch, tmp_path):
    import json as js
    import os as oss

    from gpu_image_processing.server import app as app_mod

    monkeypatch.setenv("GIP_RUN_DIR", str(tmp_path))
    path = app_mod._warm_shapes_path()
    with open(path, "w") as f:
        js.dump([[640, 480]], f)
    old = time.time() - 7200
    oss.utime(path, (old, old))
    assert app_mod._load_warm_shapes() == []
    # corrupt content is ignored too
    with open(path, "w") as f:
        f.write("not json")
    assert app_mod._load_warm_shapes() == []


def test_served_shape_cap(monkeypatch):
    from gpu_image_processing.server import app as app_mod

    monkeypatch.setattr(app_mod, "_SERVED_SHAPES", set())
    for i in range(100):
        app_mod._note_served_shape(100 + i, 100)
    assert len(app_mod._SERVED_SHAPES) == app_mod._SERVED_SHAPES_CAP


def test_draining_responses_advertise_connection_close():
    """While draining, every response carries Connection: close and the
    server closes the keep-alive afterwards -- clients reconnect into the
    supervisor's backlog instead of dying with the worker."""
    import http.client
    import json as js

    from gpu_image_processing.server.http import AppServer, Router

    app = Router()

    @app.get("/ping")
    def ping(_req):
        return 200, {"pong": True}

    server = AppServer(app, "127.0.0.1", 0)
    # port 0: pick a free port via a pre-bound socket
    import socket as so

    lsock = so.socket(so.AF_INET, so.SOCK_STREAM)
    lsock.setsockopt(so.SOL_SOCKET, so.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    port = lsock.getsockname()[1]
    server = AppServer(app, "127.0.0.1", port, listen_fd=os.dup(lsock.fileno()))
    server.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/ping")
        resp = conn.getresponse()
        assert js.loads(resp.read()) == {"pong": True}
        assert resp.getheader("Connection") != "close"  # keep-alive normally

        server.draining.set()
        conn.request("GET", "/ping")
        resp = conn.getresponse()
        assert js.loads(resp.read()) == {"pong": True}
        assert resp.getheader("Connection") == "close"
        conn.close()
    finally:
        server.shutdown()
        lsock.close()


def test_load_shedding_503_past_in_flight_cap(monkeypatch):
    """With GIP_MAX_IN_FLIGHT=2, a third concurrent request sheds with
    an immediate 503 instead of parking behind the stall."""
    import http.client
    import json as js
    import socket as so
    import threading

    from gpu_image_processing.server.http import AppServer, Router

    monkeypatch.setenv("GIP_MAX_IN_FLIGHT", "2")
    release = threading.Event()
    app = Router()

    @app.get("/slow")
    def slow(_req):
        release.wait(30)
        return 200, {"done": True}

    lsock = so.socket(so.AF_INET, so.SOCK_STREAM)
    lsock.setsockopt(so.SOL_SOCKET, so.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(8)
    port = lsock.getsockname()[1]
    server = AppServer(app, "127.0.0.1", port, listen_fd=os.dup(lsock.fileno()))
    server.start_background()
    statuses = []

    def fire():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/slow")
        resp = conn.getresponse()
        statuses.append((resp.status, js.loads(resp.read())))
        conn.close()

    try:
        t1 = threading.Thread(target=fire)
        t2 = threading.Thread(target=fire)
        t1.start(); t2.start()
        deadline = time.time() + 10
        while server.in_flight.value < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert server.in_flight.value == 2

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/slow")
        resp = conn.getresponse()
        body = js.loads(resp.read())
        assert resp.status == 503
        assert "overloaded" in body["detail"]
        assert resp.getheader("Connection") == "close"
        conn.close()

        release.set()
        t1.join(timeout=15); t2.join(timeout=15)
        assert [s for s, _ in statuses] == [200, 200]
    finally:
        release.set()
        server.shutdown()
        lsock.close()


def test_supervisor_exit_policy_restarts_abnormal_deaths():
    """The supervisor restarts on EXIT_RECYCLE *and* abnormal deaths
    (signal/crash), stopping only on clean exit or a crash loop -- a
    worker dying by a signal during interpreter teardown (rc=-6 instead
    of 43) must not take the service down on an announced recycle."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("serve_mod", SERVE)
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    from gpu_image_processing.core import config as cfg

    # Clean exit stops.
    assert serve._exit_action(0, 100.0, 0, 30.0)[0] == "stop"
    # Announced recycle restarts.
    assert serve._exit_action(cfg.EXIT_RECYCLE, 100.0, 0, 30.0)[0] == "restart"
    # SIGABRT during teardown (the observed race) restarts.
    assert serve._exit_action(-6, 50.0, 0, 30.0)[0] == "restart"
    # Generic crash restarts...
    action, rapid = serve._exit_action(1, 5.0, 0, 30.0)
    assert action == "restart" and rapid == 1
    # ...but three fast deaths trip the crash-loop guard.
    action, rapid = serve._exit_action(-9, 5.0, 1, 30.0)
    assert action == "restart" and rapid == 2
    assert serve._exit_action(1, 5.0, 2, 30.0)[0] == "stop"
    # A long-lived generation resets the rapid counter.
    assert serve._exit_action(cfg.EXIT_RECYCLE, 300.0, 2, 30.0) == (
        "restart", 0)
