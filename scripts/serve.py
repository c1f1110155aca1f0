#!/usr/bin/env python3
"""Process orchestration: start/stop/status for the backend + frontend.

The analog of the reference's start_servers.sh/stop_servers.sh
(port probing, background launch with PID files, log capture, health poll,
monitor loop) -- minus the venv bootstrap and CMake build steps, which this
framework does not need (kernels compile through XLA at run time).

Usage:
    python scripts/serve.py start [--no-frontend] [--monitor]
    python scripts/serve.py stop
    python scripts/serve.py status
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gpu_image_processing.core import config  # noqa: E402

RUN_DIR = os.environ.get("GIP_RUN_DIR", tempfile.gettempdir())
BACKEND_PID = os.path.join(RUN_DIR, "gip_backend.pid")
SUPERVISOR_PID = os.path.join(RUN_DIR, "gip_supervisor.pid")
FRONTEND_PID = os.path.join(RUN_DIR, "gip_frontend.pid")
BACKEND_LOG = os.path.join(RUN_DIR, "gip_backend.log")
FRONTEND_LOG = os.path.join(RUN_DIR, "gip_frontend.log")


def port_in_use(port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        return s.connect_ex(("127.0.0.1", port)) == 0


def read_pid(path: str) -> int | None:
    try:
        with open(path) as f:
            pid = int(f.read().strip())
        os.kill(pid, 0)
        return pid
    except (OSError, ValueError):
        return None


def spawn(cmd: list[str], log_path: str, pid_path: str, cwd: str | None = None) -> int:
    log = open(log_path, "ab")
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, cwd=cwd or REPO,
        start_new_session=True,
    )
    with open(pid_path, "w") as f:
        f.write(str(proc.pid))
    return proc.pid


def wait_healthy(timeout_s: float = 120.0) -> bool:
    # The backend binds its port right after importing JAX (precompiles
    # run in the background), so health answers within seconds.
    url = f"http://127.0.0.1:{config.BACKEND_PORT}/api/health"
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                body = json.loads(resp.read())
                if body.get("status") == "healthy":
                    return True
        except Exception:
            pass
        time.sleep(2)
    return False


def maybe_build_native() -> None:
    """Build the native codec if absent (the analog of start_servers.sh
    auto-building the CUDA lib + bindings, :100-184).  Serving works without
    it (numpy + zlib PNG tier), so failures only warn."""
    from gpu_image_processing.utils import native_codec

    try:
        how = native_codec.build()
        if how != "present":
            print(f"Built native codec with {how} "
                  "(native/build/libgip_codec.so)")
    except Exception as exc:
        print(f"Native codec build skipped ({exc}); serving with the "
              "stdlib PNG codec")


def _exit_action(rc: int, uptime: float, rapid: int,
                 min_uptime: float) -> tuple[str, int]:
    """Supervisor policy for one backend exit: ("stop"|"restart", rapid').

    rc == 0 stops (clean shutdown).  EXIT_RECYCLE and abnormal deaths
    (negative rc = signal, other nonzero = crash) both RESTART -- a
    production supervisor must outlive its worker's failure modes (a
    worker can die by a signal during interpreter teardown, rc=-6 instead
    of 43, on an ANNOUNCED recycle).  The crash-loop guard stops after 3
    deaths faster than min_uptime.
    """
    if rc == 0:
        return "stop", rapid
    rapid = rapid + 1 if uptime < min_uptime else 0
    if rapid >= 3:
        return "stop", rapid
    return "restart", rapid


def cmd_supervise(_args) -> int:
    """Foreground backend supervisor: run the backend as a direct child and
    restart it whenever it exits with config.EXIT_RECYCLE (the opt-in
    RSS-watchdog worker recycle, server/app.py).  The wait() between spawns
    guarantees the recycle is SEQUENTIAL: the old process has released the
    GPU before the new one initializes -- a second JAX process on the card
    would find most of its memory reserved.
    Abnormal worker deaths also restart (bounded by the crash-loop guard);
    only a clean exit 0 or the guard stops supervision (_exit_action)."""
    min_uptime = float(os.environ.get("GIP_RECYCLE_MIN_UPTIME_S", "30"))
    state = {"stopping": False, "proc": None}

    def _term(_sig, _frm):
        state["stopping"] = True
        proc = state["proc"]
        if proc is not None and proc.poll() is None:
            proc.terminate()

    signal.signal(signal.SIGTERM, _term)
    # Foreground mode (start_servers.py) leaves the supervisor in the
    # terminal's process group: treat Ctrl-C's SIGINT as the same orderly
    # stop (the backend child handles its own SIGINT by draining).
    signal.signal(signal.SIGINT, _term)

    # The supervisor owns the listening socket and lends it to every backend
    # generation (GIP_LISTEN_FD): connections arriving mid-recycle queue
    # in this socket's kernel backlog instead of getting ECONNREFUSED while
    # the replacement worker boots.
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        lsock.bind((config.BACKEND_HOST, config.BACKEND_PORT))
    except OSError as exc:
        print(f"supervisor: cannot bind port {config.BACKEND_PORT}: {exc}")
        return 1
    lsock.listen(128)

    rapid = 0
    generation = 0
    while True:
        # SIGTERM may land BETWEEN generations (the old backend just
        # exited); without this check the loop would spawn a fresh backend
        # that nothing ever stops.
        if state["stopping"]:
            return 0
        started = time.time()
        generation += 1
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpu_image_processing.server.app"],
            cwd=REPO,
            env={**os.environ,
                 "GIP_LISTEN_FD": str(lsock.fileno()),
                 "GIP_WORKER_GENERATION": str(generation)},
            pass_fds=(lsock.fileno(),),
        )
        state["proc"] = proc
        if state["stopping"]:
            # Raced the spawn itself: _term captured the previous (dead)
            # proc; stop this one too.
            proc.terminate()
        with open(BACKEND_PID, "w") as f:
            f.write(str(proc.pid))
        rc = proc.wait()
        uptime = time.time() - started
        if state["stopping"]:
            return 0
        action, rapid = _exit_action(rc, uptime, rapid, min_uptime)
        if action == "stop":
            if rc == 0:
                print(f"backend exited cleanly after {uptime:.0f}s; "
                      "supervisor stopping", flush=True)
                return 0
            print(f"backend died/recycled 3x within {min_uptime:.0f}s of "
                  "start; giving up (crash loop, or GIP_MAX_RSS_MB "
                  "below baseline RSS?)", flush=True)
            return 1
        why = ("requested recycle" if rc == config.EXIT_RECYCLE
               else f"died rc={rc}")
        print(f"backend {why} after {uptime:.0f}s; restarting", flush=True)


def cmd_start(args) -> int:
    maybe_build_native()
    if port_in_use(config.BACKEND_PORT):
        print(f"Backend port {config.BACKEND_PORT} already in use")
        return 1
    # The supervisor (not the backend) is the detached process: it restarts
    # the backend across RSS-watchdog recycles; BACKEND_PID is (re)written
    # by the supervisor at each spawn.
    pid = spawn(
        [sys.executable, os.path.abspath(__file__), "supervise"],
        BACKEND_LOG, SUPERVISOR_PID,
    )
    print(f"Backend starting (supervisor pid {pid}, log {BACKEND_LOG}) ...")
    if not wait_healthy():
        print("Backend failed to become healthy; see log")
        return 1
    print(f"Backend healthy on http://127.0.0.1:{config.BACKEND_PORT}")

    if not args.no_frontend:
        if port_in_use(config.FRONTEND_PORT):
            print(f"Frontend port {config.FRONTEND_PORT} already in use")
        else:
            fpid = spawn(
                [sys.executable, "-m", "http.server", str(config.FRONTEND_PORT),
                 "--bind", "0.0.0.0"],
                FRONTEND_LOG, FRONTEND_PID, cwd=os.path.join(REPO, "frontend"),
            )
            print(f"Frontend on http://127.0.0.1:{config.FRONTEND_PORT} (pid {fpid})")

    if args.monitor:
        print("Monitoring (ctrl-c to detach; servers keep running) ...")
        try:
            while True:
                time.sleep(10)
                # Watch the SUPERVISOR: the backend pid legitimately
                # changes across RSS-watchdog recycles.
                if read_pid(SUPERVISOR_PID) is None:
                    print("Backend supervisor died; stopping everything")
                    cmd_stop(args)
                    return 1
        except KeyboardInterrupt:
            pass
    return 0


def _stop_one(pid_path: str, port: int, name: str) -> None:
    pid = read_pid(pid_path)
    if pid:
        try:
            os.killpg(os.getpgid(pid), signal.SIGTERM)
            print(f"Stopped {name} (pid {pid})")
        except OSError as exc:
            print(f"Could not stop {name} pid {pid}: {exc}")
        try:
            os.remove(pid_path)
        except OSError:
            pass
    elif port_in_use(port):
        # PID file lost; find the listener (stop_servers.sh:50-68 analog).
        try:
            out = subprocess.run(
                ["lsof", "-t", f"-i:{port}"], capture_output=True, text=True
            ).stdout.split()
            for p in out:
                os.kill(int(p), signal.SIGTERM)
                print(f"Stopped {name} on port {port} (pid {p})")
        except Exception as exc:
            print(f"Could not free port {port}: {exc}")
    else:
        print(f"{name} not running")


def cmd_stop(_args) -> int:
    # The supervisor and backend share a process group (the supervisor was
    # spawned with start_new_session and the backend inherits), so the
    # group SIGTERM below reaches both: the supervisor stops restarting,
    # the backend drains gracefully (server/app.py SIGTERM handler).
    _stop_one(SUPERVISOR_PID, config.BACKEND_PORT, "backend supervisor")
    _stop_one(BACKEND_PID, config.BACKEND_PORT, "backend")
    _stop_one(FRONTEND_PID, config.FRONTEND_PORT, "frontend")
    return 0


def cmd_status(_args) -> int:
    for name, pid_path, port in [
        ("supervisor", SUPERVISOR_PID, config.BACKEND_PORT),
        ("backend", BACKEND_PID, config.BACKEND_PORT),
        ("frontend", FRONTEND_PID, config.FRONTEND_PORT),
    ]:
        pid = read_pid(pid_path)
        listening = port_in_use(port)
        print(f"{name}: pid={pid or '-'} port_{port}={'up' if listening else 'down'}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_start = sub.add_parser("start")
    p_start.add_argument("--no-frontend", action="store_true")
    p_start.add_argument("--monitor", action="store_true")
    sub.add_parser("stop")
    sub.add_parser("status")
    sub.add_parser("supervise")  # internal: spawned by cmd_start
    args = parser.parse_args()
    config.check_env()
    return {"start": cmd_start, "stop": cmd_stop, "status": cmd_status,
            "supervise": cmd_supervise}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
