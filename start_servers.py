#!/usr/bin/env python3
"""Foreground launcher: backend + frontend as direct children, Ctrl-C stops
both (analog of the reference's root start_servers.py, which runs both
servers attached with signal-based cleanup -- unlike start_servers.sh /
scripts/serve.py `start`, which detach and manage PID files).

The backend child is the scripts/serve.py SUPERVISOR, not the raw app:
opt-in worker recycling (GIP_MAX_RSS_MB) must keep working in foreground
mode too.
"""

from __future__ import annotations

import importlib.util
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
_SERVE = os.path.join(REPO, "scripts", "serve.py")

_spec = importlib.util.spec_from_file_location("gip_serve", _SERVE)
serve = importlib.util.module_from_spec(_spec)
sys.modules["gip_serve"] = serve
_spec.loader.exec_module(serve)

config = serve.config


def main() -> int:
    serve.maybe_build_native()
    if serve.port_in_use(config.BACKEND_PORT):
        print(f"Backend port {config.BACKEND_PORT} already in use "
              f"(./stop_servers.sh to clear a detached instance)")
        return 1

    procs: list[tuple[str, subprocess.Popen]] = []

    def cleanup(signum=None, frame=None, rc: int = 0):
        """Stop both children; exit 0 only for a signal-requested stop
        (failure paths call cleanup(rc=1) so `start_servers.py && ...`
        and CI see the failed launch)."""
        print("\nShutting down servers...")
        for name, proc in procs:
            if proc.poll() is None:
                print(f"  stopping {name} (pid {proc.pid})")
                proc.terminate()
        for _, proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                # Never SIGKILL the backend tree: leave it to finish its
                # graceful drain instead.
                print(f"  {proc.pid} still draining; leaving it to exit")
        print("Servers stopped.")
        sys.exit(rc)

    signal.signal(signal.SIGINT, cleanup)
    signal.signal(signal.SIGTERM, cleanup)

    backend = subprocess.Popen(
        [sys.executable, _SERVE, "supervise"], cwd=REPO)
    procs.append(("backend supervisor", backend))
    print(f"Backend starting (supervisor pid {backend.pid}) ...")
    if not serve.wait_healthy():
        print("Backend failed to become healthy")
        cleanup(rc=1)
    print(f"Backend  : http://127.0.0.1:{config.BACKEND_PORT}")

    if serve.port_in_use(config.FRONTEND_PORT):
        print(f"Frontend port {config.FRONTEND_PORT} already in use; "
              f"backend only")
    else:
        frontend = subprocess.Popen(
            [sys.executable, "-m", "http.server", str(config.FRONTEND_PORT),
             "--bind", "0.0.0.0"],
            cwd=os.path.join(REPO, "frontend"),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs.append(("frontend", frontend))
        print(f"Frontend : http://127.0.0.1:{config.FRONTEND_PORT}")

    print("Press Ctrl+C to stop both servers")
    while True:
        time.sleep(5)
        for name, proc in procs:
            if proc.poll() is not None:
                print(f"{name} exited (code {proc.returncode}); "
                      f"shutting down")
                cleanup(rc=1 if proc.returncode else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
