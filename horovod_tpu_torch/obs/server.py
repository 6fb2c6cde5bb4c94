"""The metrics exporter HTTP server — port of `start_metrics_server` in
`horovod_tpu.obs.server`: ``GET /metrics`` for any process.

`start_metrics_server` serves a registry on a standalone scrape port
(``python -m horovod_tpu_torch.launch.serve --metrics-port N`` mounts the
server's own registry there, so the client-facing port and the scrape
port can sit on different networks). With ``profile=True`` it also
mounts ``POST /profile?seconds=N``: an on-demand `torch.profiler` capture
(CPU and, on the card, CUDA activity, every thread of the process) of the
next N seconds, written as a Chrome trace into ``HVT_TRACE_DIR`` (or
``HVT_PROFILE``) — a slow phase can be drilled into without relaunching.
``POST /flightrecord`` answers 409: the collective flight recorder is not
ported (ROADMAP queue A item 13), and neither is the trainer-side
exporter (``HVT_METRICS_PORT``).

Binds loopback by default (``HVT_STATUS_HOST``): the routes are
unauthenticated.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from horovod_tpu_torch.analysis import registry as knobs
from horovod_tpu_torch.obs import core, prom


class _ProfileTrigger:
    """One in-flight on-demand profiler capture per server; a second POST
    while one runs gets 409. The capture starts, waits and stops on one
    thread of its own (the profiler's state belongs to the thread that
    started it) and records every thread's operators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: str | None = None

    def start(self, seconds: float) -> str:
        out_root = (knobs.get_str("HVT_TRACE_DIR")
                    or knobs.get_str("HVT_PROFILE"))
        if not out_root:
            raise ValueError(
                "on-demand profiling needs HVT_TRACE_DIR or HVT_PROFILE "
                "set — the capture has nowhere to land"
            )
        seconds = float(seconds)
        if not 0 < seconds <= 600:
            raise ValueError("seconds must be in (0, 600]")
        import torch

        with self._lock:
            if self._active is not None:
                raise RuntimeError(
                    f"a capture is already running ({self._active})"
                )
            out_dir = os.path.join(
                out_root, f"profile-{time.strftime('%Y%m%d-%H%M%S')}"
            )
            self._active = out_dir
        started = threading.Event()
        failure: list = []

        def capture():
            try:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(
                    activities=activities,
                    experimental_config=torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True),
                )
                prof.start()
            except BaseException as e:
                failure.append(e)
                with self._lock:
                    self._active = None
                started.set()
                return
            started.set()
            try:
                time.sleep(seconds)
                prof.stop()
                os.makedirs(out_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            finally:
                with self._lock:
                    self._active = None

        threading.Thread(target=capture, daemon=True).start()
        started.wait()
        if failure:
            raise failure[0]
        return out_dir


def start_metrics_server(port: int, host: str | None = None,
                         registry: core.Registry | None = None,
                         profile: bool = False):
    """Serve ``GET /metrics`` (+ ``GET /healthz``; ``POST /profile`` when
    ``profile=True``) for ``registry`` (default: the process default).
    ``host`` defaults to ``HVT_STATUS_HOST``. Port 0 binds ephemerally —
    ``server.server_address[1]`` carries the real one. Returns the
    started server; callers own ``shutdown()``."""
    if host is None:
        host = knobs.get_str("HVT_STATUS_HOST")
    reg = registry if registry is not None else core.default_registry()
    trigger = _ProfileTrigger() if profile else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # scrapes are noise
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(),
                       "application/json")

        def do_GET(self):
            try:
                path = urlparse(self.path).path
                if path == "/metrics":
                    reg.counter("hvt_scrapes_total")
                    prom.write_http(self, reg)
                elif path == "/healthz":
                    self._send_json(200, {"status": "ok"})
                else:
                    self._send_json(404, {"error": f"no route {path}"})
            except Exception as e:  # observability must never crash
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            try:
                url = urlparse(self.path)
                if url.path == "/flightrecord":
                    self._send_json(409, {
                        "error": "the collective flight recorder is not "
                        "ported yet (ROADMAP queue A item 13)",
                    })
                    return
                if url.path != "/profile" or trigger is None:
                    self._send_json(404, {"error": f"no route {url.path}"})
                    return
                q = parse_qs(url.query)
                seconds = float(q.get("seconds", ["5"])[0])
                try:
                    out_dir = trigger.start(seconds)
                except RuntimeError as e:
                    self._send_json(409, {"error": str(e)})
                    return
                except ValueError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(
                    200, {"profiling": out_dir, "seconds": seconds}
                )
            except Exception as e:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
