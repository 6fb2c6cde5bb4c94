"""The serving front end: one address, many replicas — port of
`horovod_tpu.serving.router`.

`ReplicaSet` is the membership + in-flight ledger: the router's dispatch
key is each replica's in-flight count (least-loaded wins), and the SAME
counter reaching zero is the drain barrier a weight swap waits behind.
`make_router` builds the HTTP proxy:

* ``POST /v1/generate`` / ``/v1/predict`` — forwarded to the least-loaded
  replica that is neither draining nor dead; NDJSON streams pass through
  line by line (client TTFT is the first line's arrival, which is what
  the router's ``hvt_serve_ttft_seconds`` observes);
* connect failures BEFORE any response bytes retry on another replica
  (``hvt_serve_router_retries_total``) and mark the silent one dead;
  mid-stream failures surface to the client (a retry would replay
  sampled tokens);
* ``GET /healthz`` — per-replica in-flight/draining/dead rollup;
* ``GET /metrics`` — the router's own typed registry: requests by
  route/code (the ``code="500"`` series is set to 0 up front, so a gate
  on it reads an explicit zero, never an absent series), TTFT/latency
  histograms, per-replica in-flight gauges, retries.

No replica available (all draining/dead, or the set is empty) is 503 —
distinct from a replica's own 429 (admission refused), which forwards
verbatim so clients can tell "back off" from "fleet down". The replicas
are any servers that speak the JSON/NDJSON wire of `launch.serve`: the
port's, or the JAX package's. The fleet that starts, swaps and scales
replicas (`serving/fleet.py` in the JAX package) waits for the control
plane (ROADMAP queue A item 13).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

from horovod_tpu_torch import trace as trace_lib
from horovod_tpu_torch.launch.serve import BacklogHTTPServer
from horovod_tpu_torch.obs import core as obs_core
from horovod_tpu_torch.obs import prom as obs_prom

_request_ids = itertools.count(1)


class NoReplicaError(RuntimeError):
    """Nothing admitting traffic — the HTTP layer maps this to 503."""


class Replica:
    """One backend's ledger entry. ``inflight`` is router-side accounting
    (incremented at dispatch, decremented when the last response byte is
    out), so it counts the whole proxied exchange including a slow
    client's stream drain — the honest drain barrier."""

    __slots__ = ("name", "base_url", "inflight", "draining", "dead")

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.inflight = 0
        self.draining = False
        self.dead = False

    @property
    def available(self) -> bool:
        return not (self.draining or self.dead)


class ReplicaSet:
    """Thread-safe membership + least-loaded pick."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._rr = itertools.count()  # tie-break rotates, not sticks

    def add(self, name: str, base_url: str) -> Replica:
        with self._lock:
            r = Replica(name, base_url)
            self._replicas[name] = r
            return r

    def remove(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def get(self, name: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._replicas)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {"name": r.name, "url": r.base_url, "inflight": r.inflight,
                 "draining": r.draining, "dead": r.dead}
                for r in self._replicas.values()
            ]

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.available)

    def drain(self, name: str) -> None:
        with self._lock:
            if name in self._replicas:
                self._replicas[name].draining = True

    def readmit(self, name: str) -> None:
        with self._lock:
            if name in self._replicas:
                r = self._replicas[name]
                r.draining = False
                r.dead = False

    def mark_dead(self, name: str) -> None:
        with self._lock:
            if name in self._replicas:
                self._replicas[name].dead = True

    def wait_drained(self, name: str, timeout: float) -> bool:
        """Poll until ``name`` has zero in flight (or it left the set)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                r = self._replicas.get(name)
                if r is None or r.inflight == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def acquire(self, exclude: set[str] | None = None) -> Replica:
        """Pick the least-loaded available replica and count the request
        against it atomically (pick-then-increment under one lock, or two
        racing handlers would both dub the same replica 'least loaded')."""
        with self._lock:
            pool = [
                r for r in self._replicas.values()
                if r.available and r.name not in (exclude or ())
            ]
            if not pool:
                raise NoReplicaError(
                    "no replica available "
                    f"({len(self._replicas)} registered, all "
                    "draining/dead)" if self._replicas else
                    "no replica registered"
                )
            offset = next(self._rr)
            r = min(
                enumerate(pool),
                key=lambda ir: (ir[1].inflight, (ir[0] + offset) % len(pool)),
            )[1]
            r.inflight += 1
            return r

    def release(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)


def make_router(port: int = 0, host: str = "127.0.0.1",
                replicas: ReplicaSet | None = None,
                registry=None):
    """Build (don't start) the front-end proxy. ``server.replicas`` is
    the live `ReplicaSet` (callers add, drain and readmit replicas
    through it); ``server.metrics_registry`` the router's own typed
    registry."""
    replica_set = replicas if replicas is not None else ReplicaSet()
    reg = registry if registry is not None else obs_core.Registry()

    def _collect(r):
        r.gauge("hvt_serve_replicas", replica_set.live_count())
        for snap in replica_set.snapshot():
            r.gauge(
                "hvt_serve_replica_inflight", snap["inflight"],
                replica=snap["name"],
            )

    reg.register_collector(_collect)
    # A zero-500s gate reads this series — materialize it at 0 up front
    # so a clean run exposes an explicit zero instead of absence.
    reg.counter_set(
        "hvt_serve_requests_total", 0, route="/v1/generate", code="500"
    )

    _KNOWN_ROUTES = ("/healthz", "/metrics", "/v1/predict", "/v1/generate")

    def _route(path: str) -> str:
        path = path.split("?", 1)[0]
        return path if path in _KNOWN_ROUTES else "other"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            # Counted before the body goes out: a client that has read the
            # reply finds it in /metrics.
            reg.counter(
                "hvt_serve_requests_total", route=_route(self.path),
                code=str(code),
            )
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                obs_prom.write_http(self, reg)
            elif self.path == "/healthz":
                snaps = replica_set.snapshot()
                self._send(200, {
                    "status": "ok" if replica_set.live_count() else
                    "no-replicas",
                    "tier": "router",
                    "replicas": snaps,
                    "live": replica_set.live_count(),
                })
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if _route(self.path) == "other":
                self._send(404, {"error": f"no route {self.path}"})
                return
            with trace_lib.span(
                "request", req=next(_request_ids), route=_route(self.path),
                tier="router",
            ):
                self._proxy()

        def _proxy(self):
            t0 = time.perf_counter()
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            tried: set[str] = set()
            while True:
                try:
                    replica = replica_set.acquire(exclude=tried)
                except NoReplicaError as e:
                    self._send(503, {"error": str(e)})
                    return
                tried.add(replica.name)
                try:
                    upstream = self._dial(replica, body)
                except (ConnectionError, OSError,
                        urllib.error.URLError):
                    # The replica never ANSWERED (no bytes reached the
                    # client) — the only point a retry is safe. Mark it,
                    # count the retry, move on; `readmit` brings it back.
                    replica_set.mark_dead(replica.name)
                    reg.counter("hvt_serve_router_retries_total")
                    replica_set.release(replica)
                    continue
                try:
                    if upstream is not None:
                        self._relay(upstream, t0)
                except (ConnectionError, OSError):
                    # Mid-exchange failure (either side): bytes are out,
                    # a retry would replay them — the truncated stream /
                    # torn socket is the client's signal. NOT the
                    # replica's death sentence: a slow CLIENT breaks the
                    # same way.
                    pass
                finally:
                    replica_set.release(replica)
                return

        def _dial(self, replica: Replica, body: bytes):
            """Open the upstream exchange. Raises only while a retry on
            another replica is still safe; an HTTP error status is an
            ANSWER and forwards verbatim (returns None)."""
            req = urllib.request.Request(
                replica.base_url + self.path, data=body,
                headers={"Content-Type": "application/json"},
            )
            try:
                return urllib.request.urlopen(req, timeout=300)
            except urllib.error.HTTPError as e:
                payload = e.read()
                self.send_response(e.code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                reg.counter(
                    "hvt_serve_requests_total", route=_route(self.path),
                    code=str(e.code),
                )
                self.wfile.write(payload)
                return None

        def _relay(self, upstream, t0: float):
            with upstream:
                ctype = upstream.headers.get("Content-Type", "")
                if "ndjson" in ctype:
                    # Streaming passthrough: relay line by line; the
                    # first line out IS the client's TTFT.
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.end_headers()
                    first = True
                    for line in upstream:
                        self.wfile.write(line)
                        self.wfile.flush()
                        if first:
                            reg.histogram(
                                "hvt_serve_ttft_seconds",
                                time.perf_counter() - t0,
                            )
                            first = False
                else:
                    payload = upstream.read()
                    self.send_response(upstream.status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                    if _route(self.path) == "/v1/generate":
                        reg.histogram(
                            "hvt_serve_ttft_seconds",
                            time.perf_counter() - t0,
                        )
            reg.counter(
                "hvt_serve_requests_total", route=_route(self.path),
                code="200",
            )
            reg.histogram(
                "hvt_serve_request_seconds", time.perf_counter() - t0,
                route=_route(self.path),
            )

    server = BacklogHTTPServer((host, port), Handler)
    server.replicas = replica_set
    server.metrics_registry = reg
    return server
