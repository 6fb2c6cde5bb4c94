"""HTTP model server over the port's serving bundles — port of
`horovod_tpu.launch.serve`. Two bundle kinds, auto-detected:

* **predict bundles** (`checkpoint.export_serving`) — the reference's
  ``input → prob`` classifier contract;
* **generation bundles** (`serving.export_generate`) — the LM's prefill +
  decode loop, tokenizer riding along.

Endpoints (JSON; errors are JSON too: 400, 404, 429, 500):

* ``GET  /healthz`` → ``{"status": "ok", "bundle": ..., "kind": ...,
  "signature": ..., "stats": ..., "inflight": N}`` (+ ``"scheduler"`` in
  continuous mode);
* ``GET  /metrics`` → the Prometheus exposition of this server's own
  registry (`obs`): requests by route and code, device calls and rows,
  queue depth, request-latency, TTFT and TPOT histograms;
* ``POST /v1/predict`` body ``{"input": [[...], ...]}`` →
  ``{"prob": [[...], ...]}``;
* ``POST /v1/generate`` body ``{"prompt": [[ids...], ...]}`` or, when the
  bundle carries a tokenizer, ``{"text": ["...", ...]}`` (+ optional
  ``"seed": N``) → ``{"tokens": [[ids...], ...]}`` (+ ``"text"``);
* ``POST /v1/generate`` with ``"stream": true`` (streaming bundles) →
  ``application/x-ndjson``: one ``{"tokens": [[ids...]]}`` line per
  generated chunk, then ``{"done": true, "tokens": ..., "text": ...}``;
* ``POST /admin/reload`` body ``{"bundle_dir": ...}`` (with
  ``allow_reload``, else 404) — swap to another bundle in place.

Batching: a bundle serves one batch shape. Requests of any row count are
padded up / split to it server-side, and generation prompts of any length
up to ``prompt_len`` ride the ragged-lengths path.

Concurrency, coalescing mode (the default): ONE device worker thread per
app (`_Batcher`) is the only code that touches the card. Handler threads
parse, validate and enqueue, and get lists or numpy arrays back. Rows from
concurrent requests are packed into the bundle's batch, so N single-row
clients cost about ceil(N / batch) device calls. Sampled generation
bundles serialize whole requests through the worker (each owns its
seed), and a stream dispatches each chunk as its own worker call, so
other requests interleave with a slow reader. ``coalesce=False`` keeps
the serialized baseline: one request's batches at a time.
``continuous=True`` (streaming generation bundles only) routes
``/v1/generate`` through the per-chunk scheduler
(`serving.engine.ContinuousBatchingEngine`; a full wait queue is 429),
sized by ``HVT_SERVE_MAX_SEQS`` / ``HVT_SERVE_BLOCK_TOKENS`` /
``HVT_SERVE_KV_BLOCKS`` / ``HVT_SERVE_QUEUE_DEPTH``.

Process behaviour (`serve_forever`): SIGTERM drains — in-flight requests
finish (up to ``HVT_SERVE_DRAIN_TIMEOUT_S``), the engine drains and stops,
then the server shuts down and the process exits 0. ``--metrics-port``
also serves the registry on a scrape port of its own (`obs.server`,
loopback unless ``HVT_STATUS_HOST``).

Not ported (ROADMAP queue A item 13, the control plane): fleet membership
(``--coordinator``/``--member``), the supervisor journal
(``--fleet-journal``) and ``hvt-launch serve``; the flags are refused.

Run: ``python -m horovod_tpu_torch.launch.serve <bundle_dir> [--port 8000]
[--device cuda] [--continuous] [--allow-reload] [--metrics-port N]``
(tests use `make_server` + a background thread).
"""

from __future__ import annotations

import itertools
import json
import os
import queue as queue_lib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from horovod_tpu_torch import trace as trace_lib
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.obs import core as obs_core
from horovod_tpu_torch.obs import prom as obs_prom
from horovod_tpu_torch.serving import bundle as bundle_lib
from horovod_tpu_torch.serving.engine import (
    AdmissionError,
    ContinuousBatchingEngine,
)

# Monotone per-process request ids for the serving `request` spans.
_request_ids = itertools.count(1)

_ITEM_13 = "ROADMAP queue A item 13 (the control plane), not ported yet"


class _Slot:
    """One queued item's rendezvous with the device worker.
    ``started``/``finished`` carry the worker's clocks around the device
    call that served it — (wall, perf) at dispatch and perf at completion —
    so the submitting handler thread can emit its queue-wait / decode
    spans."""

    __slots__ = ("event", "value", "error", "started", "finished")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None
        self.started = None
        self.finished = None

    def set(self, value):
        self.value = value
        self.event.set()

    def set_err(self, e):
        self.error = e
        self.event.set()

    def get(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.value


class _Call:
    """A function the worker runs alone (not packed with rows)."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


class _Batcher:
    """The coalescing device worker.

    Handler threads `submit` lists of row-items, or `call` a function, and
    block; the single worker thread drains the queue, packs up to
    ``batch`` rows — across requests — into one ``run_rows(items) ->
    results`` call, runs each `call` alone in queue order, and hands the
    results back. The worker is the only thread that touches the card: a
    CUDA graph captured on it (`models.decoding.StepGraph`, global capture
    mode) never races another thread's launches.

    When ``HVT_TRACE_DIR`` is set, the worker stamps each slot with its
    clocks so the handler thread emits ``queue_wait`` / ``decode`` spans
    under ITS open ``request`` span (`trace.emit_span`).
    """

    _STOP = object()

    def __init__(self, run_rows, batch: int, stats: dict):
        self.run_rows = run_rows
        self.batch = batch
        self.stats = stats
        self.q: queue_lib.Queue = queue_lib.Queue()
        self._put_lock = threading.Lock()
        self._stopped = False
        self._worker = threading.Thread(target=self._loop,
                                        name="hvt-serve-device", daemon=True)
        self._worker.start()

    def _put(self, entries: list) -> None:
        with self._put_lock:
            if self._stopped:
                raise RuntimeError("the serving device worker is stopped")
            for entry in entries:
                self.q.put(entry)

    def _wait(self, slots: list, t_sub: float, p_sub: float, rows: int):
        out = [s.get() for s in slots]
        if trace_lib.span_dir() and slots[0].started is not None:
            started_wall, started_perf = slots[0].started
            trace_lib.emit_span(
                "queue_wait", t_sub, max(0.0, started_perf - p_sub)
            )
            if slots[-1].finished is not None:
                trace_lib.emit_span(
                    "decode", started_wall,
                    slots[-1].finished - started_perf, rows=rows,
                )
        return out

    def submit(self, items: list) -> list:
        """Per-row results of ``items``, packed with other requests'."""
        if not items:
            return []
        slots = [_Slot() for _ in items]
        t_sub, p_sub = time.time(), time.perf_counter()
        self._put(list(zip(items, slots)))
        return self._wait(slots, t_sub, p_sub, len(items))

    def call(self, fn, rows: int = 1):
        """``fn()`` run on the worker thread, alone; its result or its
        exception."""
        slot = _Slot()
        t_sub, p_sub = time.time(), time.perf_counter()
        self._put([(_Call(fn), slot)])
        return self._wait([slot], t_sub, p_sub, rows)[0]

    def stop(self, timeout: float = 30.0) -> None:
        """Retire the worker after what is already queued; later `submit`
        and `call` raise."""
        with self._put_lock:
            if not self._stopped:
                self._stopped = True
                self.q.put(_Batcher._STOP)
        if threading.current_thread() is not self._worker:
            self._worker.join(timeout)

    def _loop(self):
        pending = None
        while True:
            first = pending if pending is not None else self.q.get()
            pending = None
            if first is _Batcher._STOP:
                return
            if isinstance(first[0], _Call):
                self._run([first], lambda items: [items[0].fn()])
                continue
            group = [first]
            while len(group) < self.batch:
                try:
                    entry = self.q.get_nowait()
                except queue_lib.Empty:
                    break
                if entry is _Batcher._STOP or isinstance(entry[0], _Call):
                    pending = entry  # honoured after this group, in order
                    break
                group.append(entry)
            self.stats["device_calls"] += 1
            self.stats["rows"] += len(group)
            self._run(group, self.run_rows)

    @staticmethod
    def _run(group, fn):
        started = (time.time(), time.perf_counter())
        for _, s in group:
            s.started = started
        try:
            results = fn([it for it, _ in group])
        except Exception as e:
            for _, s in group:
                s.set_err(e)
            return
        done = time.perf_counter()
        for (_, s), r in zip(group, results):
            s.finished = done
            s.set(r)


class _ModelApp:
    """A predict bundle, its batch size, and the pad/split logic."""

    kind = "predict"
    engine = None

    def __init__(self, bundle_dir: str, coalesce: bool = True,
                 device="cuda"):
        from horovod_tpu_torch import checkpoint

        self.bundle_dir = bundle_dir
        self.fn = checkpoint.load_serving(bundle_dir, device=device)
        with open(os.path.join(bundle_dir, checkpoint.SIGNATURE_FILE)) as f:
            self.signature = json.load(f)["signature"]
        spec = self.signature["inputs"]["input"]
        self.batch = int(spec["shape"][0])
        self.row_shape = tuple(int(d) for d in spec["shape"][1:])
        self.dtype = np.dtype(spec["dtype"])
        self.stats = {"device_calls": 0, "rows": 0}
        # coalesce=False keeps the serialize-whole-requests baseline.
        self.coalesce = coalesce
        self._batcher = _Batcher(self._run_rows, self.batch, self.stats)

    def _run_rows(self, rows: list) -> list:
        # The program takes any batch, but one shape on the card keeps a
        # row's answer independent of how many neighbours it rode with.
        chunk = np.stack(rows)
        n = len(chunk)
        if n < self.batch:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], self.batch - n, 0)]
            )
        return list(np.asarray(self.fn(chunk))[:n])

    def _serialized(self, rows: np.ndarray) -> list:
        out = []
        for start in range(0, len(rows), self.batch):
            part = list(rows[start : start + self.batch])
            self.stats["device_calls"] += 1
            self.stats["rows"] += len(part)
            out.extend(self._run_rows(part))
        return out

    def predict(self, rows: np.ndarray) -> np.ndarray:
        if rows.ndim != 1 + len(self.row_shape) or (
            rows.shape[1:] != self.row_shape
        ):
            raise ValueError(
                f"input rows must be shaped {('N',) + self.row_shape}, "
                f"got {rows.shape}"
            )
        if not len(rows):
            raise ValueError("need at least one input row")
        rows = rows.astype(self.dtype)
        if self.coalesce:
            return np.stack(self._batcher.submit(list(rows)))
        return np.stack(self._batcher.call(lambda: self._serialized(rows),
                                           rows=len(rows)))

    def close(self) -> None:
        self._batcher.stop()


class _GenerateApp:
    """A generation bundle behind the coalescing worker — or, with
    ``continuous=True``, behind the per-chunk scheduler
    (`serving.engine.ContinuousBatchingEngine`).

    Coalescing (the default): greedy bundles (temperature == 0) coalesce
    rows across concurrent requests, as predict bundles do; sampled
    bundles serialize whole requests under the payload's ``seed``; a
    stream runs one worker call a chunk. Every dispatch holds the app
    lock, which a reload swaps the bundle under. Continuous (streaming
    bundles only): every request row is an independently scheduled
    sequence — admitted into free decode rows mid-flight, retired the
    chunk it finishes, refused with 429 when the wait queue is full.
    Validation and tokenizing run on the handler thread, outside the lock
    and the accounting: a request that can never run is refused at the
    door, not after it holds device capacity.
    """

    kind = "generate"

    def __init__(self, bundle_dir: str, coalesce: bool = True,
                 continuous: bool = False, device="cuda"):
        self.continuous = continuous
        self.device = device
        self._coalesce = coalesce
        self._lock = threading.Lock()
        self.engine = None
        self._batcher = None
        self._load(bundle_dir)

    def _load(self, bundle_dir: str) -> None:
        """(Re)build the app around ``bundle_dir`` — at start, and as the
        ``/admin/reload`` target (on the device worker, under the lock, in
        coalescing mode; with the engine stopped in continuous mode). The
        new bundle captures its own graphs; the old one's are released
        here, on the thread that ran them, before anything else can."""
        bundle = bundle_lib.load_generate(bundle_dir, device=self.device)
        old, self.bundle = getattr(self, "bundle", None), bundle
        if old is not None:
            old.release_graphs()
        self.bundle_dir = bundle_dir
        self.signature = {
            "inputs": {
                "prompt": {
                    "shape": [bundle.batch_size, bundle.prompt_len],
                    "dtype": "int32",
                }
            },
            "outputs": {"tokens": {}},
            "meta": bundle.meta,
        }
        self.stats = {"device_calls": 0, "rows": 0}
        self._coalesce_rows = self._coalesce and float(
            bundle.meta.get("temperature", 0.0)) == 0.0
        if self.continuous:
            self._start_engine()
        elif self._batcher is None:
            self._batcher = _Batcher(self._locked_generate_batch,
                                     bundle.batch_size, self.stats)
        else:
            self._batcher.batch = bundle.batch_size
            self._batcher.stats = self.stats

    def _start_engine(self) -> None:
        self.engine = ContinuousBatchingEngine(
            self.bundle,
            max_seqs=registry.get_int("HVT_SERVE_MAX_SEQS"),
            block_tokens=registry.get_int("HVT_SERVE_BLOCK_TOKENS"),
            kv_blocks=registry.get_int("HVT_SERVE_KV_BLOCKS"),
            queue_depth=registry.get_int("HVT_SERVE_QUEUE_DEPTH"),
        )

    def reload(self, bundle_dir: str) -> None:
        """Swap to the bundle in ``bundle_dir`` in place. Continuous: drain
        the engine (refusing with RuntimeError when it is still busy after
        ``HVT_SERVE_DRAIN_TIMEOUT_S``), stop it, load; submissions wait at
        the lock meanwhile. Coalescing: the load runs on the device worker
        under the lock, so requests queued before it finish on the old
        weights and every later one runs on the new. A bundle that fails
        to load raises, and the old one goes on serving."""
        if self.engine is not None:
            timeout = registry.get_float("HVT_SERVE_DRAIN_TIMEOUT_S")
            with self._lock:
                if not self.engine.drain(timeout):
                    raise RuntimeError(
                        f"engine still busy after {timeout}s drain — "
                        "refusing to swap weights under live sequences"
                    )
                self.engine.stop()
                try:
                    self._load(bundle_dir)
                except Exception:
                    self._start_engine()  # over the old bundle
                    raise
            return

        def swap():
            with self._lock:
                self._load(bundle_dir)

        self._batcher.call(swap)

    def close(self) -> None:
        """Stop the scheduler or the device worker."""
        if self.engine is not None:
            self.engine.stop()
        if self._batcher is not None:
            self._batcher.stop()

    def _locked_generate_batch(self, rows: list) -> list:
        with self._lock:
            return self.bundle.generate_batch(rows)

    def _prompts(self, payload: dict) -> list:
        if "text" in payload and "prompt" in payload:
            raise ValueError("pass 'text' OR 'prompt', not both")
        if "text" in payload:
            texts = payload["text"]
            if not isinstance(texts, list):
                raise ValueError("'text' must be a list of strings")
            if self.bundle.tokenizer is None:
                raise ValueError(
                    "this bundle has no tokenizer — POST token ids under "
                    "'prompt' instead"
                )
            raw = self.bundle.encode_texts(texts)
        else:
            raw = payload["prompt"]
        return self.bundle.validate_prompts(raw)

    def _with_text(self, out: dict) -> dict:
        if self.bundle.tokenizer is not None:
            out["text"] = [self.bundle.tokenizer.decode(g)
                           for g in out["tokens"]]
        return out

    def _submit(self, prompts: list, stream: bool = False) -> list:
        # A continuous reload swaps the engine under this lock.
        with self._lock:
            return [self.engine.submit(p, stream=stream) for p in prompts]

    def _serialized(self, prompts: list, seed: int) -> list:
        with self._lock:
            self.stats["device_calls"] += max(
                1, -(-len(prompts) // self.bundle.batch_size)
            )
            self.stats["rows"] += len(prompts)
            return self.bundle.generate_tokens(prompts, seed=seed)

    def generate(self, payload: dict) -> dict:
        seed = int(payload.get("seed", 0))
        prompts = self._prompts(payload)
        if self.engine is not None:
            reqs = self._submit(prompts)
            tokens = [r.result() for r in reqs]
            self.stats["rows"] += len(prompts)
        elif self._coalesce_rows:
            tokens = self._batcher.submit(prompts)
        else:
            tokens = self._batcher.call(
                lambda: self._serialized(prompts, seed), rows=len(prompts))
        return self._with_text({"tokens": tokens})

    def stream(self, payload: dict):
        """NDJSON lines: one per chunk, then the final ``done`` line.
        Validation runs at the first ``next`` (before headers)."""
        seed = int(payload.get("seed", 0))
        prompts = self._prompts(payload)
        if not prompts:
            raise ValueError("need at least one prompt")
        if self.engine is not None:
            yield from self._engine_stream(prompts)
            return
        if len(prompts) > self.bundle.batch_size:
            raise ValueError(
                f"streaming takes 1..{self.bundle.batch_size} prompts "
                f"per request, got {len(prompts)}"
            )
        # The chunk generator lives in ``held`` and is created, advanced
        # and dropped on the worker: its device state never leaves it.
        held = {}

        def dispatch():
            with self._lock:
                if "it" not in held:
                    held["it"] = self.bundle.stream_chunks(prompts, seed=seed)
                chunk = next(held["it"], None)
                if chunk is not None:
                    self.stats["device_calls"] += 1
                return chunk

        rows = [[] for _ in prompts]
        try:
            while True:
                chunk = self._batcher.call(dispatch, rows=len(prompts))
                if chunk is None:
                    break
                for i, part in enumerate(chunk):
                    rows[i].extend(part)
                yield {"tokens": chunk}
        finally:
            if held:
                self._batcher.call(held.clear)
        self.stats["rows"] += len(prompts)
        yield self._with_text({
            "done": True, "tokens": [self.bundle._trim(r) for r in rows]})

    def _engine_stream(self, prompts: list):
        """Continuous streaming: each prompt row is its own scheduled
        sequence; multi-row requests tag each chunk line with its
        ``row``."""
        reqs = self._submit(prompts, stream=True)
        multi = len(reqs) > 1
        for i, r in enumerate(reqs):
            for piece in r.iter_chunks():
                line = {"tokens": [piece]}
                if multi:
                    line["row"] = i
                yield line
        self.stats["rows"] += len(reqs)
        yield self._with_text({"done": True,
                               "tokens": [r.tokens for r in reqs]})


def _make_app(bundle_dir: str, coalesce: bool = True,
              continuous: bool = False, device="cuda"):
    if bundle_lib.is_generate_bundle(bundle_dir):
        return _GenerateApp(bundle_dir, coalesce=coalesce,
                            continuous=continuous, device=device)
    if continuous:
        raise ValueError(
            "continuous batching serves generation bundles only — "
            f"{bundle_dir} is a predict bundle"
        )
    return _ModelApp(bundle_dir, coalesce=coalesce, device=device)


class BacklogHTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog of 5 resets a burst of
    # concurrent clients before the accept loop reaches them.
    request_queue_size = 128


# The `route` label comes from a CLOSED set: labelling by the raw
# client-supplied path would let any scanner mint unbounded series.
_KNOWN_ROUTES = ("/healthz", "/metrics", "/v1/predict", "/v1/generate",
                 "/admin/reload")


def _route(path: str) -> str:
    path = path.split("?", 1)[0]
    return path if path in _KNOWN_ROUTES else "other"


def make_server(bundle_dir: str, port: int = 0, host: str = "127.0.0.1",
                coalesce: bool = True, continuous: bool = False,
                allow_reload: bool = False, device="cuda"):
    """Build (but don't start) the HTTP server around the bundle in
    ``bundle_dir``, loaded onto ``device``; ``server.server_address``
    carries the bound port when ``port=0``. ``coalesce=False`` keeps the
    serialized baseline; ``continuous=True`` routes ``/v1/generate``
    through the per-chunk scheduler (streaming bundles only);
    ``allow_reload=True`` mounts ``POST /admin/reload`` (opt-in: it lets
    any client point the server at another bundle path).

    ``server.app`` is the bundle's app (``server.app.close()`` stops its
    device worker or scheduler), ``server.metrics_registry`` the server's
    own `obs.Registry` (one per server: several servers in one process
    never share instruments), ``server.inflight_count()`` the POSTs in
    flight (the SIGTERM drain barrier)."""
    app = _make_app(bundle_dir, coalesce=coalesce, continuous=continuous,
                    device=device)
    reg = obs_core.Registry()

    def _collect(r):
        # stats/queue are owned by the app; the scrape mirrors them.
        engine = app.engine
        if engine is not None:
            s = engine.stats()
            r.counter_set(
                "hvt_serve_device_calls_total", s["device_calls_total"]
            )
            r.counter_set("hvt_serve_rows_total", app.stats["rows"])
            r.counter_set("hvt_serve_admitted_total", s["admitted_total"])
            r.counter_set("hvt_serve_retired_total", s["retired_total"])
            r.counter_set("hvt_serve_rejected_total", s["rejected_total"])
            r.gauge("hvt_serve_live_seqs", s["live_seqs"])
            r.gauge("hvt_serve_queue_depth", s["queue_depth"])
            r.gauge("hvt_serve_kv_blocks_used", s["kv_blocks_used"])
            r.gauge("hvt_serve_kv_blocks_free", s["kv_blocks_free"])
            return
        r.counter_set(
            "hvt_serve_device_calls_total", app.stats["device_calls"]
        )
        r.counter_set("hvt_serve_rows_total", app.stats["rows"])
        r.gauge("hvt_serve_queue_depth", app._batcher.q.qsize())

    reg.register_collector(_collect)
    inflight = {"n": 0}
    inflight_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
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

        def log_message(self, *args):  # one line per request is noise
            pass

        def do_GET(self):
            if self.path == "/metrics":
                obs_prom.write_http(self, reg)
            elif self.path == "/healthz":
                with inflight_lock:
                    n_inflight = inflight["n"]
                payload = {"status": "ok", "bundle": app.bundle_dir,
                           "kind": app.kind, "signature": app.signature,
                           "stats": dict(app.stats),
                           "inflight": n_inflight}
                if app.engine is not None:
                    payload["scheduler"] = app.engine.stats()
                self._send(200, payload)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/admin/reload":
                self._handle_reload()
                return
            if (app.kind, self.path) not in (
                ("predict", "/v1/predict"), ("generate", "/v1/generate")
            ):
                self._send(404, {
                    "error": f"no route {self.path} — this server holds a "
                    f"{app.kind} bundle; its route is /v1/{app.kind}"
                })
                return
            # One `request` span per POST (HVT_TRACE_DIR runs): the app
            # nests queue_wait + decode children under it.
            with inflight_lock:
                inflight["n"] += 1
            try:
                with trace_lib.span("request", req=next(_request_ids),
                                    route=_route(self.path)):
                    self._handle_post()
            finally:
                with inflight_lock:
                    inflight["n"] -= 1

        def _handle_reload(self):
            if not allow_reload:
                self._send(404, {"error": "reload not enabled on this "
                                 "server (--allow-reload)"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                new_dir = payload["bundle_dir"]
                if not hasattr(app, "reload"):
                    raise ValueError(
                        f"{app.kind} bundles do not support reload"
                    )
                app.reload(new_dir)
                self._send(200, {"ok": True, "bundle": new_dir})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _handle_post(self):
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                if app.kind == "generate" and payload.get("stream"):
                    self._stream(payload, t0)
                elif app.kind == "generate":
                    out = app.generate(payload)
                    dt = time.perf_counter() - t0
                    reg.histogram("hvt_serve_request_seconds", dt,
                                  route=_route(self.path))
                    # One-shot generation: prefill and every decode step
                    # land together, so TTFT is the whole call and TPOT
                    # its per-token amortization (streams carry the split).
                    n_tokens = sum(len(r) for r in out["tokens"])
                    reg.histogram("hvt_serve_ttft_seconds", dt)
                    if n_tokens:
                        reg.histogram("hvt_serve_tpot_seconds",
                                      dt / n_tokens)
                    self._send(200, out)
                else:
                    prob = app.predict(np.asarray(payload["input"]))
                    reg.histogram(
                        "hvt_serve_request_seconds",
                        time.perf_counter() - t0, route=_route(self.path),
                    )
                    self._send(200, {"prob": prob.tolist()})
            except AdmissionError as e:
                # Back-pressure, not failure: the client retries later.
                self._send(429, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # device/runtime failure -> JSON 500
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, payload: dict, t0: float):
            # NDJSON: no Content-Length; the body is line-delimited JSON,
            # terminated by the connection's close.
            chunks = app.stream(payload)
            first = next(chunks)  # validation runs BEFORE headers
            # TTFT: the first chunk computed and about to flush.
            ttft = time.perf_counter() - t0
            reg.histogram("hvt_serve_ttft_seconds", ttft)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            reg.counter("hvt_serve_requests_total", route=_route(self.path),
                        code="200")
            n_tokens = 0
            try:
                for item in itertools.chain((first,), chunks):
                    if "tokens" in item and not item.get("done"):
                        n_tokens += sum(len(r) for r in item["tokens"])
                    self.wfile.write(json.dumps(item).encode() + b"\n")
                    self.wfile.flush()
                total = time.perf_counter() - t0
                reg.histogram("hvt_serve_request_seconds", total,
                              route=_route(self.path))
                if n_tokens > 1:
                    # Decode tail per token, past the first chunk.
                    reg.histogram("hvt_serve_tpot_seconds",
                                  (total - ttft) / max(1, n_tokens - 1))
            except Exception as e:
                # Headers are out: report in-band; the missing 'done'
                # line tells the client the stream died.
                self.wfile.write(json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}
                ).encode() + b"\n")
                self.wfile.flush()

    server = BacklogHTTPServer((host, port), Handler)
    server.app = app
    server.metrics_registry = reg

    def _inflight_count() -> int:
        with inflight_lock:
            return inflight["n"]

    server.inflight_count = _inflight_count
    return server


def serve_forever(bundle_dir: str, port: int = 8000, host: str = "0.0.0.0",
                  metrics_port: int | None = None, continuous: bool = False,
                  allow_reload: bool = False, device="cuda") -> None:
    """Serve until SIGTERM (drain, then return) or Ctrl-C."""
    import signal

    server = make_server(bundle_dir, port=port, host=host,
                         continuous=continuous, allow_reload=allow_reload,
                         device=device)
    if metrics_port is not None:
        # The same registry on a scrape port of its own; /metrics stays
        # mounted on the main port either way.
        from horovod_tpu_torch.obs import server as obs_server

        obs_server.start_metrics_server(
            metrics_port, registry=server.metrics_registry
        )

    def _graceful(_signum, _frame):
        """SIGTERM = drain-then-exit: finish what is in flight, then stop
        accepting. The shutdown runs on a helper thread: the handler runs
        on the main thread, which is inside serve_forever()."""
        def _drain_and_stop():
            deadline = time.monotonic() + registry.get_float(
                "HVT_SERVE_DRAIN_TIMEOUT_S")
            while server.inflight_count() and time.monotonic() < deadline:
                time.sleep(0.05)
            if server.app.engine is not None:
                server.app.engine.drain(max(0.0, deadline - time.monotonic()))
            server.app.close()
            server.shutdown()

        threading.Thread(target=_drain_and_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    inputs = server.app.signature["inputs"]
    shape = next(iter(inputs.values()))["shape"]
    print(
        f"serving {bundle_dir} ({server.app.kind}) on "
        f"http://{host}:{server.server_address[1]} (input {shape}) on "
        f"{device}" + (" [continuous]" if continuous else ""),
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.app.close()
    finally:
        server.server_close()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "bundle_dir",
        help="a serving bundle dir: checkpoint.export_serving (predict) or "
        "serving.export_generate (generation) — kind auto-detected",
    )
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu runs "
                   "the plain PyTorch path)")
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="N",
        help="ALSO serve this server's Prometheus /metrics on a dedicated "
        "port (loopback by default, HVT_STATUS_HOST to expose)",
    )
    p.add_argument(
        "--continuous", action="store_true",
        help="per-chunk continuous batching (streaming generation bundles "
        "only): admit/retire at every decode chunk, paged-KV admission "
        "control, 429 on exhaustion",
    )
    p.add_argument("--allow-reload", action="store_true",
                   help="mount POST /admin/reload (weight swap in place)")
    for flag in ("--fleet-journal", "--coordinator", "--member"):
        p.add_argument(flag, default=None, help=f"not ported: {_ITEM_13}")
    args = p.parse_args(argv)
    for flag in ("fleet_journal", "coordinator", "member"):
        if getattr(args, flag) is not None:
            p.error(f"--{flag.replace('_', '-')} needs {_ITEM_13}")
    serve_forever(args.bundle_dir, port=args.port, host=args.host,
                  metrics_port=args.metrics_port,
                  continuous=args.continuous,
                  allow_reload=args.allow_reload, device=args.device)


if __name__ == "__main__":
    main()
