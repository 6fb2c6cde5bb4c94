"""HTTP generation server over the continuous-batching engine — port of
`horovod_tpu.launch.serve` for generation bundles in continuous mode.

Endpoints (JSON):

* ``GET  /healthz`` → ``{"status": "ok", "bundle": ..., "kind":
  "generate", "signature": ..., "stats": ..., "scheduler": ...}``;
* ``POST /v1/generate`` body ``{"prompt": [[ids...], ...]}`` or, when the
  bundle carries a tokenizer, ``{"text": ["...", ...]}`` →
  ``{"tokens": [[ids...], ...]}`` (plus ``"text"``: the detokenized
  generations, with a tokenizer);
* ``POST /v1/generate`` with ``"stream": true`` → ``application/x-ndjson``:
  one ``{"tokens": [[ids...]]}`` line per generated chunk (tagged with
  ``"row"`` for multi-row requests), then ``{"done": true, "tokens": ...}``
  (with ``"text"`` when the bundle has a tokenizer).

Every prompt row is its own scheduled sequence in the engine: admitted
into free decode rows mid-flight, retired the chunk it finishes. A full
wait queue answers 429; a prompt the bundle cannot serve answers 400, as
do ``text`` without a tokenizer and ``text`` beside ``prompt``.
The engine is sized by ``HVT_SERVE_MAX_SEQS`` / ``HVT_SERVE_BLOCK_TOKENS``
/ ``HVT_SERVE_KV_BLOCKS`` / ``HVT_SERVE_QUEUE_DEPTH`` (the JAX server's
knobs and defaults).

Not in this slice (ROADMAP queue A item 10, the server half): predict
bundles, the coalescing mode, ``/admin/reload``, fleet membership and
``/metrics``.

Run: ``python -m horovod_tpu_torch.launch.serve <bundle_dir> [--port 8000]
[--device cuda]`` (tests use `make_server` + a background thread).
"""

from __future__ import annotations

import itertools
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from horovod_tpu_torch import trace as trace_lib
from horovod_tpu_torch.serving import bundle as bundle_lib
from horovod_tpu_torch.serving.engine import (
    AdmissionError,
    ContinuousBatchingEngine,
)

_request_ids = itertools.count(1)

_KNOBS = {
    "HVT_SERVE_MAX_SEQS": 0,
    "HVT_SERVE_BLOCK_TOKENS": 16,
    "HVT_SERVE_KV_BLOCKS": 0,
    "HVT_SERVE_QUEUE_DEPTH": 64,
}


def _knob(name: str) -> int:
    return int(os.environ.get(name) or _KNOBS[name])


class _GenerateApp:
    """A streaming generation bundle behind the continuous-batching
    engine."""

    kind = "generate"

    def __init__(self, bundle_dir: str, device="cuda"):
        if not bundle_lib.is_generate_bundle(bundle_dir):
            raise ValueError(f"{bundle_dir} is not a generation bundle")
        self.bundle_dir = bundle_dir
        self.bundle = bundle_lib.load_generate(bundle_dir, device=device)
        self.signature = {
            "inputs": {
                "prompt": {
                    "shape": [self.bundle.batch_size, self.bundle.prompt_len],
                    "dtype": "int32",
                }
            },
            "outputs": {"tokens": {}},
            "meta": self.bundle.meta,
        }
        self.stats = {"rows": 0}
        self.engine = ContinuousBatchingEngine(
            self.bundle,
            max_seqs=_knob("HVT_SERVE_MAX_SEQS"),
            block_tokens=_knob("HVT_SERVE_BLOCK_TOKENS"),
            kv_blocks=_knob("HVT_SERVE_KV_BLOCKS"),
            queue_depth=_knob("HVT_SERVE_QUEUE_DEPTH"),
        )

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
        prompts = self.bundle.validate_prompts(raw)
        if not prompts:
            raise ValueError("need at least one prompt")
        return prompts

    def _with_text(self, out: dict) -> dict:
        if self.bundle.tokenizer is not None:
            out["text"] = [self.bundle.tokenizer.decode(g)
                           for g in out["tokens"]]
        return out

    def generate(self, payload: dict) -> dict:
        reqs = [self.engine.submit(p) for p in self._prompts(payload)]
        tokens = [r.result() for r in reqs]
        self.stats["rows"] += len(reqs)
        return self._with_text({"tokens": tokens})

    def stream(self, payload: dict):
        """NDJSON lines: one per delivered chunk, then the final ``done``
        line. Validation runs at the first ``next`` (before headers)."""
        reqs = [
            self.engine.submit(p, stream=True)
            for p in self._prompts(payload)
        ]
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


def make_server(bundle_dir: str, port: int = 0, host: str = "127.0.0.1",
                device="cuda"):
    """Build (but don't start) the HTTP server around a streaming
    generation bundle loaded onto ``device``; ``server.server_address``
    carries the bound port when ``port=0``. ``server.app.engine.stop()``
    ends the scheduler thread."""
    app = _GenerateApp(bundle_dir, device=device)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # one line per request is noise
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok", "bundle": app.bundle_dir,
                    "kind": app.kind, "signature": app.signature,
                    "stats": dict(app.stats),
                    "scheduler": app.engine.stats(),
                })
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {
                    "error": f"no route {self.path} — this server holds a "
                    "generate bundle; its route is /v1/generate"
                })
                return
            with trace_lib.span("request", req=next(_request_ids),
                                route=self.path):
                self._handle_post()

        def _handle_post(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                if not payload.get("stream"):
                    self._send(200, app.generate(payload))
                    return
                chunks = app.stream(payload)
                first = next(chunks)  # validation runs BEFORE headers
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                try:
                    for item in itertools.chain((first,), chunks):
                        self.wfile.write(json.dumps(item).encode() + b"\n")
                        self.wfile.flush()
                except Exception as e:
                    # Headers are out: report in-band; the missing 'done'
                    # line tells the client the stream died.
                    self.wfile.write(json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode() + b"\n")
                    self.wfile.flush()
            except AdmissionError as e:
                self._send(429, {"error": str(e)})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # device/runtime failure -> JSON 500
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.app = app
    return server


def serve_forever(bundle_dir: str, port: int = 8000, host: str = "0.0.0.0",
                  device="cuda") -> None:
    server = make_server(bundle_dir, port=port, host=host, device=device)
    print(
        f"serving {bundle_dir} (generate, continuous) on "
        f"http://{host}:{server.server_address[1]} on {device}",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.app.engine.stop()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bundle_dir", help="a streaming generation bundle "
                   "(horovod_tpu_torch.serving.export_generate)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu runs "
                   "the plain PyTorch path)")
    args = p.parse_args(argv)
    serve_forever(args.bundle_dir, port=args.port, host=args.host,
                  device=args.device)


if __name__ == "__main__":
    main()
