"""Structured trace spans — the part of `horovod_tpu.trace` the serving
engine uses (`span`, `emit_span`).

With ``HVT_TRACE_DIR`` set, each span is one JSON line in
``$HVT_TRACE_DIR/spans-rank0-pid<pid>.jsonl`` with the JAX package's
record schema (name, ts, dur_s, rank, pid, host, id, parent, depth plus
caller attributes), so the same timeline tools read both. Unset, every
call is a no-op. Single process in this slice, so the rank is 0.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time

from horovod_tpu_torch.analysis import registry


def span_dir() -> str | None:
    """The ``HVT_TRACE_DIR`` target, or None when spans are off."""
    return registry.get_str("HVT_TRACE_DIR")


class _SpanWriter:
    """This process's span file (lazy, thread-safe). A write error turns
    the writer off and counts the dropped spans: tracing never takes the
    server down."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fh = None
        self._dead = False
        self._seq = 0
        self._tls = threading.local()
        self.drops = 0

    def stack(self) -> list:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def next_id(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def write(self, record: dict) -> None:
        with self._lock:
            if self._dead:
                self.drops += 1
                return
            try:
                if self._fh is None:
                    d = span_dir()
                    os.makedirs(d, exist_ok=True)
                    self._fh = open(
                        os.path.join(d, f"spans-rank0-pid{os.getpid()}.jsonl"),
                        "a",
                    )
                self._fh.write(json.dumps(record) + "\n")
                self._fh.flush()
            except OSError:
                self._dead = True
                self.drops += 1


_writer = _SpanWriter()
_HOST = socket.gethostname() or "unknown"


def _record(name: str, ts: float, dur_s: float, sid: int, parent, depth,
            attrs: dict) -> dict:
    # Core fields LAST so a caller attribute can never clobber the schema.
    return {
        **attrs, "name": name, "ts": ts, "dur_s": dur_s, "rank": 0,
        "pid": os.getpid(), "host": _HOST, "id": sid, "parent": parent,
        "depth": depth,
    }


def emit_span(name: str, ts: float, dur_s: float, **attrs) -> None:
    """One span record with caller-supplied timings (an interval measured
    where the ``with`` form cannot sit). Parent/depth come from the
    calling thread's open spans."""
    if not span_dir():
        return
    stack = _writer.stack()
    _writer.write(_record(
        name, ts, dur_s, _writer.next_id(), stack[-1] if stack else None,
        len(stack), attrs,
    ))


@contextlib.contextmanager
def span(name: str, **attrs):
    """``with trace.span('decode', rows=3): ...`` — one record on exit,
    nesting tracked per thread."""
    if not span_dir():
        yield
        return
    stack = _writer.stack()
    sid = _writer.next_id()
    parent = stack[-1] if stack else None
    stack.append(sid)
    t0, p0 = time.time(), time.perf_counter()
    try:
        yield
    finally:
        stack.pop()
        _writer.write(_record(
            name, t0, time.perf_counter() - p0, sid, parent, len(stack),
            attrs,
        ))
