"""Platform metric sink — port of `horovod_tpu.metrics`.

``init(sync_tensorboard=True)`` is the reference's ``gradient_utils.
metrics.init`` shim: scalars go to a sink, by default `JsonlSink` at
``$PS_MODEL_PATH/metrics.jsonl`` (the CI loss gate's input), written by
the primary rank only. With ``sync_tensorboard`` the epoch scalars that
`callbacks.ScalarLogger` records are pushed here too.

The reference calls ``metrics.init`` before ``hvd.init()``: until the
rank is known (``runtime.init`` ran, or no launcher set a rendezvous)
pushes are buffered, and the first push after that flushes them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Protocol

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry


class MetricsSink(Protocol):
    def push(self, name: str, value: float, step: int | None = None) -> None: ...
    def close(self) -> None: ...


class NullSink:
    def push(self, name, value, step=None):
        pass

    def close(self):
        pass


class JsonlSink:
    """Appends ``{"name", "value", "step", "wall_time"}`` lines."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a")

    def push(self, name, value, step=None):
        self._fh.write(json.dumps({"name": name, "value": float(value),
                                   "step": step, "wall_time": time.time()})
                       + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


_sink: MetricsSink | None = None
_configured_path: str | None = None
_buffered: list[tuple[str, float, int | None]] = []
_sync_tensorboard = False


def init(sync_tensorboard: bool = False, path: str | None = None) -> None:
    """Configure the JSONL sink (created at the first push once the rank is
    known): ``path``, else ``$HVT_METRICS_DIR`` or ``$PS_MODEL_PATH``
    (default ``./models``) + ``/metrics.jsonl``."""
    global _sink, _configured_path, _sync_tensorboard
    _sink = None
    _sync_tensorboard = bool(sync_tensorboard)
    _configured_path = path or os.path.join(
        registry.get_str("HVT_METRICS_DIR")
        or os.environ.get("PS_MODEL_PATH", "./models"),
        "metrics.jsonl",
    )


def sync_tensorboard_enabled() -> bool:
    return _sync_tensorboard


def _can_decide_primary() -> bool:
    return (runtime.is_initialized()
            or not registry.get_raw(runtime.ENV_COORDINATOR))


def _resolve() -> MetricsSink | None:
    """The active sink, or None while the rank is not known yet."""
    global _sink
    if _sink is None:
        if _configured_path is not None:
            if not _can_decide_primary():
                return None
            _sink = (JsonlSink(_configured_path) if runtime.is_primary()
                     else NullSink())
        else:
            _sink = NullSink()
    return _sink


def push(name: str, value: float, step: int | None = None) -> None:
    sink = _resolve()
    if sink is None:
        _buffered.append((name, float(value), step))
        return
    while _buffered:
        sink.push(*_buffered.pop(0))
    sink.push(name, value, step)


def set_sink(sink: MetricsSink) -> None:
    global _sink, _configured_path
    _sink = sink
    _configured_path = None
