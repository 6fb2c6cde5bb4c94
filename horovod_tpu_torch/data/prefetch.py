"""Background host → device prefetch — port of `horovod_tpu.data.prefetch`.

A `DevicePrefetcher` moves batch staging onto a daemon thread that keeps a
small queue of device-resident batches: while step k computes, batch k + 1
is on its way to the card. On CUDA each array is copied into a pinned host
buffer, then to the card by a non-blocking copy on a side stream; an event
recorded after the copies is what the consumer's stream waits on at
``__next__``, so the step never reads a half-copied batch and the host
never waits for the copy. On the CPU the staging is a plain copy.

Composes with the native batch-assembly engine (`data.native_loader`):
C++ assembles the batch bytes, this thread stages them on the card, the
main thread only launches the steps.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from horovod_tpu_torch.analysis import registry

#: Staged batches kept ahead of the consumer unless ``depth`` says (the
#: knob's registered default).
DEFAULT_DEPTH = registry.knob("HVT_PREFETCH_DEPTH").default


def default_depth() -> int:
    """``HVT_PREFETCH_DEPTH`` (0 or unset: `DEFAULT_DEPTH`, 2 = double
    buffering)."""
    return registry.get_int("HVT_PREFETCH_DEPTH") or DEFAULT_DEPTH


def _map(fn, item):
    """``fn`` over every array of a nested tuple/list/dict batch."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


def _leaves(item):
    if isinstance(item, (tuple, list)):
        for x in item:
            yield from _leaves(x)
    elif isinstance(item, dict):
        for x in item.values():
            yield from _leaves(x)
    else:
        yield item


class DevicePrefetcher:
    """Iterate batches of ``host_iter`` (numpy arrays or tensors, nested
    in tuples/lists/dicts) as tensors on ``device``, staged up to
    ``depth`` ahead by a background thread (default `default_depth`).

    An exception raised by ``host_iter`` or by the staging re-raises in
    the consumer at the matching ``__next__``; the stream then ends.
    ``close()`` (or exhausting it) releases the thread and the staged
    buffers; it does not close ``host_iter``."""

    _DONE = object()

    def __init__(self, host_iter: Iterator, device, depth: int | None = None):
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth or
                                                       default_depth()))
        self._stop = threading.Event()
        self._staging = threading.Lock()
        self._finished = False
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._produce,
                                        args=(host_iter,), daemon=True)
        self._thread.start()

    def _put_leaf(self, a):
        if self._stream is None:
            return torch.tensor(np.asarray(a)) if not isinstance(
                a, torch.Tensor) else a.clone()
        host = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if host.device.type == "cpu":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _stage(self, item):
        if self._stream is None:
            return _map(self._put_leaf, item), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            staged = _map(self._put_leaf, item)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _enqueue(self, item) -> None:
        # A timed put, so close() never strands the producer on a full
        # queue that nobody drains.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self, host_iter) -> None:
        try:
            for item in host_iter:
                if self._stop.is_set():
                    return
                with self._staging:
                    staged = self._stage(item)
                self._enqueue(staged)
            self._enqueue(self._DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            self._enqueue(e)
            self._enqueue(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._finished = True
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            # The side stream allocated these: keep the allocator from
            # reusing their memory before the consumer's work is done.
            for t in _leaves(staged):
                t.record_stream(consumer)
        return staged

    @contextlib.contextmanager
    def paused(self):
        """No staging runs while the block does: a CUDA-graph capture
        must see no other thread's CUDA calls."""
        with self._staging:
            yield

    def close(self) -> None:
        """Stop the thread and drop the staged batches (idempotent)."""
        self._stop.set()
        self._drain()  # unblocks a producer waiting on a full queue
        self._thread.join(timeout=5)
        self._drain()  # what it put while the first drain ran
        self._finished = True

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
