"""`ContinuousBatchingEngine`: the per-decode-step scheduler — port of
`horovod_tpu.serving.engine` (same admit → step → retire tick).

A coalescing queue (the JAX package's `launch/serve.py` `_Batcher`)
dispatches a batch and holds every row hostage until the SLOWEST one finishes — a
long generation in row 0 is pure tail latency for the short request that
landed in row 3, and a request arriving one tick late waits a full
batch-generation for the next flush. This engine schedules at CHUNK
granularity instead (vLLM's continuous batching, arXiv 2309.06180,
restated over a static-shape batched decoder):

* every tick, finished rows retire IMMEDIATELY (their KV blocks return
  to the allocator, their slot frees);
* waiting sequences admit into free slots the same tick — one prefill
  dispatch splices their rows into the live state
  (`decoder.ChunkedBundleDecoder.splice`) without stopping the batch;
* one ``cont`` dispatch then advances every live row by one chunk.

Admission is gated by the paged KV accounting (`blocks.BlockAllocator`):
a sequence enters only when its whole-lifetime block reservation fits,
waits in a bounded FIFO otherwise (strict FIFO — the head never starves
behind smaller latecomers), and overflows as `AdmissionError` (HTTP 429)
once the queue is full. The engine never OOMs mid-decode; it says no at
the door.

Threading: handler threads call `submit` (cheap: validate, reserve a
queue position, wake the scheduler); ONE scheduler thread runs `tick`
(admit → step → retire) and is the only mutator of the live decode
state and the slot table, so the hot path needs no lock around device
dispatches. `tick` is public and the thread optional
(``start_thread=False``) — the scheduler unit tests drive ticks by hand.

Observability: each tick emits a ``decode`` span with a ``step`` child
carrying admitted/evicted counts (hvt-trace attributes TTFT tail to
scheduling vs compute), plus a caller-timed ``queue_wait`` span per
admission (`horovod_tpu_torch.trace`, on when ``HVT_TRACE_DIR`` is set).
`stats()` carries the counters the server's ``/healthz`` reports.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

from horovod_tpu_torch import trace as trace_lib
from horovod_tpu_torch.serving.blocks import BlockAllocator, OutOfBlocksError
from horovod_tpu_torch.serving.decoder import ChunkedBundleDecoder


class AdmissionError(RuntimeError):
    """Wait queue full — the HTTP layer maps this to 429."""


class SeqRequest:
    """One submitted sequence: the handle a handler thread holds.

    ``iter_chunks()`` yields trimmed token-id lists as the scheduler
    delivers them (the streaming path); ``result(timeout)`` blocks for
    the full trimmed generation. Timestamps (`submitted`, `first_token`,
    `finished`) are engine-stamped monotonic clocks for TTFT/TPOT.
    """

    _SENTINEL = None

    def __init__(self, prompt, stream: bool):
        self.prompt = prompt
        self.stream = stream
        self.tokens: list[int] = []  # trimmed — eos and after never enter
        self.chunks_done = 0
        self.eos_seen = False
        self.table = None  # BlockTable once reserved
        self.slot = None  # live batch row once admitted
        self.error: Exception | None = None
        self.submitted = time.monotonic()
        self.first_token: float | None = None
        self.finished: float | None = None
        self._done = threading.Event()
        self._chunks: queue.Queue = queue.Queue()

    def _deliver(self, piece: list[int]) -> None:
        if piece:
            if self.first_token is None:
                self.first_token = time.monotonic()
            self.tokens.extend(piece)
            if self.stream:
                self._chunks.put(piece)

    def _finish(self, error: Exception | None = None) -> None:
        self.error = error
        self.finished = time.monotonic()
        self._chunks.put(self._SENTINEL)
        self._done.set()

    def result(self, timeout: float | None = None) -> list[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in flight")
        if self.error is not None:
            raise self.error
        return self.tokens

    def iter_chunks(self):
        while True:
            piece = self._chunks.get()
            if piece is self._SENTINEL:
                if self.error is not None:
                    raise self.error
                return
            yield piece


class ContinuousBatchingEngine:
    """Admit/step/retire scheduler over one streaming bundle.

    ``max_seqs`` caps live rows (0 → the bundle's batch size);
    ``kv_blocks`` sizes the paged-KV budget (0 → exactly enough for
    ``max_seqs`` worst-case sequences — the knob exists to be set LOWER,
    making admission the memory gate); ``queue_depth`` bounds the wait
    queue (beyond it: 429). Per-request seeds are not honored — the
    decode state carries ONE rng for the whole batch (see
    decoder module docstring); ``seed`` salts every prefill via the
    admission counter.
    """

    def __init__(
        self,
        bundle,
        *,
        max_seqs: int = 0,
        block_tokens: int = 16,
        kv_blocks: int = 0,
        queue_depth: int = 64,
        seed: int = 0,
        start_thread: bool = True,
    ):
        self.decoder = ChunkedBundleDecoder(bundle)
        b = self.decoder.batch_size
        self.max_seqs = min(max_seqs, b) if max_seqs > 0 else b
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.queue_depth = queue_depth
        self.seed = seed
        worst = self.decoder.prompt_len + self.decoder.max_new_tokens
        if kv_blocks <= 0:
            kv_blocks = self.max_seqs * (
                -(-worst // block_tokens)
            )
        self.allocator = BlockAllocator(kv_blocks, block_tokens)
        self._slots: list[SeqRequest | None] = [None] * self.max_seqs
        self._state = None  # live decode pytree; scheduler-thread-only
        self._wait: collections.deque[SeqRequest] = collections.deque()
        self._cond = threading.Condition()
        self._admissions = 0  # monotone; salts each prefill's rng
        self._stop = False
        self._stats = {
            "admitted_total": 0,
            "retired_total": 0,
            "rejected_total": 0,
            "device_calls_total": 0,
            "prefill_calls_total": 0,
        }
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._loop, name="hvt-serve-engine", daemon=True
            )
            self._thread.start()

    # -- handler-thread surface ------------------------------------------

    def submit(self, prompt, *, stream: bool = False) -> SeqRequest:
        """Validate and enqueue one prompt. Raises ``ValueError`` for a
        prompt the bundle can never serve (HTTP 400) and
        `AdmissionError` when the wait queue is full (HTTP 429)."""
        prompt = self.decoder.bundle.validate_prompts([prompt])[0]
        # A sequence larger than the WHOLE block budget can never admit —
        # reject now (400) instead of queueing forever.
        need = len(prompt) + self.decoder.max_new_tokens
        if self.allocator.blocks_for(need) > self.allocator.num_blocks:
            raise ValueError(
                f"sequence needs {self.allocator.blocks_for(need)} KV "
                f"blocks, budget is {self.allocator.num_blocks} — raise "
                "HVT_SERVE_KV_BLOCKS or shorten the request"
            )
        req = SeqRequest(prompt, stream)
        with self._cond:
            if len(self._wait) >= self.queue_depth:
                self._stats["rejected_total"] += 1
                raise AdmissionError(
                    f"serving queue full ({self.queue_depth} waiting) — "
                    "retry with backoff"
                )
            self._wait.append(req)
            self._cond.notify()
        return req

    def stats(self) -> dict:
        """Point-in-time counters + gauges for the scrape collector."""
        with self._cond:
            live = sum(1 for s in self._slots if s is not None)
            out = dict(self._stats)
            out.update(
                live_seqs=live,
                queue_depth=len(self._wait),
                kv_blocks_free=self.allocator.free_blocks,
                kv_blocks_used=self.allocator.used_blocks,
                kv_blocks_total=self.allocator.num_blocks,
            )
        return out

    def drain(self, timeout: float) -> bool:
        """Wait until no sequence is live or waiting (the reload and
        SIGTERM barrier). Returns False on timeout — callers decide."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._has_work():
                    return True
            time.sleep(0.005)
        with self._cond:
            return not self._has_work()

    def stop(self) -> None:
        """Stop the scheduler thread; in-flight sequences fail out."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
        err = RuntimeError("serving engine stopped")
        with self._cond:
            doomed = [s for s in self._slots if s is not None]
            doomed += list(self._wait)
            self._wait.clear()
            self._slots = [None] * self.max_seqs
        for r in doomed:
            if r.table is not None and not r.table.freed:
                self.allocator.free(r.table)
            r._finish(err)

    # -- scheduler thread -------------------------------------------------

    def _has_work(self) -> bool:
        return bool(self._wait) or any(
            s is not None for s in self._slots
        )

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._has_work():
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
            self.tick()

    def tick(self) -> dict:
        """One scheduling step: admit → step → retire. Returns counts
        (the unit tests' observable). Scheduler-thread only."""
        with self._cond:
            live0 = sum(1 for s in self._slots if s is not None)
        with trace_lib.span("decode", rows=live0):
            t0w, t0p = time.time(), time.perf_counter()
            admitted = self._admit()
            self._step()
            evicted = self._retire()
            with self._cond:
                live = sum(1 for s in self._slots if s is not None)
            # The `step` child hvt-trace keys on: was this tick's time
            # scheduling churn (admitted/evicted) or steady compute?
            trace_lib.emit_span(
                "step", t0w, time.perf_counter() - t0p,
                admitted=admitted, evicted=evicted, live=live,
            )
        return {"admitted": admitted, "evicted": evicted, "live": live}

    def _admit(self) -> int:
        """Move waiting sequences into free slots, strict FIFO, as far
        as slots AND blocks allow; one prefill dispatch splices them in
        and delivers their first chunk (the TTFT edge)."""
        batch: list[SeqRequest] = []
        slots: list[int] = []
        with self._cond:
            free = [i for i, s in enumerate(self._slots) if s is None]
            while self._wait and free:
                head = self._wait[0]
                need = len(head.prompt) + self.decoder.max_new_tokens
                try:
                    head.table = self.allocator.reserve(need)
                except OutOfBlocksError:
                    break  # head waits for retirements; FIFO holds
                self._wait.popleft()
                head.slot = free.pop(0)
                batch.append(head)
                slots.append(head.slot)
                self._slots[head.slot] = head
        if not batch:
            return 0
        admission = self._admissions
        self._admissions += 1
        tokens, fresh = self.decoder.prefill(
            [r.prompt for r in batch], self.seed, admission
        )
        if self._state is None:
            # First admission: the fresh state IS the live state, but the
            # requests sit in fresh rows 0..n-1 — move them to their slots
            # through the same splice path (src != dst in general).
            self._state = fresh
            src_extra = list(range(len(batch)))
            if slots != src_extra:
                self._state = self.decoder.splice(
                    fresh, fresh, src_extra, slots
                )
        else:
            self._state = self.decoder.splice(
                self._state, fresh, list(range(len(batch))), slots
            )
        self._stats["prefill_calls_total"] += 1
        self._stats["device_calls_total"] += 1
        now = time.time()
        for i, r in enumerate(batch):
            trace_lib.emit_span(
                "queue_wait",
                now - (time.monotonic() - r.submitted),
                time.monotonic() - r.submitted,
                slot=r.slot,
            )
            r.chunks_done = 1
            r._deliver(self._trimmed(r, tokens[i].tolist()))
            self._stats["admitted_total"] += 1
        return len(batch)

    def _step(self) -> bool:
        """One cont dispatch advances every live row by one chunk."""
        with self._cond:
            live = [
                (i, s) for i, s in enumerate(self._slots) if s is not None
            ]
        if not live or self._state is None:
            return False
        tokens, self._state = self.decoder.step(self._state)
        self._stats["device_calls_total"] += 1
        for slot, r in live:
            r.chunks_done += 1
            r._deliver(self._trimmed(r, tokens[slot].tolist()))
        return True

    def _trimmed(self, r: SeqRequest, piece: list[int]) -> list[int]:
        """Cut the chunk at eos (host-side mirror of the device done
        flag) so clients only ever see real generation."""
        if r.eos_seen:
            return []
        eos = self.decoder.eos_id
        if eos is not None and eos in piece:
            r.eos_seen = True
            return piece[: piece.index(eos)]
        return piece

    def _retire(self) -> int:
        """Free finished rows — same tick they finish. Their KV blocks
        return to the allocator; next tick's _admit can reuse both."""
        retired = 0
        with self._cond:
            live = [
                (i, s) for i, s in enumerate(self._slots) if s is not None
            ]
        for slot, r in live:
            if r.eos_seen or r.chunks_done >= self.decoder.total_chunks:
                with self._cond:
                    self._slots[slot] = None
                self.allocator.free(r.table)
                self._stats["retired_total"] += 1
                r._finish()
                retired += 1
        return retired
