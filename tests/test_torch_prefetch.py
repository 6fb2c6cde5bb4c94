"""`DevicePrefetcher` (`horovod_tpu_torch.data.prefetch`, the port of
`horovod_tpu.data.prefetch`) on the CPU: batches arrive in order as
tensors, an exception of the source re-raises at the matching
``__next__`` and ends the stream, ``close`` releases the thread, and the
depth follows ``HVT_PREFETCH_DEPTH``. The CUDA staging (pinned buffers, a
side stream, an event) runs on the card in ``chip_smoke.py``."""

import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.data import prefetch
from horovod_tpu_torch.data.prefetch import DevicePrefetcher


def _batches(n):
    rng = np.random.RandomState(0)
    for i in range(n):
        yield (rng.randn(3, 2).astype(np.float32), np.full(3, i, np.int64))


def test_order_and_values():
    want = list(_batches(9))
    got = list(DevicePrefetcher(_batches(9), "cpu", depth=2))
    assert len(got) == 9
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert np.array_equal(gx.numpy(), wx)
        assert np.array_equal(gy.numpy(), wy)
    # Nested structures keep their shape; the staging copies.
    src = np.arange(4.0)
    item = next(DevicePrefetcher(iter([[(src,), {"a": src}]]), "cpu"))
    src[:] = -1
    assert isinstance(item, list) and isinstance(item[0], tuple)
    assert item[1]["a"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_exception_reraises_at_its_position_then_ends():
    def source():
        yield from _batches(2)
        raise KeyError("bad batch")

    p = DevicePrefetcher(source(), "cpu", depth=4)
    next(p)
    next(p)
    with pytest.raises(KeyError, match="bad batch"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def test_close_releases_the_thread_and_the_staged_batches():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield np.full(2, i)
            i += 1

    p = DevicePrefetcher(endless(), "cpu", depth=2)
    assert next(p).tolist() == [0, 0]
    deadline = time.monotonic() + 5
    while len(produced) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(produced) <= 4  # bounded by the depth, not free-running
    p.close()
    assert not p._thread.is_alive()
    assert p._q.empty()
    with pytest.raises(StopIteration):
        next(p)
    p.close()  # idempotent


def test_paused_holds_the_staging():
    p = DevicePrefetcher(_batches(50), "cpu", depth=50)
    with p.paused():
        n0 = p._q.qsize()
        time.sleep(0.2)
        assert p._q.qsize() <= n0 + 1  # at most one staged before the lock
    deadline = time.monotonic() + 5
    while p._q.qsize() < 10 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p._q.qsize() >= 10
    p.close()


def test_depth_from_env(monkeypatch):
    monkeypatch.delenv("HVT_PREFETCH_DEPTH", raising=False)
    assert prefetch.default_depth() == 2
    monkeypatch.setenv("HVT_PREFETCH_DEPTH", "5")
    assert prefetch.default_depth() == 5
    p = DevicePrefetcher(_batches(1), "cpu")
    assert p._q.maxsize == 5
    p.close()
