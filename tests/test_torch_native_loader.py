"""The native batch-assembly engine in the port (`data/native_loader.py`
over its own copy of the C++ source) against the JAX package's
`NativeBatchLoader`: batch for batch, byte for byte, with ``skip``,
``start_epoch`` and ``batches_per_epoch``; and `training_pipeline`'s
engine rule and ``engine_out`` against JAX's. g++ builds the library
here at first use."""

import os
import time

import numpy as np
import pytest

from horovod_tpu.data import loader as jloader
from horovod_tpu.data import native_loader as jnative
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.data import native_loader as tnative

# The JAX package builds `native/libhvt_data.so` in place at first use,
# with no lock, and a process whose load meets another test process's
# build half-written marks the native engine unavailable for the rest of
# its life (`native_loader._load_failed`). Its side then runs the python
# engine and every comparison with the native one fails. Before this
# module's tests, wait for that library: retry a bounded number of times
# with the flag cleared (a concurrent build has finished by then), then
# require it. A real build failure still fails here.
_JAX_NATIVE_TRIES = 60
_JAX_NATIVE_WAIT_S = 1.0


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    from horovod_tpu.analysis import registry
    from horovod_tpu.data import native_loader as jax_native

    if not registry.get_flag("HVT_NO_NATIVE"):
        for _ in range(_JAX_NATIVE_TRIES):
            if jax_native.available():
                break
            time.sleep(_JAX_NATIVE_WAIT_S)
            jax_native._load_failed = False
        assert jax_native.available(), (
            "the JAX package's native library does not load "
            "(native/libhvt_data.so)"
        )
    yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(n=53):
    rng = np.random.RandomState(4)
    return (rng.randn(n, 3, 2).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64),
            rng.randint(0, 255, (n, 5)).astype(np.uint8))


def test_source_is_the_reference_copy_and_builds():
    with open(os.path.join(REPO, "native", "hvt_data.cc"), "rb") as f:
        want = f.read()
    with open(tnative.SOURCE, "rb") as f:
        assert f.read() == want
    assert tnative.available()
    path = tnative.library_path()
    assert os.path.exists(path)
    assert path.startswith(os.path.join(REPO, "build", "horovod_tpu_torch"))


@pytest.mark.parametrize("batch,seed,start,bpe,skip,shuffle", [
    (4, 0, 0, 0, 0, True),
    (4, 7, 2, 20, 3, True),       # anchored, cut epochs spanning passes
    (5, 123, 1, 0, 11, True),     # one pass per epoch, skip across passes
    (53, 9, 0, 4, 0, True),       # a batch of the whole data
    (6, 3, 0, 0, 2, False),       # no shuffle
], ids=["plain", "anchored-skip", "pass-epochs", "whole", "unshuffled"])
def test_batches_byte_identical_to_jax(batch, seed, start, bpe, skip,
                                       shuffle):
    arrays = _arrays()
    t = tnative.NativeBatchLoader(arrays, batch, seed=seed, shuffle=shuffle,
                                  start_epoch=start, batches_per_epoch=bpe)
    j = jnative.NativeBatchLoader(arrays, batch, seed=seed, shuffle=shuffle,
                                  start_epoch=start, batches_per_epoch=bpe)
    try:
        t.skip(skip)
        j.skip(skip)
        for _ in range(40):
            got, want = next(t), next(j)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    finally:
        t.close()
        j.close()


def test_views_close_and_errors():
    arrays = _arrays()
    loader = tnative.NativeBatchLoader(arrays, 4, seed=1, copy=False)
    view = next(loader)[0]
    assert not view.flags.owndata
    loader.close()
    loader.close()  # idempotent
    with pytest.raises(StopIteration):
        next(loader)
    with pytest.raises(RuntimeError, match="closed"):
        loader.skip(1)
    with pytest.raises(ValueError, match="batch_size"):
        tnative.NativeBatchLoader(arrays, 54)
    with pytest.raises(ValueError, match="leading"):
        tnative.NativeBatchLoader((arrays[0], arrays[1][:3]), 2)


@pytest.mark.parametrize("kw,engine", [
    (dict(), "native"),
    (dict(shuffle_buffer=53), "native"),
    (dict(shuffle_buffer=10), "python"),   # a bounded reservoir shuffle
    (dict(start_epoch=3, skip_batches=5, batches_per_epoch=7), "native"),
], ids=["default", "buffer-covers", "reservoir", "anchored"])
def test_training_pipeline_engine_rule_matches_jax(kw, engine):
    arrays = _arrays()
    got_engine, want_engine = {}, {}
    t_it, t_close = tloader.training_pipeline(arrays, 4, seed=5,
                                              engine_out=got_engine, **kw)
    j_it, j_close = jloader.training_pipeline(arrays, 4, seed=5,
                                              engine_out=want_engine, **kw)
    try:
        assert got_engine == want_engine == {"engine": engine}
        for _ in range(30):
            for a, b in zip(next(t_it), next(j_it)):
                assert a.tobytes() == b.tobytes()
    finally:
        t_close()
        j_close()


def test_no_native_flag_takes_the_python_engine(monkeypatch):
    """``HVT_NO_NATIVE=1`` is read at the call (the library may be loaded
    already): the python engine, as in JAX."""
    monkeypatch.setenv("HVT_NO_NATIVE", "1")
    arrays = _arrays()
    out = {}
    it, close = tloader.training_pipeline(arrays, 4, seed=2, engine_out=out)
    assert out == {"engine": "python"}
    jit, jclose = jloader.training_pipeline(arrays, 4, seed=2)
    for _ in range(20):
        for a, b in zip(next(it), next(jit)):
            assert np.array_equal(a, b)
    close()
    jclose()
