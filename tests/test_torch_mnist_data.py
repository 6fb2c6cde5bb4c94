"""The MNIST data path against the JAX package: the synthetic MNIST arrays
byte for byte, `ArrayDataset` batch for batch (the JAX class is the python
engine), and the batches `Trainer.fit(x=, y=)` trains on against JAX's
``training_pipeline`` on each engine: under ``HVT_NO_NATIVE=1`` (the python
engine) and by default (the native C++ engine, which g++ builds here). All
comparisons are exact.
"""

import functools
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as ht
from horovod_tpu.data import datasets as jdata
from horovod_tpu.data import loader as jloader
from horovod_tpu.data import stream as jstream
from horovod_tpu_torch import runtime
from horovod_tpu_torch.data import datasets as tdata
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.data import stream as tstream

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


def test_mnist_is_byte_identical(tmp_path):
    want = jdata.mnist(cache_dir=str(tmp_path / "jax"))
    got = tdata.mnist(cache_dir=str(tmp_path / "torch"))
    for (a, b), (c, d) in zip(got, want):
        for u, v in ((a, c), (b, d)):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert np.array_equal(u, v)
    assert got[0][0].shape == (60000, 28, 28) and got[1][0].shape == (10000, 28, 28)
    assert got[0][0].dtype == np.uint8 and got[0][1].dtype == np.int64
    # The cache is read back (the keras npz contract), JAX's file included.
    again = tdata.mnist(cache_dir=str(tmp_path / "jax"))
    assert np.array_equal(again[1][0], want[1][0])


def test_mnist_cache_default_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv("HVT_DATA_DIR", str(tmp_path))
    x = np.zeros((2, 28, 28), np.uint8)
    y = np.arange(2, dtype=np.int64)
    np.savez(tmp_path / "mnist-1.npz", x_train=x, y_train=y, x_test=x[:1],
             y_test=y[:1])  # a real keras-layout file is read as it is
    (xt, yt), (xe, ye) = tdata.mnist(path="mnist-1.npz")
    assert xt.shape == (2, 28, 28) and list(ye) == [0]
    assert tdata.DEFAULT_DATA_DIR == "~/.cache/horovod_tpu"


@pytest.mark.parametrize("seed,epoch,pass_", [(0, 0, 0), (7, 3, 1),
                                              (2**33 + 5, 40, 2)])
def test_epoch_seed_matches_jax(seed, epoch, pass_):
    assert tstream.epoch_seed(seed, epoch, pass_) == jstream.epoch_seed(
        seed, epoch, pass_)


def _arrays(n=50):
    rng = np.random.RandomState(3)
    return (rng.randn(n, 2, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


def _pipe(mod, arrays, shard=None, shuffle=None, batch=4, repeat=True,
          drop=True, seed=5):
    ds = mod.ArrayDataset(arrays)
    if shard:
        ds = ds.shard(*shard)
    if repeat:
        ds = ds.repeat()
    if shuffle:
        ds = ds.shuffle(shuffle, seed=seed)
    return ds.batch(batch, drop_remainder=drop)


def _assert_same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w) and len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw,skip,start,bpe", [
    ({"shuffle": 8}, 0, 0, None),            # reservoir (buffer < n)
    ({"shuffle": 64}, 0, 0, None),           # full permutation (buffer ≥ n)
    ({"shuffle": 8, "shard": (1, 3)}, 0, 0, None),
    ({"shuffle": 8}, 5, 2, None),            # skip + start_epoch
    ({"shuffle": 64, "shard": (0, 2)}, 3, 1, 4),  # anchored epochs
    ({"shuffle": 8, "batch": 7}, 2, 0, 9),   # passes straddle an epoch
    ({}, 0, 0, None),                        # no shuffle
    ({"repeat": False, "drop": False, "shuffle": 8, "batch": 7}, 0, 0, None),
    ({"repeat": False, "drop": False, "batch": 7}, 6, 0, None),
], ids=["reservoir", "full", "shard", "skip-start", "anchored", "straddle",
        "plain", "remainder", "remainder-skip"])
def test_array_dataset_batches_match_jax(kw, skip, start, bpe):
    arrays = _arrays()
    t = _pipe(tloader, arrays, **kw)
    j = _pipe(jloader, arrays, **kw)
    n = 30
    tb = t.batches(skip=skip, start_epoch=start, batches_per_epoch=bpe)
    jb = j.batches(skip=skip, start_epoch=start, batches_per_epoch=bpe)
    _assert_same([b for _, b in zip(range(n), tb)],
                 [b for _, b in zip(range(n), jb)])


def test_reshard_and_take_match_jax():
    arrays = _arrays()
    t = _pipe(tloader, arrays, shard=(0, 2), shuffle=8).reshard(2, 3)
    j = _pipe(jloader, arrays, shard=(0, 2), shuffle=8).reshard(2, 3)
    assert t.shard_spec == j.shard_spec == (2, 3)
    assert t.num_examples == j.num_examples == 16
    _assert_same(t.take(12), j.take(12))
    single = tloader.ArrayDataset(arrays[0]).batch(5)
    assert single.take(1)[0].shape == (5, 2, 3)
    with pytest.raises(ValueError):
        tloader.ArrayDataset((arrays[0], arrays[1][:3]))
    with pytest.raises(ValueError):
        tloader.ArrayDataset(arrays).shard(3, 3)


class _Recorder(torch.nn.Module):
    """A linear model that records every training batch it sees."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(6, 10)
        self.seen = []

    def forward(self, x, *, train=False, dropout_seed=None):
        if train:
            self.seen.append(x.numpy().copy())
        return self.lin(x.reshape(len(x), -1))


def _fit_batches(monkeypatch, rank, size, **fit_kw):
    monkeypatch.setattr(runtime, "rank", lambda: rank)
    monkeypatch.setattr(runtime, "size", lambda: size)
    model = _Recorder()
    opt = ht.DistributedOptimizer(
        functools.partial(torch.optim.SGD, lr=0.01),
        backward_passes_per_step=fit_kw.pop("K", 1))
    trainer = ht.Trainer(model, opt, seed=11, device="cpu")
    x, y = _arrays(53)
    trainer.fit(x=x, y=y, verbose=0, **fit_kw)
    return model.seen, x, y


@pytest.mark.parametrize("rank,size,kw,K", [
    (0, 1, dict(batch_size=4, epochs=3), 1),
    (1, 2, dict(batch_size=4, epochs=2, steps_per_epoch=5), 1),
    (0, 1, dict(batch_size=5, epochs=3, initial_epoch=1, initial_step=3), 1),
    (0, 1, dict(batch_size=4, epochs=2, shuffle_buffer=10), 1),
    (2, 3, dict(batch_size=3, epochs=2), 2),
], ids=["one-rank", "rank1-of-2", "resume", "reservoir", "accumulate"])
def test_fit_xy_batches_match_jax_training_pipeline(monkeypatch, rank, size,
                                                    kw, K):
    """The repair of the port's fit(x=, y=): the batches it trains on, in
    order, are the JAX python engine's for this rank's shard, seeded with
    the trainer's seed and anchored at (initial_epoch, initial_step)."""
    monkeypatch.setenv("HVT_NO_NATIVE", "1")
    seen, x, y = _fit_batches(monkeypatch, rank, size, K=K, **kw)
    shard = jloader.ArrayDataset((x, y)).shard(rank, size)
    bs = kw["batch_size"]
    spe = kw.get("steps_per_epoch") or shard.num_examples // (bs * K)
    start, skip = kw.get("initial_epoch", 0), kw.get("initial_step", 0)
    engine = {}
    it, close = jloader.training_pipeline(
        shard.arrays, bs, seed=11, shuffle_buffer=kw.get("shuffle_buffer"),
        structure=shard.structure, skip_batches=skip * K, start_epoch=start,
        batches_per_epoch=spe * K, engine_out=engine)
    assert engine["engine"] == "python"
    n = ((kw["epochs"] - start) * spe - skip) * K
    want = [next(it)[0] for _ in range(n)]
    close()
    assert len(seen) == n
    for a, b in zip(seen, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rank,size,kw,K", [
    (0, 1, dict(batch_size=4, epochs=3), 1),
    (1, 2, dict(batch_size=4, epochs=2, steps_per_epoch=5), 1),
    (0, 1, dict(batch_size=5, epochs=3, initial_epoch=1, initial_step=3), 1),
    (2, 3, dict(batch_size=3, epochs=2), 2),
], ids=["one-rank", "rank1-of-2", "resume", "accumulate"])
def test_fit_xy_batches_match_jax_native_engine(monkeypatch, rank, size, kw,
                                                K):
    """By default ``fit(x=, y=)`` takes the native engine where it builds,
    as the JAX trainer does, and trains on the JAX native engine's batches
    for this rank's shard, in order."""
    monkeypatch.delenv("HVT_NO_NATIVE", raising=False)
    seen, x, y = _fit_batches(monkeypatch, rank, size, K=K, **kw)
    shard = jloader.ArrayDataset((x, y)).shard(rank, size)
    bs = kw["batch_size"]
    spe = kw.get("steps_per_epoch") or shard.num_examples // (bs * K)
    start, skip = kw.get("initial_epoch", 0), kw.get("initial_step", 0)
    engine = {}
    it, close = jloader.training_pipeline(
        shard.arrays, bs, seed=11, structure=shard.structure,
        skip_batches=skip * K, start_epoch=start, batches_per_epoch=spe * K,
        engine_out=engine)
    assert engine["engine"] == "native"
    n = ((kw["epochs"] - start) * spe - skip) * K
    want = [next(it)[0] for _ in range(n)]
    close()
    assert len(seen) == n
    for a, b in zip(seen, want):
        assert np.array_equal(a, b)
