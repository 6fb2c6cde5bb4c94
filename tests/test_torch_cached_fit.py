"""The trainer's execution modes in the port against the JAX `Trainer`:
``fit(cache="device")`` (with ``initial_step`` resume and
``HVT_EPOCH_CHUNK_STEPS`` chunking, at one rank and at two gloo ranks
against a two-device CPU mesh), ``evaluate(cache="device")`` with its
padded tail, and ``steps_per_execution`` (K ∈ {1, 3} with a remainder
chunk: callback cadence, step indices and metrics); a restored state
resumes the cached fit exactly.

Both sides train a dropout-free two-layer MLP from the same parameters
with Adadelta(1.0), the tf1 script's optimizer (its eps sits inside both
square roots, so no update amplifies rounding near a zero gradient).
Tolerances, f32 on the CPU: per-step and epoch losses within 2e-5 abs
(values ~2: a few ulps a step, over up to 75 steps), accuracies within
1e-6 (both sides count the same rows, so they are equal when the batches
are), parameters within 2e-5 abs. On CUDA the same steps are graph
replays; the `cuda` test holds a replayed step against the eager one.
"""

import os
import signal
import subprocess
import sys
import time

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.parallel.mesh import data_parallel_mesh
from horovod_tpu_torch import checkpoint

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
TIMEOUT_S = 60
LOSS_TOL, ACC_TOL, PARAM_TOL = 2e-5, 1e-6, 2e-5

# The port's MLP, also run by the two-rank children.
MLP_SRC = '''
import torch


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(6, 16)
        self.fc2 = torch.nn.Linear(16, 10)

    def forward(self, x, *, train=False, dropout_seed=None):
        return self.fc2(torch.relu(self.fc1(x)))
'''
_ns: dict = {}
exec(MLP_SRC, _ns)
MLP = _ns["MLP"]


class FlaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(10)(h)


def _from_flax(params) -> dict:
    p = jax.device_get(params)
    return {f"fc{i + 1}.{n}": torch.from_numpy(np.array(
                np.asarray(p[f"Dense_{i}"][k]).T if k == "kernel"
                else p[f"Dense_{i}"][k]))
            for i in range(2) for n, k in (("weight", "kernel"),
                                           ("bias", "bias"))}


def _data(n=203, seed=0):
    """Learnable rows: the label is the argmax of a fixed linear map."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(99).randn(6, 10)
    x = rng.randn(n, 6).astype(np.float32)
    return x, (x @ w).argmax(-1).astype(np.int64)


class _JaxRecorder(hvt.callbacks.Callback):
    def __init__(self):
        self.seen = []

    def on_batch_end(self, batch, logs=None):
        self.seen.append((batch, float(logs["loss"])))


class _TorchRecorder(ht.callbacks.Callback):
    def __init__(self):
        self.seen = []

    def on_batch_end(self, batch, logs=None):
        self.seen.append((batch, float(logs["loss"])))


def _pair(n_devices=1, steps_per_execution=1, seed=3):
    jt = hvt.Trainer(FlaxMLP(), hvt.DistributedOptimizer(optax.adadelta(1.0)),
                     seed=seed, steps_per_execution=steps_per_execution,
                     mesh=data_parallel_mesh(jax.devices()[:n_devices]))
    sd = _from_flax(jt.build(np.zeros((1, 6), np.float32)).params)
    model = MLP()
    model.load_state_dict(sd)
    tt = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)),
                    seed=seed, steps_per_execution=steps_per_execution,
                    device="cpu")
    return jt, tt, sd


def _assert_history(th, jh, keys=("loss", "accuracy")):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        for k in keys:
            tol = ACC_TOL if "accuracy" in k else LOSS_TOL
            assert t[k] == pytest.approx(j[k], abs=tol), (k, t[k], j[k])


def _assert_params(model, jax_params):
    want = _from_flax(jax_params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


def _assert_records(got, want):
    assert [b for b, _ in got] == [b for b, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("fit_kw,chunk", [
    (dict(epochs=3), None),
    (dict(epochs=3, initial_epoch=1, initial_step=5), None),
    (dict(epochs=2, initial_step=4), "7"),
    (dict(epochs=2, steps_per_epoch=10), "4"),
], ids=["plain", "resume", "resume-chunked", "cut-chunked"])
def test_cached_fit_matches_jax_one_rank(monkeypatch, fit_kw, chunk):
    """The same batches (the JAX permutation, drawn by the port's
    threefry), the same callback cadence — once an epoch, or once per
    ``HVT_EPOCH_CHUNK_STEPS`` chunk with the chunk's last loss and its true
    step index — the same epoch logs (validation on the cached eval path)
    and parameters."""
    if chunk is None:
        monkeypatch.delenv("HVT_EPOCH_CHUNK_STEPS", raising=False)
    else:
        monkeypatch.setenv("HVT_EPOCH_CHUNK_STEPS", chunk)
    x, y = _data()
    jt, tt, _ = _pair()
    jrec, trec = _JaxRecorder(), _TorchRecorder()
    kw = dict(x=x, y=y, batch_size=8, cache="device", verbose=0,
              validation_data=(x[:37], y[:37]), **fit_kw)
    jh = jt.fit(callbacks=[jrec], **kw)
    th = tt.fit(callbacks=[trec], **kw)
    _assert_history(th, jh, ("loss", "accuracy", "val_loss",
                             "val_accuracy"))
    _assert_records(trec.seen, jrec.seen)
    _assert_params(tt.module, jt.state.params)
    assert tt.state.step == int(jt.state.step)
    assert tt._stream_geometry["path"] == "device"


CHILD = MLP_SRC + r'''
import os
import numpy as np
import horovod_tpu_torch as ht

ht.init(device="cpu")
out = os.environ["OUT"]
data = np.load(os.path.join(out, "data.npz"))
model = MLP()
model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)),
                     seed=3, device="cpu")
seen = []


class Rec(ht.callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        seen.append((batch, float(logs["loss"])))


trainer.fit(x=data["x"], y=data["y"], batch_size=8, epochs=2,
            initial_step=3, cache="device", verbose=0,
            validation_data=(data["x"][:37], data["y"][:37]),
            callbacks=[ht.callbacks.MetricAverageCallback(), Rec()])
hist = trainer.history
np.savez(os.path.join(out, f"rank{ht.rank()}.npz"),
         losses=np.array([e["loss"] for e in hist]),
         accs=np.array([e["accuracy"] for e in hist]),
         val=np.array([e["val_loss"] for e in hist]),
         batches=np.array([b for b, _ in seen]),
         **{n: p.detach().numpy() for n, p in model.named_parameters()})
ht.shutdown()
'''


def test_cached_fit_two_gloo_ranks_match_a_two_device_mesh(tmp_path,
                                                           monkeypatch):
    """Two ranks, each staging its half of the (truncated) data and
    drawing its row of the JAX permutation, with chunked callbacks and a
    resume step, against the JAX trainer on a two-device mesh: epoch logs
    (averaged over the ranks), callback indices and parameters; the ranks
    end bit-identical."""
    monkeypatch.setenv("HVT_EPOCH_CHUNK_STEPS", "4")
    x, y = _data()
    jt, _, sd = _pair(n_devices=2)
    jrec = _JaxRecorder()
    jh = jt.fit(x=x, y=y, batch_size=8, epochs=2, initial_step=3,
                cache="device", verbose=0, callbacks=[jrec],
                validation_data=(x[:37], y[:37]))
    np.savez(tmp_path / "data.npz", x=x, y=y)
    torch.save(sd, tmp_path / "init.pt")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp_path))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key in ranks[0].files:
        assert np.array_equal(ranks[0][key], ranks[1][key]), key
    r0 = ranks[0]
    np.testing.assert_allclose(r0["losses"], [e["loss"] for e in jh],
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(r0["accs"], [e["accuracy"] for e in jh],
                               atol=ACC_TOL, rtol=0)
    np.testing.assert_allclose(r0["val"], [e["val_loss"] for e in jh],
                               atol=LOSS_TOL, rtol=0)
    assert r0["batches"].tolist() == [b for b, _ in jrec.seen]
    want = _from_flax(jt.state.params)
    for name in want:
        np.testing.assert_allclose(r0[name], want[name].numpy(),
                                   atol=PARAM_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("n,batch", [(37, 8), (40, 8), (5, 16)],
                         ids=["ragged", "whole-batches", "under-one-batch"])
def test_cached_evaluate_matches_jax_and_uncached(n, batch):
    """The padded tail repeats the last real row and is masked out: the
    cached result equals JAX's cached evaluate and the port's uncached one
    (f64 sums on both of the port's paths, f32 in JAX)."""
    x, y = _data(n + 3, seed=5)
    x, y = x[:n], y[:n]
    jt, tt, _ = _pair()
    tt.build()
    want = jt.evaluate(x, y, batch_size=batch, cache="device")
    got = tt.evaluate(x, y, batch_size=batch, cache="device")
    plain = tt.evaluate(x, y, batch_size=batch)
    assert got["accuracy"] == want["accuracy"] == plain["accuracy"]
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-6)
    assert got["loss"] == pytest.approx(plain["loss"], abs=1e-12)
    # Staged once per (x, y, batch), at most four sets kept.
    assert len(tt._eval_cache) == 1
    tt.evaluate(x, y, batch_size=batch, cache="device")
    assert len(tt._eval_cache) == 1
    for _ in range(5):
        xs = x.copy()
        tt.evaluate(xs, y, batch_size=batch, cache="device")
    assert len(tt._eval_cache) == 4


@pytest.mark.parametrize("K", [1, 3])
def test_steps_per_execution_matches_jax(K):
    """The streamed ``fit(x=, y=)`` in chunks of K steps, a remainder chunk
    at each epoch's end (25 steps an epoch) and a shorter resume epoch:
    ``on_batch_end`` once per chunk with its last step's loss and true step
    index, the epoch logs and the parameters, against JAX's."""
    x, y = _data()
    jt, tt, _ = _pair(steps_per_execution=K)
    jrec, trec = _JaxRecorder(), _TorchRecorder()
    kw = dict(x=x, y=y, batch_size=8, epochs=3, initial_epoch=1,
              initial_step=2, verbose=0)
    jh = jt.fit(callbacks=[jrec], **kw)
    th = tt.fit(callbacks=[trec], **kw)
    _assert_records(trec.seen, jrec.seen)
    # Chunk ends: the resume epoch runs steps 2-24, the next 0-24; with
    # K = 3 each ends with a remainder chunk at step 24.
    want = {1: list(range(2, 25)) + list(range(25)),
            3: list(range(4, 25, 3)) + [24] + list(range(2, 25, 3)) + [24]}
    assert [b for b, _ in trec.seen] == want[K]
    _assert_history(th, jh)
    _assert_params(tt.module, jt.state.params)
    assert tt._stream_geometry["engine"] == "native"


def test_cache_argument_errors():
    x, y = _data(40)
    _, tt, _ = _pair()
    with pytest.raises(ValueError, match="x=/y="):
        tt.fit(x=x, cache="device")
    with pytest.raises(ValueError, match="unknown cache"):
        tt.fit(x=x, y=y, cache="host")
    with pytest.raises(ValueError, match="single input"):
        tt.fit(x={"a": x}, y=y, cache="device")
    with pytest.raises(ValueError, match="batch"):
        tt.fit(x=x, y=y, batch_size=64, cache="device")
    tt.build()
    with pytest.raises(ValueError, match="unknown cache"):
        tt.evaluate(x, y, cache="host")
    with pytest.raises(ValueError, match="initial_step must be >= 0"):
        tt.fit(x=x, y=y, batch_size=8, initial_step=-1, cache="device")


def test_fit_takes_only_its_steps_from_a_dataset_iterator():
    """``fit(dataset=)`` draws exactly steps × K batches from the caller's
    iterator (the prefetcher stages the plan, not the stream) and leaves
    it open: the caller's next batch is the one after them."""
    x, y = _data()

    def stream():
        for i in range(1000):
            yield x[i % 25 * 8:i % 25 * 8 + 8], np.full(8, i % 10)

    _, tt, _ = _pair(steps_per_execution=3)
    feed = stream()
    tt.fit(dataset=feed, steps_per_epoch=7, epochs=2, verbose=0)
    assert tt.state.step == 14
    assert int(next(feed)[1][0]) == 14 % 10


def test_dataset_fit_feeds_runs_of_one_shape():
    """``fit(dataset=)`` with a batch of another size mid-epoch: each run
    of steps of one shape goes to the step runner at a time (on the card,
    a new capture), in chunks of ``steps_per_execution=3``. The result
    equals `train_step` over the same batches bit for bit (one step
    function), and the JAX trainer's fit over them within PARAM_TOL."""
    x, y = _data()
    cuts = [0, 8, 16, 24, 29, 37, 45, 53, 61]  # the fourth batch has 5 rows
    batches = [(x[a:b], y[a:b]) for a, b in zip(cuts, cuts[1:])]
    jt, tt, sd = _pair(steps_per_execution=3)
    th = tt.fit(dataset=list(batches), steps_per_epoch=len(batches),
                verbose=0)
    jt1, _, _ = _pair()
    jh = jt1.fit(dataset=list(batches), steps_per_epoch=len(batches),
                 verbose=0)
    model = MLP()
    model.load_state_dict(sd)
    step = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)),
                      seed=3, device="cpu")
    for xb, yb in batches:
        step.train_step(xb, yb)
    assert checkpoint.state_digest(step.state) == checkpoint.state_digest(
        tt.state)
    assert abs(th[0]["loss"] - jh[0]["loss"]) <= LOSS_TOL
    got = {n: p.detach().numpy() for n, p in tt.module.named_parameters()}
    for n, want in _from_flax(jt1.state.params).items():
        np.testing.assert_allclose(got[n], want.numpy(), atol=PARAM_TOL,
                                   rtol=0)
    acc = ht.Trainer(MLP(), ht.DistributedOptimizer(
        ht.adadelta(1.0), backward_passes_per_step=2), device="cpu")
    with pytest.raises(ValueError, match="share a shape"):
        acc.fit(dataset=[batches[2], batches[3]], steps_per_epoch=1,
                verbose=0)


def test_restored_state_resumes_the_cached_fit_exactly(tmp_path):
    """Two epochs in one fit against one epoch, a checkpoint, a fresh
    trainer restored from it and a fit resumed at epoch 1: the same
    parameters and optimizer state, bit for bit (the restore copies the
    optimizer state in place where it exists)."""
    x, y = _data()
    _, a, sd = _pair()
    a.fit(x=x, y=y, batch_size=8, epochs=2, cache="device", verbose=0)
    _, b, _ = _pair()
    b.fit(x=x, y=y, batch_size=8, epochs=1, cache="device", verbose=0)
    path = checkpoint.save(str(tmp_path / "checkpoint-1.pt"), b.state)
    model = MLP()
    model.load_state_dict(sd)
    c = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)), seed=3,
                   device="cpu")
    c.build()
    generation = c.tx.generation
    checkpoint.restore(path, c.state)
    assert c.tx.generation == generation + 1  # no state yet: rebound
    c.fit(x=x, y=y, batch_size=8, epochs=2, initial_epoch=1, cache="device",
          verbose=0)
    assert checkpoint.state_digest(c.state) == checkpoint.state_digest(a.state)
    # A second restore finds the state in place and keeps its tensors.
    before = [id(t) for st in c.tx.optimizer.state.values()
              for t in st.values()]
    checkpoint.restore(path, c.state)
    assert c.tx.generation == generation + 1
    assert [id(t) for st in c.tx.optimizer.state.values()
            for t in st.values()] == before
    assert checkpoint.state_digest(c.state) == checkpoint.state_digest(b.state)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured step runs on CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replays_equal_the_eager_step(cuda):
    """On the card: 12 steps of the cached fit as replays of the captured
    step and as eager steps, from the same state: the same parameters and
    optimizer state, bit for bit (the MLP's dense products are
    deterministic)."""
    x, y = _data()
    digests = []
    for eager in (False, True):
        torch.manual_seed(0)
        model = MLP()
        trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)),
                             seed=3, device=cuda)
        trainer.fit(x=x, y=y, batch_size=8, steps_per_epoch=12,
                    cache="device", verbose=0, _eager=eager)
        digests.append(checkpoint.state_digest(trainer.state))
        if not eager:
            assert trainer._runner.replays == 11
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_resumed_cached_fit_replays_equal_the_eager_resume(cuda, tmp_path):
    """On the card: a state restored from a checkpoint (optimizer state
    and all) resumes the cached fit as graph replays — one eager step
    first, since the runner has not captured yet — and ends bit-identical
    to the same resume run eagerly."""
    x, y = _data()
    torch.manual_seed(0)
    model = MLP()
    first = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)),
                       seed=3, device=cuda)
    first.fit(x=x, y=y, batch_size=8, epochs=1, cache="device", verbose=0)
    path = checkpoint.save(str(tmp_path / "checkpoint-1.pt"), first.state)
    digests = []
    for eager in (False, True):
        torch.manual_seed(0)
        t = ht.Trainer(MLP(), ht.DistributedOptimizer(ht.adadelta(1.0)),
                       seed=3, device=cuda)
        t.build()
        checkpoint.restore(path, t.state)
        t.fit(x=x, y=y, batch_size=8, epochs=2, initial_epoch=1,
              cache="device", verbose=0, _eager=eager)
        digests.append(checkpoint.state_digest(t.state))
        if not eager:
            assert (t._runner.captures, t._runner.replays) == (1, 24)
    assert digests[0] == digests[1]
