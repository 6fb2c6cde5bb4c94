"""Callbacks, checkpoints, metrics and TensorBoard events in the port
against the JAX package: the warmup and schedule scales per epoch, the
checkpoint file names and progress manifests of epoch and mid-epoch saves,
discovery that skips a corrupt or torn newest checkpoint, a step-exact
resume, the ``events.jsonl``/``metrics.jsonl`` records, event files the
JAX reader parses, the serving export round trip, and the root broadcast
of divergent states over two gloo ranks.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as ht
from horovod_tpu import tbevents as jtb
from horovod_tpu.training import callbacks as jcb
from horovod_tpu_torch import checkpoint, metrics
from horovod_tpu_torch import tbevents as ttb
from horovod_tpu_torch.data.loader import ArrayDataset
from horovod_tpu_torch.models.cnn import MnistCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


class _Holder:
    """The part of a trainer the callbacks touch."""

    def __init__(self, state=None):
        self.state = state
        self.update_scale = 1.0


def _scales(mod, callbacks, epochs):
    holder = _Holder()
    for cb in callbacks:
        cb.set_trainer(holder)
    out = []
    for e in range(epochs):
        holder.update_scale = 1.0
        for cb in callbacks:
            cb.on_epoch_begin(e)
        out.append(holder.update_scale)
    return out


def test_warmup_and_schedule_scales_match_jax():
    """Exact: the same float arithmetic on both sides."""
    for size in (1, 4):
        want = _scales(jcb, [jcb.LearningRateWarmupCallback(3, world_size=size)], 6)
        got = _scales(ht.callbacks, [
            ht.callbacks.LearningRateWarmupCallback(3, world_size=size)], 6)
        assert got == want
    assert got[0] == 0.25 and got[3:] == [1.0, 1.0, 1.0]
    mult = lambda e: 0.5 ** e  # noqa: E731
    want = _scales(jcb, [jcb.LearningRateWarmupCallback(2, world_size=4),
                         jcb.LearningRateScheduleCallback(mult, 2, 4)], 6)
    got = _scales(ht.callbacks, [
        ht.callbacks.LearningRateWarmupCallback(2, world_size=4),
        ht.callbacks.LearningRateScheduleCallback(mult, 2, 4)], 6)
    assert got == want


def _cnn_trainer(seed=0, lr=1e-3):
    model = MnistCNN(device="cpu", seed=seed)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)),
                         device="cpu", seed=7)
    trainer.build()
    return trainer


def _data(n=48, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 28, 28, 1)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.int64))


def _drive(cb, holder, epochs, steps):
    cb.set_trainer(holder)
    for e in range(epochs):
        cb.on_epoch_begin(e)
        for s in range(steps):
            cb.on_batch_end(s, {})
        cb.on_epoch_end(e, {})


def _manifests(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".meta.json"):
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
            payload = os.path.join(directory, name[:-len(".meta.json")])
            assert rec["payload_sha256"] == checkpoint.recorded_digest(payload)
            out[name] = (rec["epoch"], rec["step"])
    return out


def test_model_checkpoint_names_and_manifests_match_jax(tmp_path,
                                                      monkeypatch):
    """Two epochs of five steps with a save every 2 steps: the same files
    (payload, ``.sha256``, ``.meta.json``) and the same ``(epoch, step)``
    manifests on both sides, each recording its payload's digest."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    template = "checkpoint-{epoch}.ckpt"
    jstate = {"w": np.arange(4, dtype=np.float32)}
    _drive(jcb.ModelCheckpoint(str(jdir / template), save_every_steps=2),
           _Holder(jstate), 2, 5)
    trainer = _cnn_trainer()
    _drive(ht.callbacks.ModelCheckpoint(str(tdir / template),
                                        save_every_steps=2),
           _Holder(trainer.state), 2, 5)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert _manifests(tdir) == _manifests(jdir) == {
        "checkpoint-0.ckpt.meta.json": (0, 4),
        "checkpoint-1.ckpt.meta.json": (1, 4),  # epoch 1's saves advance it
        "checkpoint-2.ckpt.meta.json": (2, 0)}
    # The env knob, as in JAX.
    monkeypatch.setenv("HVT_SAVE_EVERY_STEPS", "3")
    assert ht.callbacks.ModelCheckpoint("x").save_every_steps == 3


def test_corrupt_or_torn_newest_checkpoint_is_skipped(tmp_path):
    trainer = _cnn_trainer()
    for epoch in (1, 2, 3, 4):
        checkpoint.save_checkpoint(str(tmp_path), trainer.state, epoch)
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("checkpoint-4.pt")
    # checkpoint-4: a flipped byte; checkpoint-3: torn (truncated).
    p4, p3 = tmp_path / "checkpoint-4.pt", tmp_path / "checkpoint-3.pt"
    data = bytearray(p4.read_bytes())
    data[len(data) // 2] ^= 0xFF
    p4.write_bytes(bytes(data))
    p3.write_bytes(p3.read_bytes()[:100])
    assert not checkpoint.checkpoint_intact(str(p4))
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("checkpoint-2.pt")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.restore(str(p4), trainer.state)
    # A stale manifest (payload replaced after it) falls back to the name.
    checkpoint.save(str(tmp_path / "checkpoint-5.pt"), trainer.state,
                    progress=(4, 3))
    assert checkpoint.checkpoint_progress(str(tmp_path / "checkpoint-5.pt")) == (4, 3)
    checkpoint.save(str(tmp_path / "checkpoint-5.pt"), _cnn_trainer(1).state)
    assert checkpoint.checkpoint_progress(str(tmp_path / "checkpoint-5.pt")) == (5, 0)
    # Resume discards the future beyond the resumed checkpoint.
    state, epoch = checkpoint.restore_latest_and_broadcast(
        str(tmp_path), _cnn_trainer(2).state)
    assert epoch == 5
    checkpoint._discard_future_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == [
        f"checkpoint-{e}.pt{s}" for e in (1, 2)
        for s in ("", ".meta.json", ".sha256")]


class _Crash(ht.callbacks.Callback):
    """Stops the run after a given optimizer step of a given epoch."""

    def __init__(self, epoch, step):
        self.at, self.epoch = (epoch, step), 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_batch_end(self, batch, logs=None):
        if (self.epoch, batch + 1) == self.at:
            raise KeyboardInterrupt


def test_step_exact_resume_matches_an_uninterrupted_run(tmp_path):
    """A run stopped after step 2 of epoch 1 (a mid-epoch save every 2
    steps), resumed through `restore_latest_and_broadcast(with_step=True)`
    and ``fit(initial_epoch=, initial_step=)``, ends with the uninterrupted
    run's parameters and optimizer state, bit for bit (same batches, same
    dropout seeds, same CPU arithmetic), and evaluates to its loss."""
    x, y = _data()
    ds = ArrayDataset((x, y)).repeat().shuffle(16, seed=3).batch(8)
    kw = dict(steps_per_epoch=3, epochs=3, verbose=0)
    full = _cnn_trainer()
    full.fit(ds, **kw)
    crashed = _cnn_trainer()
    cbs = [ht.callbacks.ModelCheckpoint(
        str(tmp_path / "checkpoint-{epoch}.pt"), save_every_steps=2),
        _Crash(1, 2)]
    with pytest.raises(KeyboardInterrupt):
        crashed.fit(ds, callbacks=cbs, **kw)
    resumed = _cnn_trainer(seed=5)  # other weights: the checkpoint wins
    state, epoch, step = checkpoint.restore_latest_and_broadcast(
        str(tmp_path), resumed.state, with_step=True)
    assert (epoch, step, state.step) == (1, 2, 5)
    resumed.fit(ds, initial_epoch=epoch, initial_step=step, **kw)
    assert resumed.state.step == full.state.step == 9
    assert checkpoint.state_digest(resumed.state) == checkpoint.state_digest(
        full.state)
    assert resumed.evaluate(x, y)["loss"] == full.evaluate(x, y)["loss"]
    # A step-unaware resume skips mid-epoch saves: here every checkpoint
    # the crashed run left is one (checkpoint-0 at (0, 2), checkpoint-1
    # advanced to (1, 2)), so it starts over.
    assert checkpoint.restore_latest_and_broadcast(
        str(tmp_path), _cnn_trainer().state)[1] == 0


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_scalar_logger_records_match_jax(tmp_path, monkeypatch):
    """Same batch/epoch logs through both loggers: the same records with the
    same keys and values (wall times aside), and event files the JAX
    reader parses (both CRCs verified) carrying the same scalars."""
    monkeypatch.setattr(metrics, "_sync_tensorboard", False)
    logs = [{"loss": 2.0 - 0.1 * i, "accuracy": 0.1 * i} for i in range(4)]
    epoch_logs = {"loss": 1.5, "accuracy": 0.4, "epoch_time_s": 3.25,
                  "val_loss": 1.6, "note": "not a scalar"}
    out = {}
    for name, mod in (("jax", jcb), ("torch", ht.callbacks)):
        logger = mod.ScalarLogger(str(tmp_path / name), update_freq="batch",
                                  flush_every=3)
        logger.set_trainer(_Holder())
        logger.on_train_begin()
        logger.on_epoch_begin(0)
        for i, lg in enumerate(logs):
            logger.on_batch_end(i, {k: torch.tensor(v) if name == "torch"
                                    else np.float32(v) for k, v in lg.items()})
        logger.on_epoch_end(0, dict(epoch_logs))
        logger.on_train_end()
        out[name] = [{k: v for k, v in r.items() if k != "wall_time"}
                     for r in _records(tmp_path / name / "events.jsonl")]
    assert len(out["torch"]) == len(out["jax"]) == 5
    for t, j in zip(out["torch"], out["jax"]):
        assert t.keys() == j.keys()
        for k in t:
            assert t[k] == pytest.approx(j[k], abs=1e-7)
    tb = [n for n in os.listdir(tmp_path / "torch")
          if n.startswith("events.out.tfevents.")]
    assert len(tb) == 1
    payloads = jtb.read_records(str(tmp_path / "torch" / tb[0]))
    assert b"brain.Event:2" in payloads[0] and len(payloads) == 6
    assert b"epoch/val_loss" in payloads[-1] and b"batch/loss" in payloads[1]
    # The encoder is the JAX one, byte for byte.
    for args in ((1.5, 3, None, {"a": 1.25, "b/c": -2.0}),
                 (2.0, None, "brain.Event:2", None)):
        assert ttb.encode_event(*args) == jtb.encode_event(*args)
        assert ttb.encode_record(ttb.encode_event(*args)) == jtb.encode_record(
            jtb.encode_event(*args))


def test_metrics_jsonl_records(tmp_path, monkeypatch):
    """Buffered before the rank is known, flushed at the first push after;
    ScalarLogger's epoch scalars reach the sink under their plain names
    with sync_tensorboard; the record keys are the JAX sink's."""
    from horovod_tpu import metrics as jmetrics

    for name in ("_sink", "_configured_path", "_sync_tensorboard"):
        monkeypatch.setattr(metrics, name, getattr(metrics, name))
    monkeypatch.setattr(metrics, "_buffered", [])
    monkeypatch.setenv("HVT_COORDINATOR_ADDRESS", "127.0.0.1:1")
    path = tmp_path / "metrics.jsonl"
    metrics.init(sync_tensorboard=True, path=str(path))
    metrics.push("early", 1.0)  # launched, runtime.init not run yet
    assert not path.exists()
    monkeypatch.delenv("HVT_COORDINATOR_ADDRESS")
    logger = ht.callbacks.ScalarLogger(str(tmp_path / "tb"))
    logger.on_epoch_end(1, {"loss": 0.25, "accuracy": 0.75})
    logger.on_train_end()
    metrics.push("loss", 0.125, step=9)
    recs = _records(path)
    assert [(r["name"], r["value"], r["step"]) for r in recs] == [
        ("early", 1.0, None), ("loss", 0.25, 2), ("accuracy", 0.75, 2),
        ("loss", 0.125, 9)]
    jsink = jmetrics.JsonlSink(str(tmp_path / "jax.jsonl"))
    jsink.push("loss", 0.125, step=9)
    jsink.close()
    assert _records(tmp_path / "jax.jsonl")[0].keys() == recs[-1].keys()


def test_export_serving_round_trip(tmp_path):
    """The bundle's probabilities equal `Trainer.predict` within 1e-6 at
    any batch size (the batch dimension is dynamic); the signature is the
    reference's input → prob; other formats raise naming the ROADMAP."""
    trainer = _cnn_trainer(seed=3)
    x, _ = _data(10, seed=4)
    bundle = checkpoint.export_serving(str(tmp_path), trainer.module,
                                       input_shape=(1, 28, 28, 1),
                                       input_dtype=np.uint8, timestamp="v1")
    assert bundle == str(tmp_path / "v1")
    with open(os.path.join(bundle, checkpoint.SIGNATURE_FILE)) as f:
        sig = json.load(f)
    assert sig["signature"]["inputs"]["input"] == {"shape": [1, 28, 28, 1],
                                                   "dtype": "uint8"}
    assert list(sig["signature"]["outputs"]) == ["prob"]
    serve = checkpoint.load_serving(bundle, device="cpu")
    for n in (1, 3, 10):
        np.testing.assert_allclose(serve(x[:n]), trainer.predict(x[:n]),
                                   atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError, match="jax or TensorFlow"):
        checkpoint.export_serving(str(tmp_path), trainer.module,
                                  input_shape=(1, 28, 28, 1),
                                  format="stablehlo")


BROADCAST_CHILD = r'''
import os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.parallel import collectives

ht.init(device="cpu")
r = ht.rank()
trainer = ht.Trainer(MnistCNN(device="cpu", seed=r),
                     ht.DistributedOptimizer(ht.adam(1e-3)), device="cpu")
trainer.build()
if r == 0:  # the root has trained: Adam state and a step count
    for p in trainer.module.parameters():
        p.grad = torch.ones_like(p)
    trainer.tx.optimizer.step()
    trainer.state.step = 5
before = collectives.allgather_object(checkpoint.state_digest(trainer.state))
cb = ht.callbacks.BroadcastGlobalVariablesCallback(0)
cb.set_trainer(trainer)
cb.on_train_begin()
after = collectives.allgather_object(checkpoint.state_digest(trainer.state))
np.savez(os.path.join(os.environ["OUT"], f"rank{r}.npz"),
         before=np.array(before), after=np.array(after),
         step=trainer.state.step,
         **{n: p.detach().numpy() for n, p in trainer.module.named_parameters()})
ht.shutdown()
'''


def test_broadcast_callback_makes_divergent_ranks_equal(tmp_path):
    """Two gloo ranks with different initial weights and optimizer state:
    after BroadcastGlobalVariablesCallback both hold rank 0's parameters,
    Adam state and step, bit for bit."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-c", BROADCAST_CHILD]
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
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert r0["before"][0] != r0["before"][1]
    assert r0["after"][0] == r0["after"][1] == r1["after"][1] == r0["before"][0]
    assert int(r1["step"]) == 5
    own = dict(MnistCNN(device="cpu", seed=1).named_parameters())
    for n, p in own.items():
        assert np.array_equal(r1[n], r0[n])
        assert not np.array_equal(r1[n], p.detach().numpy())  # rank 1's init
