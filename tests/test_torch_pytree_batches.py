"""Dict batches in the port against the JAX package: `ArrayDataset` and
`training_pipeline` on ``({"src", "tgt"}, y)`` byte-equal to JAX's on both
engines (leaves in ``jax.tree_util`` order, dict keys sorted), and a
dict-input model (the seq2seq family at a tiny width) through every
Trainer path: ``fit(x=dict)``, ``evaluate`` (the padded tail masked out of
the counts) and ``predict`` (a ragged last batch: 19 rows at
``batch_size=1``, and 19 at 8) against the JAX Trainer on the same
weights, and ``cache="device"`` refusing a dict with JAX's error.

Tolerances: f32 on both sides; evaluate's loss within 1e-5 and its
accuracy within 1e-6 of JAX's, predict's probabilities within 1e-5.
"""

import time

import jax
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.data import loader as jloader
from horovod_tpu.models import seq2seq as jseq
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models.convert import seq2seq_params_from_flax

# The JAX package builds `native/libhvt_data.so` in place at first use,
# with no lock, and a process whose load meets another test process's
# build half-written marks the native engine unavailable for the rest of
# its life. Before this module's tests, wait for that library: retry a
# bounded number of times with the flag cleared, then require it.
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


VOCAB, PAD, BOS = 32, 0, 1
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_enc_layers=1,
           n_dec_layers=1, dropout=0.0)


def _pairs(n=37, s=12, t=8, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, (n, s)).astype(np.int32)
    src[::3, -3:] = PAD
    y = src[:, :t].copy()
    tgt = np.concatenate([np.full((n, 1), BOS, np.int32), y[:, :-1]], 1)
    return {"src": src, "tgt": tgt}, y


def _equal(a, b):
    """Two batches of the same structure, byte for byte."""
    fa, fb = jax.tree_util.tree_flatten(a), jax.tree_util.tree_flatten(b)
    assert fa[1] == fb[1]
    for x, y in zip(fa[0], fb[0]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_array_dataset_yields_jax_batches():
    x, y = _pairs()
    for shard in ((0, 1), (1, 2)):
        t = tloader.ArrayDataset((x, y)).shard(*shard).shuffle(16, seed=3) \
            .batch(4)
        j = jloader.ArrayDataset((x, y)).shard(*shard).shuffle(16, seed=3) \
            .batch(4)
        assert t.num_examples == j.num_examples
        for tb, jb in zip(t.batches(batches_per_epoch=5, start_epoch=2),
                          j.batches(batches_per_epoch=5, start_epoch=2)):
            assert isinstance(tb[0], dict) and sorted(tb[0]) == ["src", "tgt"]
            _equal(tb, jb)
            break
        # Flat leaves in jax.tree_util order: dict keys sorted.
        for a, b in zip(t.arrays, j.arrays):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("engine", ["native", "python"])
def test_training_pipeline_rebuilds_the_structure(engine, monkeypatch):
    if engine == "python":
        monkeypatch.setenv("HVT_NO_NATIVE", "1")
    x, y = _pairs()
    td, jd = tloader.ArrayDataset((x, y)), jloader.ArrayDataset((x, y))
    out_t, out_j = {}, {}
    t_it, t_close = tloader.training_pipeline(
        td.arrays, 4, seed=5, structure=td.structure, skip_batches=2,
        start_epoch=1, batches_per_epoch=6, engine_out=out_t)
    j_it, j_close = jloader.training_pipeline(
        jd.arrays, 4, seed=5, structure=jd.structure, skip_batches=2,
        start_epoch=1, batches_per_epoch=6, engine_out=out_j)
    try:
        assert out_t == out_j == {"engine": engine}
        for _ in range(14):  # across an epoch boundary
            _equal(next(t_it), next(j_it))
    finally:
        t_close()
        j_close()


def _pair_models(x):
    """The JAX model's built params, and the port's model and Trainer with
    them."""
    jm = jseq.Seq2SeqTransformer(**CFG)
    jtrainer = hvt.Trainer(jm, hvt.DistributedOptimizer(optax.adam(1e-3)),
                           loss="sparse_categorical_crossentropy")
    jparams = jax.device_get(jtrainer.build(
        jax.tree.map(lambda a: a[:8], x)).params)
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(jparams, tm))
    ttrainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adam(1e-3)),
                          loss="sparse_categorical_crossentropy",
                          device="cpu")
    ttrainer.build()
    return jtrainer, ttrainer


def test_evaluate_and_predict_match_jax_with_dict_inputs():
    x, y = _pairs(n=19)
    jtrainer, ttrainer = _pair_models(x)
    for bs in (8, 5):  # 19 rows: a padded, masked tail either way
        je = jtrainer.evaluate(x, y, batch_size=bs)
        te = ttrainer.evaluate(x, y, batch_size=bs)
        assert te["loss"] == pytest.approx(je["loss"], abs=1e-5)
        assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-6)
    for bs in (1, 8):
        tp = ttrainer.predict(x, batch_size=bs)
        assert tp.shape == (19, 8, VOCAB)
        np.testing.assert_allclose(tp.sum(-1), 1.0, atol=1e-5)
        jp = jtrainer.predict(x, batch_size=bs)
        np.testing.assert_allclose(tp, jp, atol=1e-5)


def test_fit_takes_dict_inputs_and_cache_device_refuses_them():
    x, y = _pairs(n=64)
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=3)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adam(3e-3)),
                         loss="sparse_categorical_crossentropy", device="cpu")
    hist = trainer.fit(x=x, y=y, batch_size=8, epochs=3, verbose=0,
                       validation_data=(x, y))
    assert trainer.state.step == 24 and trainer._stream_geometry[
        "engine"] in ("native", "python")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["val_loss"])
    # train_step takes the same dict batch.
    m = trainer.train_step(jax.tree.map(lambda a: a[:8], x), y[:8])
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="cache='device' stages a single "
                       "input array; pytree"):
        trainer.fit(x=x, y=y, batch_size=8, cache="device")
    with pytest.raises(ValueError, match="cache='device' stages a single "
                       "input array; pytree"):
        trainer.evaluate(x, y, batch_size=8, cache="device")
    jm = jseq.Seq2SeqTransformer(**CFG)
    jtrainer = hvt.Trainer(jm, hvt.DistributedOptimizer(optax.adam(1e-3)),
                           loss="sparse_categorical_crossentropy")
    with pytest.raises(ValueError) as jerr:
        jtrainer.fit(x=x, y=y, batch_size=8, cache="device")
    with pytest.raises(ValueError) as terr:
        trainer.fit(x=x, y=y, batch_size=8, cache="device")
    assert str(terr.value) == str(jerr.value)


def test_dict_fit_steps_read_per_leaf_buffers():
    """The runner keeps one device buffer a leaf: a fit of K = 2 steps per
    execution over dict batches equals the same fit one step a chunk."""
    x, y = _pairs(n=48)
    states = []
    for spe in (1, 2):
        tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=4)
        trainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adam(3e-3)),
                             loss="sparse_categorical_crossentropy",
                             device="cpu", steps_per_execution=spe)
        trainer.fit(x=x, y=y, batch_size=8, epochs=1, verbose=0)
        states.append({k: v.clone() for k, v in tm.state_dict().items()})
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_batch_specs_of_a_dict_part():
    """A single spec applies to every leaf of a part; a dict of specs maps
    the part's leaves one by one (JAX's `shard_batch`); a layout the port
    does not carry raises naming ROADMAP 12.4."""
    from horovod_tpu_torch.parallel.mesh import P
    from horovod_tpu_torch.training import trainer as trainer_mod

    seq, whole = P(("data", "fsdp"), "seq"), P(("data", "fsdp"), None)
    assert trainer_mod._seq_parts((seq, whole)) == (True, False)
    assert trainer_mod._seq_parts(({"src": seq, "tgt": whole}, seq)) == (
        {"src": True, "tgt": False}, True)
    with pytest.raises(NotImplementedError, match="12.4"):
        trainer_mod._seq_parts(({"src": P("seq")}, seq))
