"""`ExponentialMovingAverage` in the port (`training/ema.py`) against the
JAX callback of the same name, at each of its cadences — per step on the
streamed fit, per ``steps_per_execution`` chunk, per epoch and per
``HVT_EPOCH_CHUNK_STEPS`` chunk on ``cache="device"`` — with and without
zero-debiasing; its checkpoint round trip; and a JAX shadow carried across
by `models.convert.ema_from_flax`.

Both trainers run a dropout-free MLP from the same parameters with
Adadelta(1.0). Tolerance 2e-5 abs on the averaged parameters: the trained
parameters agree to that (`test_torch_cached_fit.py`), and the port's
``lerp`` form of the update rounds differently from JAX's ``decay·a +
(1 − decay)·b`` by an ulp a step."""

import os
import time

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu import checkpoint as jcheckpoint
from horovod_tpu.parallel.mesh import data_parallel_mesh
from horovod_tpu_torch.models.convert import ema_from_flax
from horovod_tpu_torch.training import ema as tema

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


TOL = 2e-5


class FlaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        h = fnn.relu(fnn.Dense(16)(x))
        return fnn.Dense(10)(h)


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(6, 16)
        self.fc2 = torch.nn.Linear(16, 10)

    def forward(self, x, *, train=False, dropout_seed=None):
        return self.fc2(torch.relu(self.fc1(x)))


def _from_flax(params) -> dict:
    p = jax.device_get(params)
    return {f"fc{i + 1}.{n}": torch.from_numpy(np.array(
                np.asarray(p[f"Dense_{i}"][k]).T if k == "kernel"
                else p[f"Dense_{i}"][k]))
            for i in range(2) for n, k in (("weight", "kernel"),
                                           ("bias", "bias"))}


def _data(n=96):
    rng = np.random.RandomState(1)
    w = np.random.RandomState(99).randn(6, 10)
    x = rng.randn(n, 6).astype(np.float32)
    return x, (x @ w).argmax(-1).astype(np.int64)


def _pair(steps_per_execution=1):
    jt = hvt.Trainer(FlaxMLP(), hvt.DistributedOptimizer(optax.adadelta(1.0)),
                     seed=2, steps_per_execution=steps_per_execution,
                     mesh=data_parallel_mesh(jax.devices()[:1]))
    sd = _from_flax(jt.build(np.zeros((1, 6), np.float32)).params)
    model = MLP()
    model.load_state_dict(sd)
    tt = ht.Trainer(model, ht.DistributedOptimizer(ht.adadelta(1.0)), seed=2,
                    steps_per_execution=steps_per_execution, device="cpu")
    return jt, tt


def _assert_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   want[name].numpy(), atol=TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("fit_kw,spe,chunk,debias", [
    (dict(epochs=2), 1, None, False),
    (dict(epochs=2), 1, None, True),
    (dict(epochs=2), 4, None, False),
    (dict(epochs=3, cache="device"), 1, None, False),
    (dict(epochs=2, cache="device"), 1, "5", True),
], ids=["per-step", "per-step-debiased", "per-chunk", "per-epoch-cached",
        "per-chunk-cached-debiased"])
def test_ema_matches_jax_at_each_cadence(monkeypatch, fit_kw, spe, chunk,
                                         debias):
    if chunk is None:
        monkeypatch.delenv("HVT_EPOCH_CHUNK_STEPS", raising=False)
    else:
        monkeypatch.setenv("HVT_EPOCH_CHUNK_STEPS", chunk)
    x, y = _data()
    jt, tt = _pair(spe)
    jema = hvt.callbacks.ExponentialMovingAverage(decay=0.9,
                                                  zero_debias=debias)
    tema_cb = ht.callbacks.ExponentialMovingAverage(decay=0.9,
                                                    zero_debias=debias)
    kw = dict(x=x, y=y, batch_size=8, verbose=0, **fit_kw)
    jt.fit(callbacks=[jema], **kw)
    tt.fit(callbacks=[tema_cb], **kw)
    assert tema_cb._count == jema._count > 0
    _assert_close(tema_cb.ema_params, _from_flax(jema.ema_params))
    # The shadow moved away from the live weights.
    live = dict(tt.module.named_parameters())
    assert any(float((v - live[n]).abs().max()) > 1e-4
               for n, v in tema_cb.ema_params.items())


def test_averaged_swaps_in_place_and_restores():
    x, y = _data()
    _, tt = _pair()
    cb = ht.callbacks.ExponentialMovingAverage(decay=0.5)
    tt.fit(x=x, y=y, batch_size=8, epochs=1, callbacks=[cb], verbose=0)
    params = dict(tt.module.named_parameters())
    ids = {n: p.data_ptr() for n, p in params.items()}
    live = {n: p.detach().clone() for n, p in params.items()}
    with cb.averaged(tt):
        for n, p in tt.module.named_parameters():
            assert p.data_ptr() == ids[n]
            assert torch.equal(p.detach(), cb.ema_params[n])
        averaged_eval = tt.evaluate(x, y, batch_size=32)
    for n, p in tt.module.named_parameters():
        assert torch.equal(p.detach(), live[n])
    assert averaged_eval != tt.evaluate(x, y, batch_size=32)
    with pytest.raises(ValueError, match="decay"):
        ht.callbacks.ExponentialMovingAverage(decay=1.0)
    with pytest.raises(RuntimeError, match="fit"):
        _ = ht.callbacks.ExponentialMovingAverage().ema_params


def test_checkpoint_round_trip_resumes_the_average(tmp_path):
    """A fit of two epochs with the shadow written each epoch equals a fit
    of one epoch, then a new callback on the same directory resuming the
    shadow for the second (against an uninterrupted run of the same two
    epochs, bit for bit on the CPU)."""
    x, y = _data()
    _, a = _pair()
    full = ht.callbacks.ExponentialMovingAverage(decay=0.8)
    a.fit(x=x, y=y, batch_size=8, epochs=2, callbacks=[full], verbose=0)
    _, b = _pair()
    first = ht.callbacks.ExponentialMovingAverage(
        decay=0.8, checkpoint_dir=str(tmp_path))
    b.fit(x=x, y=y, batch_size=8, epochs=1, callbacks=[first], verbose=0)
    path = tmp_path / tema.EMA_FILE
    assert path.exists() and (tmp_path / (tema.EMA_FILE + ".sha256")).exists()
    second = ht.callbacks.ExponentialMovingAverage(
        decay=0.8, checkpoint_dir=str(tmp_path))
    b.fit(x=x, y=y, batch_size=8, epochs=2, initial_epoch=1,
          callbacks=[second], verbose=0)
    assert second._count == full._count
    for n, v in second.ema_params.items():
        assert torch.equal(v, full.ema_params[n]), n
    # A corrupted file raises instead of restarting the average quietly.
    path.write_bytes(path.read_bytes()[:-3] + b"xyz")
    third = ht.callbacks.ExponentialMovingAverage(
        decay=0.8, checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="EMA shadow restore failed"):
        b.fit(x=x, y=y, batch_size=8, epochs=3, initial_epoch=2,
              callbacks=[third], verbose=0)


def test_jax_shadow_carries_across(tmp_path):
    """The JAX callback's ``ema.msgpack``, read with the JAX package and
    converted by `ema_from_flax` (the params conversion applied to the
    shadow tree), is the shadow the port's callback resumes."""
    x, y = _data()
    jt, tt = _pair()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jema = hvt.callbacks.ExponentialMovingAverage(
        decay=0.9, checkpoint_dir=str(jdir))
    jt.fit(x=x, y=y, batch_size=8, epochs=1, callbacks=[jema], verbose=0)
    payload = jcheckpoint.restore(
        os.path.join(jdir, "ema.msgpack"),
        {"shadow": jt.state.params, "count": 0})
    carried = ema_from_flax(payload, params_from=_from_flax)
    assert carried["count"] == jema._count
    tema.save_payload(str(tdir), carried)
    cb = ht.callbacks.ExponentialMovingAverage(decay=0.9,
                                               checkpoint_dir=str(tdir))
    tt.fit(x=x, y=y, batch_size=8, epochs=1, steps_per_epoch=1,
           callbacks=[cb], verbose=0)
    # The restored shadow took one more update after the carry-across.
    assert cb._count == jema._count + 1
    live = {n: p.detach() for n, p in tt.module.named_parameters()}
    want = {n: (cb.ema_params[n] - 0.1 * live[n]) / 0.9 for n in live}
    _assert_close(want, _from_flax(jema.ema_params))
