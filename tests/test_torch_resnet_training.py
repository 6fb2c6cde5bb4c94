"""`ResNetCIFAR` through the port's `Trainer` — the first model with state
that is not a parameter (BatchNorm's running statistics, registered
buffers): against the JAX `Trainer` on the same batches, `evaluate` on the
running statistics, every fit path updating them in place, and the
checkpoint and the broadcast carrying them.

The JAX trainer runs on a one-device mesh (the test suite's default is
eight CPU devices, where ``batch_size`` is per chip and BN spans all
eight), as `tests/test_torch_dp_training.py` does. Depth 8, batches of 8
synthetic CIFAR images, SGD(0.01) for 4 steps. Tolerances, each on the
largest difference in a parameter or running statistic as a share of how
far it moved from its initial value in a float64 run of the port (f64
compute and f64 parameters):

* The same arithmetic on both sides — f64 compute over f32 parameters,
  the JAX side under ``jax.enable_x64`` — within 1e-4 (measured 9.2e-6);
  per-step loss within 1e-6 abs.
* f32 on both sides: per-step loss within 1e-4 abs (measured 2.5e-5);
  every tensor within 10 % (measured 4.3 %): JAX's f32 run is 4.3 % from
  the float64 run (BN's fast variance cancels at this point, so f32
  rounding grows over the steps), the port's 0.05 %; each of the port's
  tensors is held to be no further from the float64 run than JAX's, plus
  1 %.

`evaluate` of one state agrees within 1e-5 on the loss and exactly on the
accuracy.
"""

import functools
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.models.resnet import ResNetCIFAR as FlaxResNet
from horovod_tpu.parallel.mesh import data_parallel_mesh
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.data.datasets import _synth_cifar_split
from horovod_tpu_torch.models.convert import resnet_from_flax
from horovod_tpu_torch.models.resnet import ResNetCIFAR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, LR = 4, 8, 0.01
TIMEOUT_S = 90


def _data():
    x, y = _synth_cifar_split(STEPS * B, 3)
    return x.astype(np.float32) / 255.0, y


def _batches(x, y):
    return [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
            for i in range(STEPS)]


def _sgd():
    return ht.DistributedOptimizer(functools.partial(torch.optim.SGD, lr=LR))


def _port_fit(init, batches, compute_dtype=torch.float32, f64_params=False):
    model = ResNetCIFAR(depth=8, compute_dtype=compute_dtype, device="cpu")
    model.load_state_dict(init)
    if f64_params:
        model.double()
    trainer = ht.Trainer(model, _sgd(), device="cpu")
    hist = trainer.fit(dataset=batches, epochs=STEPS, steps_per_epoch=1,
                       verbose=0)
    return trainer, [e["loss"] for e in hist]


def _jax_fit(x, y, **model_kw):
    jt = hvt.Trainer(FlaxResNet(depth=8, **model_kw),
                     hvt.DistributedOptimizer(optax.sgd(LR)),
                     mesh=data_parallel_mesh(jax.devices()[:1]))
    st = jt.build(x[:1])
    init = resnet_from_flax(jax.device_get({"params": st.params,
                                            **st.model_state}))
    hist = jt.fit(dataset=_batches(x, y), epochs=STEPS, steps_per_epoch=1,
                  verbose=0)
    final = resnet_from_flax(jax.device_get({"params": jt.state.params,
                                             **jt.state.model_state}))
    return jt, init, [e["loss"] for e in hist], final


@pytest.fixture(scope="module")
def jax_run():
    return _jax_fit(*_data())


@pytest.fixture(scope="module")
def port_f64(jax_run):
    """The port in float64 throughout: the reference of every limit."""
    _, init, _, _ = jax_run
    x, y = _data()
    trainer, _ = _port_fit(init, _batches(x.astype(np.float64), y),
                           torch.float64, f64_params=True)
    exact = {k: t.float() for k, t in trainer.module.state_dict().items()}
    moved = {k: float((exact[k] - init[k]).abs().max()) for k in exact}
    assert all(m > 0 for m in moved.values())  # every tensor moves
    return exact, moved


def _max_err(a, b, moved):
    return {k: float((a[k] - b[k]).abs().max()) / moved[k] for k in moved}


def test_fit_matches_the_jax_trainer_in_the_same_arithmetic(jax_run,
                                                            port_f64):
    _, init, _, _ = jax_run
    _, moved = port_f64
    x, y = _data()
    with jax.enable_x64(True):
        _, _, jax_losses, want = _jax_fit(x.astype(np.float64), y,
                                          compute_dtype=jnp.float64)
    trainer, losses = _port_fit(init, _batches(x, y), torch.float64)
    np.testing.assert_allclose(losses, jax_losses, atol=1e-6, rtol=0)
    got = trainer.module.state_dict()
    assert set(got) == set(want)
    err = _max_err(got, want, moved)
    assert max(err.values()) <= 1e-4, err


def test_fit_matches_the_jax_trainer(jax_run, port_f64):
    _, init, jax_losses, want = jax_run
    exact, moved = port_f64
    x, y = _data()
    trainer, losses = _port_fit(init, _batches(x, y))
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4, rtol=0)
    assert trainer.state.step == STEPS
    got = trainer.module.state_dict()
    assert set(got) == set(want)
    err = _max_err(got, want, moved)
    assert max(err.values()) <= 0.1, err
    port_err, jax_err = _max_err(got, exact, moved), _max_err(want, exact,
                                                              moved)
    assert all(port_err[k] <= jax_err[k] + 0.01 for k in moved), (
        port_err, jax_err)


def test_evaluate_uses_the_running_statistics(jax_run):
    jt, _, _, final = jax_run
    x, y = _data()
    model = ResNetCIFAR(depth=8, device="cpu")
    model.load_state_dict(final)
    trainer = ht.Trainer(model, _sgd(), device="cpu")
    trainer.build()
    got, want = trainer.evaluate(x, y, batch_size=B), jt.evaluate(
        x, y, batch_size=B)
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    assert got["accuracy"] == want["accuracy"]
    before = {k: t.clone() for k, t in model.state_dict().items()}
    probs = trainer.predict(x, batch_size=B)
    assert all(torch.equal(before[k], t)
               for k, t in model.state_dict().items())
    # Batch statistics would give another function than the running ones.
    with torch.no_grad():
        train_mode = torch.softmax(model(torch.from_numpy(x[:B]), train=True),
                                   -1).numpy()
    assert np.abs(train_mode - probs[:B]).max() > 1e-3


@pytest.mark.parametrize("path", ["xy", "dataset", "device"])
def test_every_fit_path_updates_the_buffers_in_place(path):
    x, y = _data()
    model = ResNetCIFAR(depth=8, device="cpu", seed=1)
    trainer = ht.Trainer(model, ht.adam(1e-3), device="cpu")
    trainer.build()
    bufs = dict(model.named_buffers())
    ptrs = {k: t.data_ptr() for k, t in bufs.items()}
    before = {k: t.clone() for k, t in bufs.items()}
    if path == "dataset":
        trainer.fit(dataset=_batches(x, y), steps_per_epoch=2, verbose=0)
    else:
        trainer.fit(x=x, y=y, batch_size=B, steps_per_epoch=2, verbose=0,
                    cache="device" if path == "device" else None)
    assert trainer.state.step == 2
    after = dict(model.named_buffers())
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    assert all(not torch.equal(before[k], t) for k, t in after.items()
               if "running" in k)
    state = trainer.state.model.state_dict()
    assert all(torch.equal(state[k], t) for k, t in after.items())


def test_checkpoint_round_trip_carries_the_running_statistics(tmp_path):
    x, y = _data()
    trainer = ht.Trainer(ResNetCIFAR(depth=8, device="cpu", seed=2),
                         ht.adam(1e-3), device="cpu")
    trainer.fit(dataset=_batches(x, y), steps_per_epoch=STEPS, verbose=0)
    path = checkpoint.save(str(tmp_path / "checkpoint-1.pt"), trainer.state)
    fresh = ht.Trainer(ResNetCIFAR(depth=8, device="cpu", seed=3),
                       ht.adam(1e-3), device="cpu")
    fresh.build()
    checkpoint.restore(path, fresh.state)
    want = trainer.module.state_dict()
    got = fresh.module.state_dict()
    assert any("running_mean" in k for k in want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert checkpoint.state_digest(fresh.state) == checkpoint.state_digest(
        trainer.state)
    assert fresh.evaluate(x, y, batch_size=B) == trainer.evaluate(
        x, y, batch_size=B)


BROADCAST_CHILD = r'''
import os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.resnet import ResNetCIFAR

ht.init(device="cpu")
r = ht.rank()
model = ResNetCIFAR(depth=8, device="cpu", seed=10 + r)
with torch.no_grad():
    for name, buf in model.named_buffers():
        buf.add_(r + 1.0)  # each rank's own statistics
trainer = ht.Trainer(model, ht.adam(1e-3), device="cpu")
trainer.build()
checkpoint.broadcast_parameters(trainer.state, root_rank=0)
np.savez(os.path.join(os.environ["OUT"], f"rank{r}.npz"),
         digest=checkpoint.state_digest(trainer.state),
         **{k: t.numpy() for k, t in model.state_dict().items()})
ht.shutdown()
'''


def test_broadcast_carries_the_running_statistics(tmp_path):
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
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert str(ranks[0]["digest"]) == str(ranks[1]["digest"])
    root = ResNetCIFAR(depth=8, device="cpu", seed=10).state_dict()
    for k, t in root.items():
        want = t.numpy() + (1.0 if "running" in k else 0.0)
        assert np.array_equal(ranks[1][k], want), k
