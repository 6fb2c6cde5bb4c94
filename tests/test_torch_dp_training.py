"""Data-parallel training in the port against the JAX package: Adam and
Adadelta trajectories against optax, gradient accumulation (K = 4, summed
and averaged) and a whole `Trainer.fit` against the JAX `Trainer` on one
device, and the data-parallel identity — two gloo ranks with batch b each
train to the parameters of one rank with batch 2b.

The trainer comparisons use a dropout-free two-layer MLP defined on both
sides (dropout bits cannot match JAX's threefry bits); its flax params go
into the port through transposed dense kernels. Tolerances are stated per
test; all are f32 on the CPU.
"""

import functools
import os
import signal
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.parallel.mesh import data_parallel_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
D_IN, HIDDEN, CLASSES = 6, 16, 10

# The port's MLP, also run by the two-rank children.
MLP_SRC = '''
import torch


class MLP(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = torch.nn.Linear(6, 16)
        self.fc2 = torch.nn.Linear(16, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x, *, train=False, dropout_seed=None):
        return self.fc2(torch.relu(self.fc1(x)))
'''
_ns: dict = {}
exec(MLP_SRC, _ns)
MLP = _ns["MLP"]


class FlaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        h = fnn.relu(fnn.Dense(HIDDEN)(x))
        return fnn.Dense(CLASSES)(h)


def _from_flax(params) -> dict:
    p = jax.device_get(params)
    return {f"fc{i + 1}.{n}": torch.from_numpy(np.array(
                np.asarray(p[f"Dense_{i}"][k]).T if k == "kernel"
                else p[f"Dense_{i}"][k]))
            for i in range(2) for n, k in (("weight", "kernel"),
                                           ("bias", "bias"))}


def _batches(n, b, seed=0):
    """Learnable batches: the label is the argmax of a fixed linear map."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(99).randn(D_IN, CLASSES)
    xs = [rng.randn(b, D_IN).astype(np.float32) for _ in range(n)]
    return [(x, (x @ w).argmax(-1).astype(np.int64)) for x in xs]


# -- optimizers against optax ----------------------------------------------------


def test_trainer_bucket_bytes_sizes_the_reduction(monkeypatch):
    """The bucket size resolves as in the JAX Trainer: ``bucket_bytes=`` →
    ``HVT_BUCKET_BYTES`` → 64 MB. The size cuts the reduction differently
    but leaves the reduced gradients bit for bit (bf16 wire, world of 1)."""
    monkeypatch.delenv("HVT_BUCKET_BYTES", raising=False)
    assert ht.Trainer(MLP(), ht.adam(1e-3),
                      device="cpu").tx.bucket_bytes == 64 * 2**20
    monkeypatch.setenv("HVT_BUCKET_BYTES", "4096")
    x, y = _batches(1, 8)[0]
    grads = {}
    for bucket_bytes in (None, 12):
        trainer = ht.Trainer(
            MLP(), ht.DistributedOptimizer(ht.adam(1e-3), compression="bf16"),
            device="cpu", bucket_bytes=bucket_bytes)
        assert trainer.tx.bucket_bytes == (bucket_bytes or 4096)
        trainer.train_step(x, y)
        grads[bucket_bytes] = [p.grad for p in trainer.module.parameters()]
    for a, b in zip(grads[None], grads[12]):
        assert torch.equal(a, b)
        assert torch.equal(a, a.bfloat16().float())  # through the wire


@pytest.mark.parametrize("name", ["adam", "adadelta"])
def test_optimizer_matches_optax_over_steps(name):
    """Ten steps of the port's factory (optax's defaults, stated) against
    optax on the same numpy gradients, with an update scale of 0.5 on two
    steps (JAX's ``update_scale`` multiplies the update). Tolerance 2e-6
    abs: f32 elementwise math in another order, over ten steps, on values
    of magnitude ≤ 3 (one ulp there is 2.4e-7)."""
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 3), "b": (7,)}
    p0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(10)]
    scales = [1.0, 1.0, 0.5, 1.0, 1.0, 1.0, 0.5, 1.0, 1.0, 1.0]
    lr = {"adam": 3e-2, "adadelta": 1.0}[name]
    tx = getattr(optax, name)(lr)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    st = tx.init(jp)
    for g, s in zip(grads, scales):
        upd, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * s, upd))
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in p0.items()}
    opt = ht.DistributedOptimizer(getattr(ht, name)(lr))
    opt.bind(tp.values())
    for g, s in zip(grads, scales):
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n])
        opt.step(s)
    for n in shapes:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]),
                                   atol=2e-6, rtol=0, err_msg=n)
    group = opt.optimizer.param_groups[0]
    assert group["lr"] == lr  # the scale does not stick
    if name == "adam":
        assert (group["eps"], group["betas"]) == (1e-8, (0.9, 0.999))
    else:
        assert (group["eps"], group["rho"]) == (1e-6, 0.9)


# -- the trainer against the JAX trainer -------------------------------------------


def _jax_trainer(tx, seed=0):
    trainer = hvt.Trainer(FlaxMLP(), tx, seed=seed,
                          mesh=data_parallel_mesh(jax.devices()[:1]))
    params = trainer.build(np.zeros((1, D_IN), np.float32)).params
    return trainer, _from_flax(params)


def _torch_trainer(state_dict, opt):
    model = MLP()
    model.load_state_dict(state_dict)
    return ht.Trainer(model, opt, device="cpu"), model


def _assert_params(model, want, tol):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("average", [False, True], ids=["sum", "mean"])
def test_accumulation_matches_jax_trainer(average):
    """K = 4 microbatches per optimizer step, SGD so that the sum (Horovod's
    default) and the mean of the K gradients move the parameters 4× apart:
    per-step losses (the mean over the K microbatches) within 1e-6, final
    params within 1e-6 abs."""
    K, steps, lr = 4, 3, 0.05
    batches = _batches(K * steps, 8, seed=1)
    jt, sd = _jax_trainer(hvt.DistributedOptimizer(
        optax.sgd(lr), backward_passes_per_step=K,
        average_aggregated_gradients=average))
    tt, model = _torch_trainer(sd, ht.DistributedOptimizer(
        functools.partial(torch.optim.SGD, lr=lr), backward_passes_per_step=K,
        average_aggregated_gradients=average))
    jh = jt.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                verbose=0)
    th = tt.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                verbose=0)
    np.testing.assert_allclose([e["loss"] for e in th],
                               [e["loss"] for e in jh], atol=1e-6, rtol=0)
    assert tt.state.step == steps
    _assert_params(model, _from_flax(jt.state.params), 1e-6)
    # The sum and the mean really differ.
    moved = sum(float((p.detach() - sd[n]).abs().sum())
                for n, p in model.named_parameters())
    assert moved > 0


def test_trainer_fit_matches_jax_trainer_on_one_device():
    """Adam(1e-2) for 6 steps from the same params on identical batches:
    per-step loss within 1e-5 (values ~2.5: a few f32 ulps of drift over
    the steps) and accuracy within 1e-6; final params within 1e-5 abs,
    except elements whose gradient was tiny (below 1e-6 of its tensor's
    largest) at some step, where Adam's g / (|g| + eps) turns f32
    rounding into up to ±lr a step (held to 2·lr·steps)."""
    steps, lr = 6, 1e-2
    batches = _batches(steps, 16, seed=2)
    jt, sd = _jax_trainer(hvt.DistributedOptimizer(optax.adam(lr)))
    tt, model = _torch_trainer(sd, ht.DistributedOptimizer(ht.adam(lr)))
    jh = jt.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                verbose=0)
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in model.named_parameters()}
    for batch in batches:
        tt.fit(dataset=[batch], steps_per_epoch=1, verbose=0)
        for n, p in model.named_parameters():
            g = p.grad.abs()
            tiny[n] |= g < 1e-6 * g.max()
    th = tt.history
    np.testing.assert_allclose([e["loss"] for e in th],
                               [e["loss"] for e in jh], atol=1e-5, rtol=0)
    np.testing.assert_allclose([e["accuracy"] for e in th],
                               [e["accuracy"] for e in jh], atol=1e-6)
    want = _from_flax(jt.state.params)
    for name, p in model.named_parameters():
        tol = torch.where(tiny[name], 2 * lr * steps, 1e-5)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])
    je, te = jt.evaluate(x, y, batch_size=16), tt.evaluate(x, y, batch_size=16)
    assert te["loss"] == pytest.approx(je["loss"], abs=1e-5)
    assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-6)
    untrained, _ = _torch_trainer(sd, ht.DistributedOptimizer(ht.adam(lr)))
    untrained.build()
    assert te["loss"] < untrained.evaluate(x, y, batch_size=16)["loss"]


# -- the data-parallel identity, two gloo ranks -------------------------------------


DP_CHILD = MLP_SRC + r'''
import functools, os
import numpy as np
import horovod_tpu_torch as ht

ht.init(device="cpu")
r = ht.rank()
data = np.load(os.path.join(os.environ["OUT"], "data.npz"))
b = data["x"].shape[1] // 2
batches = [(x[r * b:(r + 1) * b], y[r * b:(r + 1) * b])
           for x, y in zip(data["x"], data["y"])]
model = MLP()
trainer = ht.Trainer(
    model, ht.DistributedOptimizer(functools.partial(torch.optim.SGD, lr=0.1)),
    device="cpu")
trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
            callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
np.savez(os.path.join(os.environ["OUT"], f"rank{r}.npz"),
         losses=np.array([e["loss"] for e in trainer.history]),
         **{n: p.detach().numpy() for n, p in model.named_parameters()})
ht.shutdown()
'''


def test_two_ranks_equal_one_rank_with_the_concatenated_batch(tmp_path):
    """Mean loss → the mean over 2b rows is the average of the two ranks'
    means, so after 5 SGD steps the two ranks hold identical params equal
    to one rank's on the whole batch within 1e-6 abs (f32 summation
    order), and MetricAverageCallback's epoch loss equals the one-rank
    loss within 1e-6."""
    steps, b = 5, 4
    batches = _batches(steps, 2 * b, seed=3)
    np.savez(tmp_path / "data.npz", x=np.stack([x for x, _ in batches]),
             y=np.stack([y for _, y in batches]))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-c", DP_CHILD]
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
    model = MLP()
    trainer = ht.Trainer(model, ht.DistributedOptimizer(
        functools.partial(torch.optim.SGD, lr=0.1)), device="cpu")
    hist = trainer.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                       verbose=0)
    for name, p in model.named_parameters():
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
        np.testing.assert_allclose(ranks[0][name], p.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert np.array_equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], [e["loss"] for e in hist],
                               atol=1e-6, rtol=0)
