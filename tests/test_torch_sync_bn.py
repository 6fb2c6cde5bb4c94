"""Global-batch BatchNorm (sync-BN) in the port: two gloo ranks at batch b
each equal one rank at batch 2b — the statistics the JAX step takes over
every chip's rows. Each BN layer all-reduces its ``[mean, mean of squares]``
forward and the incoming gradient backward
(`collectives.allreduce_mean_differentiable`); with the optimizer's
gradient averaging, each rank's update is the gradient of the global-batch
loss.

Checked through the launcher: a depth-8 `ResNetCIFAR`'s train-mode logits
(each rank's rows), averaged gradients and updated running statistics after
one forward/backward; then four `Trainer.fit` steps (SGD) — parameters,
running statistics and the epoch losses. The ranks also report that the
step runner steps eagerly under gloo for such a module (its all-reduces sit
inside the forward and the backward) and count it. In-process: a world of
one makes no collective call, and eval mode none at any size.

Tolerance: 2e-6 abs on logits, gradients and statistics after one step, and
on parameters, statistics and losses after four SGD steps (f32, the same
sums split over two ranks and added in another order: measured ≤ 7.8e-7).
"""

import functools
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as ht
from horovod_tpu_torch.models.resnet import BatchNorm, ResNetCIFAR
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.training.graphs import (StepRunner,
                                               forward_communicates_over_host)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90
ATOL = 2e-6
B, STEPS, SIDE = 4, 4, 16

CHILD = r'''
import functools, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch.models.resnet import ResNetCIFAR
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.training.graphs import forward_communicates_over_host

ht.init(device="cpu")
r, out = ht.rank(), os.environ["OUT"]
data = np.load(os.path.join(out, "data.npz"))
b = data["x"].shape[1] // 2
mine = slice(r * b, (r + 1) * b)

# One forward/backward of the bare module; gradients averaged as the
# optimizer averages them.
model = ResNetCIFAR(depth=8, device="cpu", seed=1)
logits = model(torch.from_numpy(data["x"][0][mine]), train=True)
F.cross_entropy(logits, torch.from_numpy(data["y"][0][mine])).backward()
first = {"logits": logits.detach().numpy()}
first.update({"grad." + n: collectives.allreduce(p.grad).numpy()
              for n, p in model.named_parameters()})
first.update({"buf." + n: t.numpy() for n, t in model.named_buffers()})
np.savez(os.path.join(out, f"first{r}.npz"), **first)

# Trainer.fit, SGD, one batch a step.
model = ResNetCIFAR(depth=8, device="cpu", seed=2)
trainer = ht.Trainer(model, ht.DistributedOptimizer(
    functools.partial(torch.optim.SGD, lr=0.1)), device="cpu")
batches = [(x[mine], y[mine]) for x, y in zip(data["x"], data["y"])]
trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
            callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
np.savez(os.path.join(out, f"fit{r}.npz"),
         losses=np.array([e["loss"] for e in trainer.history]),
         eager_steps=trainer._runner.eager_steps,
         predicate=forward_communicates_over_host(model),
         predicate_mlp=forward_communicates_over_host(torch.nn.Linear(2, 2)),
         **{n: t.detach().numpy() for n, t in model.state_dict().items()})
ht.shutdown()
'''


def _data(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.rand(STEPS, 2 * B, SIDE, SIDE, 3).astype(np.float32)
    y = rng.randint(0, 10, (STEPS, 2 * B)).astype(np.int64)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    return x, y


def _launch(tmp_path):
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


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_bn")
    x, y = _data(tmp)
    _launch(tmp)
    return x, y, ([np.load(tmp / f"first{r}.npz") for r in range(2)],
                  [np.load(tmp / f"fit{r}.npz") for r in range(2)])


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


def test_one_step_equals_one_rank_at_twice_the_batch(two_ranks):
    x, y, (first, _) = two_ranks
    model = ResNetCIFAR(depth=8, device="cpu", seed=1)
    logits = model(torch.from_numpy(x[0]), train=True)
    F.cross_entropy(logits, torch.from_numpy(y[0])).backward()
    for r in range(2):
        _close(first[r]["logits"], logits.detach().numpy()[r * B:(r + 1) * B],
               f"rank {r} logits")
    for n, p in model.named_parameters():
        assert np.array_equal(first[0]["grad." + n], first[1]["grad." + n])
        _close(first[0]["grad." + n], p.grad.numpy(), n)
    for n, t in model.named_buffers():
        assert np.array_equal(first[0]["buf." + n], first[1]["buf." + n])
        _close(first[0]["buf." + n], t.numpy(), n)
    # The statistics really moved, and per-rank statistics would differ.
    local = ResNetCIFAR(depth=8, device="cpu", seed=1)
    local(torch.from_numpy(x[0][:B]), train=True)
    assert np.abs(local.bn.running_mean.numpy()
                  - first[0]["buf.bn.running_mean"]).max() > 100 * ATOL


def test_fit_equals_one_rank_at_twice_the_batch(two_ranks):
    """Parameters and running statistics after four SGD steps; the epoch
    losses (MetricAverageCallback: the mean of the two ranks' means)."""
    x, y, (_, fit) = two_ranks
    model = ResNetCIFAR(depth=8, device="cpu", seed=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(
        functools.partial(torch.optim.SGD, lr=0.1)), device="cpu")
    hist = trainer.fit(dataset=list(zip(x, y)), epochs=STEPS,
                       steps_per_epoch=1, verbose=0)
    sd = model.state_dict()
    assert any("running_var" in n for n in sd)
    for n, t in sd.items():
        assert np.array_equal(fit[0][n], fit[1][n]), n
        _close(fit[0][n], t.numpy(), n)
    _close(fit[0]["losses"], [e["loss"] for e in hist], "losses")
    assert np.array_equal(fit[0]["losses"], fit[1]["losses"])


def test_runner_steps_eagerly_under_gloo_and_counts_it(two_ranks):
    _, _, (_, fit) = two_ranks
    for r in range(2):
        assert bool(fit[r]["predicate"])
        assert not bool(fit[r]["predicate_mlp"])
        assert int(fit[r]["eager_steps"]) == STEPS
    # A world of one: no collective in the forward, so no reason to leave
    # the graph.
    assert not forward_communicates_over_host(
        ResNetCIFAR(depth=8, device="cpu"))


def _count_collectives(monkeypatch):
    calls = []
    monkeypatch.setattr(collectives, "allreduce_mean_differentiable",
                        lambda x: calls.append(x) or x)
    return calls


def test_a_world_of_one_makes_no_collective_call(monkeypatch):
    calls = _count_collectives(monkeypatch)
    model = ResNetCIFAR(depth=8, device="cpu")
    x = torch.rand(2, SIDE, SIDE, 3)
    F.cross_entropy(model(x, train=True), torch.tensor([1, 2])).backward()
    assert calls == []
    assert collectives.allreduce_mean_differentiable is not None
    trainer = ht.Trainer(ResNetCIFAR(depth=8, device="cpu"),
                         ht.adam(1e-3), device="cpu")
    trainer.train_step(x.numpy(), np.array([1, 2]))
    assert calls == []


def test_eval_mode_uses_running_statistics_and_communicates_nothing(
        monkeypatch):
    calls = _count_collectives(monkeypatch)
    monkeypatch.setattr("horovod_tpu_torch.runtime.size", lambda: 2)
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
        bn.running_var.copy_(torch.tensor([4.0, 0.25, 1.0]))
    x = torch.randn(2, 3, 4, 4)
    before = {k: t.clone() for k, t in bn.state_dict().items()}
    y = bn(x, train=False)
    assert calls == []
    want = (x - bn.running_mean[:, None, None]) * torch.rsqrt(
        bn.running_var + 1e-5)[:, None, None]
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    assert all(torch.equal(before[k], t) for k, t in bn.state_dict().items())
    bn(x, train=True)  # world of two: the moments go to the collective
    assert len(calls) == 1 and calls[0].shape == (2, 3)


def test_runner_counts_every_eager_step():
    trainer = ht.Trainer(ResNetCIFAR(depth=8, device="cpu"), ht.adam(1e-3),
                         device="cpu")
    trainer.build()
    runner = StepRunner(trainer, batch_size=2, max_steps=3)
    assert not runner.graphs
    runner.feed(torch.rand(6, SIDE, SIDE, 3), torch.tensor([0, 1, 2, 3, 4, 5]),
                2)
    runner.run(3)
    assert (runner.eager_steps, runner.captures, runner.replays) == (3, 0, 0)
