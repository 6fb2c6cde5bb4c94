"""Real (tiny) torch training under the port's launch layer, on the CPU —
the counterpart of ``tests/test_supervisor.py``'s supervised smoke:

* ``HVT_FAULT=0:1:exit1`` plus a stamp under `supervise_local`: exactly one
  ``crash`` restart, journaled with progress, the relaunch resumes from
  epoch 1's checkpoint, and the final training state equals an unfaulted
  run's bit for bit (`checkpoint.state_digest`);
* ``HVT_FAULT=0:2:corrupt``: the relaunch skips the damaged checkpoint
  and resumes from the previous intact one, ending in the clean state;
* ``PreemptionCheckpointCallback`` at two gloo ranks: a SIGTERM to rank 1
  (``HVT_FAULT=1:1:leave``) stops both ranks at the same epoch, the
  preemption checkpoint is saved, and the launch exits 143, which the
  supervisor classifies ``preemption``;
* (``slow``) the port's real ``mnist-ci-2proc.yaml`` through ``job``.
"""

import os
import subprocess
import sys

import pytest

from horovod_tpu_torch.launch import ci_gate, specfile, supervisor
from horovod_tpu_torch.launch.supervisor import RestartPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SLEEP = lambda s: None  # noqa: E731 — backoff without wall-clock
TIMEOUT_S = 120

# A tiny trainer with the examples' resume idiom: MnistCNN on 64 seeded
# noise images, 3 epochs × 2 steps of 8, rank-0 checkpoints, state digest.
TRAIN_SCRIPT = r"""
import os, sys
import numpy as np
import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.parallel import collectives

model_dir = os.path.join(os.environ["PS_MODEL_PATH"], "run")
os.makedirs(model_dir, exist_ok=True)
hvt.init(device="cpu")
rng = np.random.RandomState(0)
x = rng.rand(64, 28, 28, 1).astype("float32")
y = (np.arange(64) % 10).astype("int64")
trainer = hvt.Trainer(MnistCNN(device="cpu"),
                      hvt.DistributedOptimizer(hvt.adam(1e-3)),
                      loss="sparse_categorical_crossentropy", device="cpu")
trainer.build(x[:1])
trainer.state, done = checkpoint.restore_latest_and_broadcast(
    model_dir, trainer.state)
if done and hvt.rank() == 0:
    print(f"Resuming from checkpoint epoch {done}", flush=True)
template = os.path.join(model_dir, "checkpoint-{epoch}.pt")


class Epochs(hvt.callbacks.Callback):
    def on_epoch_end(self, epoch, logs=None):
        with open(os.path.join(os.environ["PS_MODEL_PATH"],
                               f"epochs-{hvt.rank()}"), "a") as f:
            f.write(f"{epoch}\n")


cbs = [hvt.callbacks.BroadcastGlobalVariablesCallback(0), Epochs()]
if os.environ.get("PREEMPTIBLE"):
    cbs.append(hvt.callbacks.PreemptionCheckpointCallback(template,
                                                          exit_code=143))
if hvt.rank() == 0:
    cbs.append(hvt.callbacks.ModelCheckpoint(template))
trainer.fit(x=x, y=y, batch_size=8, epochs=3, initial_epoch=done,
            steps_per_epoch=2, callbacks=cbs, verbose=0)
digests = collectives.allgather_object(checkpoint.state_digest(trainer.state))
if hvt.rank() == 0:
    print("State digests:", " ".join(digests), flush=True)
hvt.shutdown()
"""


def _argv(tmp_path):
    path = tmp_path / "train.py"
    path.write_text(TRAIN_SCRIPT)
    return [sys.executable, str(path)]


def _env(model_dir, **extra):
    return {"PS_MODEL_PATH": str(model_dir), "PYTHONPATH": REPO,
            "OMP_NUM_THREADS": "1", "HVT_NO_NATIVE": "1", **extra}


def _run(argv, env, nprocs=1):
    """One launch through the CLI in a subprocess; (rc, output)."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", *argv]
    proc = subprocess.run(cmd, cwd=REPO, env=dict(os.environ, **env),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr


def _digests(out):
    line = next(ln for ln in out.splitlines() if "State digests:" in ln)
    return line.split("State digests:")[1].split()


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The unfaulted run's state digests."""
    d = tmp_path_factory.mktemp("clean")
    rc, out = _run(_argv(d), _env(d / "m"))
    assert rc == 0, out
    return _digests(out)


def test_supervised_exit1_restarts_once_and_resumes_bit_equal(tmp_path,
                                                              capfd, clean):
    argv = _argv(tmp_path)
    model_dir = tmp_path / "faulted"
    log = model_dir / "restarts.jsonl"
    code = supervisor.supervise_local(
        1, argv, env=_env(model_dir, HVT_FAULT="0:1:exit1",
                          HVT_FAULT_STAMP=str(tmp_path / "stamp")),
        policy=RestartPolicy(max_restarts=2, backoff=0.0, grace_seconds=5.0),
        sleep=NO_SLEEP)
    out = capfd.readouterr().out
    assert code == 0, out
    restarts = [r for r in supervisor.journal_records(str(log))
                if r["name"] == "restarts"]
    assert len(restarts) == 1
    assert restarts[0]["kind"] == "crash" and restarts[0]["exit_code"] == 1
    assert restarts[0]["progressed"] is True
    ok, value = ci_gate.check_metrics(str(log), "restarts", (1.0, 1.0),
                                      how="count")
    assert ok and value == 1.0
    assert "FaultInjection: rank 0 firing 'exit1' at epoch 1" in out
    assert "Resuming from checkpoint epoch 1" in out
    assert _digests(out) == clean
    # The final scrape: one restart, three epochs × 2 steps committed.
    from horovod_tpu_torch.obs import prom

    dump = prom.parse_text((model_dir / "metrics.prom").read_text())
    assert dump["hvt_restarts_total"] == 1
    assert dump["hvt_committed_epoch"] == 3
    assert dump["hvt_committed_step"] == 6


def test_corrupt_checkpoint_resumes_from_the_previous_intact_one(tmp_path,
                                                                capfd,
                                                                clean):
    """``HVT_FAULT=0:2:corrupt``: the newest checkpoint (epoch 2's) is
    damaged, its ``.sha256`` and ``.meta.json`` untouched, and the rank is
    SIGKILLed (an ``oom-kill`` to the supervisor). The relaunch skips the
    corrupt file, resumes from epoch 1's and ends in the clean state."""
    argv = _argv(tmp_path)
    model_dir = tmp_path / "faulted"
    code = supervisor.supervise_local(
        1, argv, env=_env(model_dir, HVT_FAULT="0:2:corrupt",
                          HVT_FAULT_STAMP=str(tmp_path / "stamp")),
        policy=RestartPolicy(max_restarts=2, backoff=0.0, grace_seconds=5.0),
        sleep=NO_SLEEP)
    out = capfd.readouterr().out
    assert code == 0, out
    assert "FaultInjection: corrupting" in out and "checkpoint-2.pt" in out
    assert "Resuming from checkpoint epoch 1" in out
    restarts = [r for r in supervisor.journal_records(
        str(model_dir / "restarts.jsonl")) if r["name"] == "restarts"]
    assert [r["kind"] for r in restarts] == ["oom-kill"]
    assert _digests(out) == clean


def test_preemption_stops_both_ranks_at_one_epoch_and_exits_143(tmp_path):
    model_dir = tmp_path / "m"
    rc, out = _run(_argv(tmp_path),
                   _env(model_dir, HVT_FAULT="1:1:leave", PREEMPTIBLE="1",
                        HVT_FAULT_STAMP=str(tmp_path / "stamp")), nprocs=2)
    assert rc == 143, out
    assert supervisor.classify(rc) == "preemption"
    assert "FaultInjection: rank 1 firing 'leave' at epoch 1" in out
    assert "PreemptionCheckpoint: signal received — epoch 2 saved" in out
    for rank in (0, 1):
        assert (model_dir / f"epochs-{rank}").read_text().split() == \
            ["0", "1"]
    names = sorted(os.listdir(model_dir / "run"))
    assert "checkpoint-2.pt" in names and "checkpoint-3.pt" not in names
    # The relaunch resumes from the preemption checkpoint and finishes.
    rc, out = _run(_argv(tmp_path), _env(model_dir, PREEMPTIBLE="1",
                                         HVT_FAULT="1:1:leave",
                                         HVT_FAULT_STAMP=str(
                                             tmp_path / "stamp")), nprocs=2)
    assert rc == 0, out
    assert "Resuming from checkpoint epoch 2" in out
    assert len(set(_digests(out))) == 1


def test_sigterm_without_the_callback_is_a_preemption_death(tmp_path):
    """Outside the callback a `leave` is a SIGTERM death (exit -15 from
    Popen, 143 to a shell) — also classified ``preemption``."""
    code = supervisor.supervise_local(
        1, _argv(tmp_path),
        env=_env(tmp_path / "m", HVT_FAULT="0:0:leave",
                 HVT_FAULT_STAMP=str(tmp_path / "stamp")),
        policy=RestartPolicy(max_restarts=1, backoff=0.0, grace_seconds=5.0),
        tag_output=False, sleep=NO_SLEEP)
    assert code == 0
    restarts = [r for r in supervisor.journal_records(
        str(tmp_path / "m" / "restarts.jsonl")) if r["name"] == "restarts"]
    assert [(r["kind"], supervisor.shell_code(r["exit_code"]))
            for r in restarts] == [("preemption", 143)]


@pytest.mark.slow
def test_mnist_ci_2proc_job_passes_its_gates(tmp_path):
    """The port's real `mnist-ci-2proc.yaml` through `job` (two gloo ranks
    on the CPU, 40 × 6 steps): loss gate, restart journal, metrics gates.
    Slow: it trains the full CI cut (~minutes of CPU)."""
    from horovod_tpu_torch.launch import job

    src = os.path.join(REPO, "horovod_tpu_torch", "launch", "jobs",
                       "mnist-ci-2proc.yaml")
    text = open(src).read().replace("/tmp/hvt-ci-2proc-models",
                                    str(tmp_path / "models"))
    text = text.replace("status_port: 29740", "status_port: 0")
    spec = tmp_path / "job.yaml"
    spec.write_text(text)
    assert specfile.load(str(spec))["job"]["status_port"] == 0
    old = os.getcwd()
    os.chdir(REPO)
    try:
        assert job.run_job(str(spec)) == 0
    finally:
        os.chdir(old)
    records = supervisor.journal_records(
        str(tmp_path / "models" / "restarts.jsonl"))
    assert [r for r in records if r["name"] == "restarts"] == []
    from horovod_tpu_torch.obs import prom

    dump = prom.parse_text((tmp_path / "models" / "metrics.prom").read_text())
    assert dump["hvt_committed_step"] == 240  # 6 epochs × 40 steps
