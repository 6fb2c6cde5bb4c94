"""Both MNIST entry scripts of the port (`horovod_tpu_torch.examples`)
end to end under the port's launcher: two gloo ranks on the CPU, with the
scripts' own DRIVE_* cuts. Each must exit 0, leave rank 0's artifacts
(checkpoints, ``events.jsonl``, TensorBoard events, ``metrics.jsonl``)
written once — a second writer would double the shared records — and end
with both ranks' training states bit-identical; the tf1 script's test loss
must be finite and its serving bundle present. A resumed tf2 run continues
from the newest checkpoint. The tf1 run's artifacts also go through the
checks of `chip_smoke.py`'s phase 9 (resume bit for bit, the bundle's
parameters and probabilities), which must refuse the previous epoch's
state.
"""

import json
import math
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.data import datasets
from horovod_tpu_torch.models.cnn import MnistCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
TIMEOUT_S = 60


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One synthesized MNIST cache under every name the scripts read."""
    d = tmp_path_factory.mktemp("mnist")
    datasets.mnist(cache_dir=str(d))
    for name in ("mnist-0.npz", "mnist-1.npz"):
        shutil.copy(d / "mnist.npz", d / name)
    return str(d)


def _launch(script, model_path, data_dir, **cut):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-m",
           f"horovod_tpu_torch.examples.{script}"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               HVT_DEVICE="cpu", PS_MODEL_PATH=str(model_path),
               HVT_DATA_DIR=data_dir, **cut)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{script} timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return out.splitlines()


def _rank0(lines, prefix):
    return next(line.split(prefix, 1)[1].strip() for line in lines
                if line.startswith(f"[rank 0] {prefix}"))


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_rank0_artifacts(model_dir, log_dir, metrics_path, epochs, steps,
                            runs=1):
    names = sorted(os.listdir(model_dir))
    for e in range(1, epochs + 1):
        for suffix in ("", ".sha256", ".meta.json"):
            assert f"checkpoint-{e}.pt{suffix}" in names
    records = _jsonl(os.path.join(log_dir, "events.jsonl"))
    assert sum("epoch/loss" in r for r in records) == epochs
    assert sum("batch/loss" in r for r in records) == epochs * steps
    assert len([n for n in os.listdir(log_dir)
                if n.startswith("events.out.tfevents.")]) == runs
    losses = [r for r in _jsonl(metrics_path) if r["name"] == "loss"]
    return records, losses


def _assert_equal_ranks(lines):
    digests = _rank0(lines, "State digests:").split()
    assert len(digests) == 2 and digests[0] == digests[1]
    assert "backend='gloo'" in _rank0(lines, "World:")
    assert not any(line.startswith("[rank 1] Epoch") for line in lines)


def test_tf2_twin_two_ranks_and_resume(tmp_path, data_dir):
    lines = _launch("tf2_style_mnist", tmp_path, data_dir,
                    DRIVE_STEPS="3", DRIVE_EPOCHS="2")
    _assert_equal_ranks(lines)
    model_dir = os.path.join(tmp_path, "horovod-mnist")
    records, losses = _assert_rank0_artifacts(
        model_dir, model_dir, os.path.join(tmp_path, "metrics.jsonl"), 2, 3)
    assert len(losses) == 2  # the epoch losses, pushed once
    assert [line.split()[-1] for line in lines
            if "LearningRateWarmup:" in line] == ["0.5000", "0.6667"]
    # A relaunch with a longer budget resumes at epoch 2.
    lines = _launch("tf2_style_mnist", tmp_path, data_dir,
                    DRIVE_STEPS="3", DRIVE_EPOCHS="3")
    assert "Resuming from checkpoint epoch 2" in "\n".join(lines)
    _assert_equal_ranks(lines)
    _assert_rank0_artifacts(model_dir, model_dir,
                            os.path.join(tmp_path, "metrics.jsonl"), 3, 3,
                            runs=2)


def test_tf1_twin_two_ranks(tmp_path, data_dir):
    lines = _launch("tf1_style_mnist", tmp_path, data_dir, DRIVE_EPOCHS="2",
                    DRIVE_TRAIN_N="1024", DRIVE_EVAL_N="256")
    _assert_equal_ranks(lines)
    model_dir = os.path.join(tmp_path, "horovod-mnist")
    records, losses = _assert_rank0_artifacts(
        model_dir, os.path.join(model_dir, "eval"),
        os.path.join(tmp_path, "metrics.jsonl"), 2, 4)
    assert sum("epoch/val_accuracy" in r for r in records) == 2
    # Two epoch losses and the final test loss, each pushed once.
    assert len(losses) == 3
    test_loss = float(_rank0(lines, "Test loss:"))
    assert math.isfinite(test_loss) and losses[-1]["value"] == test_loss
    bundle = _rank0(lines, "Exported serving bundle:")
    assert sorted(os.listdir(bundle)) == [
        "model.pt2", "model.pt2.sha256", "signature.json",
        "signature.json.sha256"]
    assert os.path.exists(os.path.join(model_dir, "keras-sample-model.pt"))
    # chip_smoke.py's phase-9 checks on this run's artifacts: the newest
    # checkpoint restores the final state bit for bit, and the bundle holds
    # and computes it; the previous epoch's state is refused by both.
    (_, _), (x_test, _) = datasets.mnist(cache_dir=data_dir)
    probe = chip_smoke._serving_probe(
        (x_test[:256].astype(np.float32) / 255.0)[..., None])
    trainer = ht.Trainer(MnistCNN(device="cpu"),
                         ht.DistributedOptimizer(ht.adadelta(1.0)),
                         loss="categorical_crossentropy", device="cpu")
    trainer.build()
    _, epoch = checkpoint.restore_latest_and_broadcast(model_dir,
                                                       trainer.state)
    assert epoch == 2
    assert checkpoint.state_digest(trainer.state) == _rank0(
        lines, "State digests:").split()[0]
    figures = chip_smoke.check_serving(trainer, bundle, probe, "cpu")
    assert figures["serve_entries_compared_rel"] > len(probe)
    checkpoint.restore(os.path.join(model_dir, "checkpoint-1.pt"),
                       trainer.state)
    assert checkpoint.state_digest(trainer.state) != _rank0(
        lines, "State digests:").split()[0]
    with pytest.raises(chip_smoke.SmokeFailure, match="parameters"):
        chip_smoke.check_serving(trainer, bundle, probe, "cpu")
