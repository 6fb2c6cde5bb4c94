"""The CIFAR-10 entry script of the port
(`horovod_tpu_torch.examples.cifar10_resnet`) end to end under the port's
launcher: two gloo ranks on the CPU at the script's own DRIVE_* cuts, for
both architectures (``ARCH=resnet``, the default, and ``ARCH=vit``). Each
run must exit 0 and leave rank 0's artifacts written once (per-epoch
checkpoints with their sidecars, ``events.jsonl``, one TensorBoard file,
``metrics.jsonl`` with the epoch losses and the test loss); both ranks end
with bit-identical training states — for the ResNet, running statistics
included, which only agree because BN takes global-batch statistics; and
the test loss is finite.
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
import torch

from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.data import datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
STEPS, EPOCHS, EVAL_N = 2, 2, 64


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One synthesized CIFAR cache under every name the ranks read."""
    d = tmp_path_factory.mktemp("cifar")
    datasets.cifar10(cache_dir=str(d))
    for name in ("cifar10-0.npz", "cifar10-1.npz"):
        shutil.copy(d / "cifar10.npz", d / name)
    return str(d)


def _launch(model_path, data_dir, arch):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-m",
           "horovod_tpu_torch.examples.cifar10_resnet"]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO,
               HVT_DEVICE="cpu", PS_MODEL_PATH=str(model_path),
               HVT_DATA_DIR=data_dir, ARCH=arch, DRIVE_STEPS=str(STEPS),
               DRIVE_EPOCHS=str(EPOCHS), DRIVE_EVAL_N=str(EVAL_N))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{arch} timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return out.splitlines()


def _rank0(lines, prefix):
    return next(line.split(prefix, 1)[1].strip() for line in lines
                if line.startswith(f"[rank 0] {prefix}"))


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_twin_two_ranks(tmp_path, data_dir, arch):
    lines = _launch(tmp_path, data_dir, arch)
    assert "backend='gloo'" in _rank0(lines, "World:")
    digests = _rank0(lines, "State digests:").split()
    assert len(digests) == 2 and digests[0] == digests[1]
    assert not any(line.startswith("[rank 1] Epoch") for line in lines)
    assert [line.split()[-1] for line in lines
            if "LearningRateWarmup:" in line] == ["0.5000", "0.6667"]
    test_loss = float(_rank0(lines, "Test loss:"))
    assert math.isfinite(test_loss)
    assert 0.0 <= float(_rank0(lines, "Test accuracy:")) <= 1.0

    model_dir = tmp_path / "horovod-cifar"
    names = sorted(os.listdir(model_dir))
    for e in range(1, EPOCHS + 1):
        for suffix in ("", ".sha256", ".meta.json"):
            assert f"checkpoint-{e}.pt{suffix}" in names
    records = _jsonl(model_dir / "events.jsonl")
    assert sum("epoch/loss" in r for r in records) == EPOCHS
    assert len([n for n in names
                if n.startswith("events.out.tfevents.")]) == 1
    losses = [r for r in _jsonl(tmp_path / "metrics.jsonl")
              if r["name"] == "loss"]
    assert len(losses) == EPOCHS + 1 and losses[-1]["value"] == test_loss

    # The newest checkpoint holds the final state, running statistics
    # included for the ResNet.
    payload = torch.load(model_dir / f"checkpoint-{EPOCHS}.pt",
                         weights_only=False)
    stats = [k for k in payload["model"] if k.endswith("running_var")]
    assert bool(stats) == (arch == "resnet")
    for k in stats:
        assert not torch.equal(payload["model"][k],
                               torch.ones_like(payload["model"][k])), k
    assert checkpoint.checkpoint_intact(
        str(model_dir / f"checkpoint-{EPOCHS}.pt"))
    assert np.isfinite([r["epoch/loss"] for r in records
                        if "epoch/loss" in r]).all()
