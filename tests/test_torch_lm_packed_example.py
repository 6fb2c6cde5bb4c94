"""The twin of ``examples/lm_packed_pretraining.py``
(`horovod_tpu_torch.examples.lm_packed_pretraining`) at its default width
with ``HVT_MESH="data=1,seq=2"``: two gloo ranks on the CPU, attention the
flash ring over the ``seq`` group (its plain versions here). It prints the
JAX script's lines and ``LEARNING``, and its first loss equals the JAX
script's first loss on the same corpus, run on a ``data=1,seq=2`` mesh of
two CPU devices from the same weights (the port's seed-0 weights converted
to the flax tree). One step an epoch, so the first epoch's loss is the
loss before any update.

Tolerance: both sides compute in bf16 (the scripts' ``compute_dtype``)
and sum in f32; the masked loss of the first batch within 1e-3 relative.
"""

import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "horovod_tpu_torch", "examples",
                    "lm_packed_pretraining.py")
REF = os.path.join(REPO, "examples", "lm_packed_pretraining.py")
KNOBS = {"HVT_MESH": "data=1,seq=2", "DRIVE_EPOCHS": "4", "DRIVE_STEPS": "1"}
TIMEOUT_S = 240
FIRST_LOSS_RTOL = 1e-3

JAX_CHILD = r'''
import json, os, runpy
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
import flax.linen as nn
import numpy as np
import horovod_tpu as hvt

weights = np.load(os.environ["WEIGHTS"], allow_pickle=True)["tree"].item()
init = nn.Module.init


def seeded_init(self, *args, **kwargs):
    variables = init(self, *args, **kwargs)
    if type(self).__name__ == "PackedLM":
        variables = dict(variables, params={"inner": weights})
    return variables


nn.Module.init = seeded_init
history = []
fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    history.extend(fit(self, *args, **kwargs))
    return history


hvt.Trainer.fit = recorded_fit
runpy.run_path(os.environ["SCRIPT"], run_name="__main__")
print("HISTORY", json.dumps([e["loss"] for e in history]), flush=True)
'''

TWIN_CHILD = r'''
import json
from horovod_tpu_torch.examples.lm_packed_pretraining import main
history = main()
print("HISTORY", json.dumps([e["loss"] for e in history]), flush=True)
'''


def _knobs(path):
    with open(path) as f:
        return set(re.findall(r'os\.environ\.get\("([A-Z_]+)"', f.read()))


def test_twin_reads_the_reference_knobs():
    assert _knobs(REF) and _knobs(TWIN) == _knobs(REF)


def _run(cmd, env):
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out[-4000:]
    return out


def _history(out):
    line = re.search(r"HISTORY (\[.*\])", out)
    assert line, out[-4000:]
    return json.loads(line.group(1))


def test_twin_learns_on_a_seq_mesh_and_starts_at_jax_loss(tmp_path):
    model = ttr.TransformerLM(vocab_size=64, d_model=128, n_heads=4,
                              n_layers=2, dropout=0.0,
                              compute_dtype=torch.bfloat16, device="cpu")
    np.savez(tmp_path / "weights.npz", tree=np.array(
        params_to_flax(model.state_dict(), n_heads=4), dtype=object))
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                PS_MODEL_PATH=str(tmp_path), **KNOBS)
    twin = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launch", "run", "--nprocs",
         "2", "--", sys.executable, "-c", TWIN_CHILD], cwd=REPO,
        env=dict(base, HVT_DEVICE="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    ref = _history(_run([sys.executable, "-c", JAX_CHILD], dict(
        base, WEIGHTS=str(tmp_path / "weights.npz"), SCRIPT=REF,
        JAX_PLATFORMS="cpu")))
    try:
        out, _ = twin.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(twin.pid, signal.SIGKILL)
        out, _ = twin.communicate()
        pytest.fail(f"the twin timed out after {TIMEOUT_S} s:\n{out}")
    assert twin.returncode == 0, out[-4000:]
    got = _history(out)
    assert re.search(r"\[rank 0\] packed 2000 docs -> \d+ rows x 257, "
                     r"occupancy [\d.]+", out)
    assert re.search(r"\[rank 0\] masked loss: [\d.]+ -> [\d.]+", out)
    assert "[rank 0] packed pretraining: LEARNING" in out
    assert len(got) == len(ref) == int(KNOBS["DRIVE_EPOCHS"])
    assert abs(got[0] - ref[0]) <= FIRST_LOSS_RTOL * abs(ref[0]), (got, ref)
