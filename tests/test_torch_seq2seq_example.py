"""The twin of ``examples/seq2seq_translation.py``
(`horovod_tpu_torch.examples.seq2seq_translation`) at small knobs
(``DOCS=256``, ``DRIVE_EPOCHS=1``) on the CPU, against the JAX script run
on the same knobs from the same weights (the twin's seed-0 weights through
`seq2seq_params_to_flax`):

* the twin reads the JAX script's knobs and prints its lines, ending with
  ``REVERSAL LEARNED`` or ``NOT LEARNED``;
* its tokenizer file and its encoded ``(src, tgt_in, labels)`` arrays are
  byte-equal to the JAX script's;
* its first step's loss (before any update) equals the JAX script's;
* ``HVT_MESH="data=4,model=2"`` raises naming ROADMAP item 18, and the twin
  refuses to fall back to the CPU silently (`tests/test_torch_isolation.py`).

Tolerance: both scripts compute in f32; the first loss within 1e-5
relative.
"""

import importlib.util
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu.data.tokenizer import ByteBPETokenizer as JTok
from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer as TTok
from horovod_tpu_torch.examples import seq2seq_translation as twin_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "horovod_tpu_torch", "examples",
                    "seq2seq_translation.py")
REF = os.path.join(REPO, "examples", "seq2seq_translation.py")
KNOBS = {"DOCS": "256", "DRIVE_EPOCHS": "1"}
TIMEOUT_S = 180
FIRST_LOSS_RTOL = 1e-5

TWIN_CHILD = r'''
import json, os
import numpy as np
import horovod_tpu_torch as hvt
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.examples import seq2seq_translation as twin
from horovod_tpu_torch.models.convert import seq2seq_params_to_flax

first = []


class First(callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        if not first:
            first.append(float(logs["loss"]))


fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    np.savez(os.environ["WEIGHTS"], tree=np.array(seq2seq_params_to_flax(
        self.module.state_dict(), self.module), dtype=object))
    kwargs["callbacks"] = list(kwargs.get("callbacks", [])) + [First()]
    return fit(self, *args, **kwargs)


hvt.Trainer.fit = recorded_fit
twin.main()
print("FIRST", json.dumps(first), flush=True)
'''

JAX_CHILD = r'''
import json, os, runpy
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)  # one data shard, as the twin
import flax.linen as nn
import numpy as np
import horovod_tpu as hvt

weights = np.load(os.environ["WEIGHTS"], allow_pickle=True)["tree"].item()
init = nn.Module.init


def seeded_init(self, *args, **kwargs):
    variables = init(self, *args, **kwargs)
    if type(self).__name__ == "Seq2SeqTransformer":
        variables = dict(variables, params=weights)
    return variables


nn.Module.init = seeded_init
first = []


class First(hvt.callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        if not first:
            first.append(float(logs["loss"]))


fit = hvt.Trainer.fit


def recorded_fit(self, *args, **kwargs):
    kwargs["callbacks"] = list(kwargs.get("callbacks", [])) + [First()]
    return fit(self, *args, **kwargs)


hvt.Trainer.fit = recorded_fit
runpy.run_path(os.environ["SCRIPT"], run_name="__main__")
print("FIRST", json.dumps(first), flush=True)
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


def _first(out):
    line = re.search(r"FIRST (\[.*\])", out)
    assert line, out[-4000:]
    return json.loads(line.group(1))


def _lines(out):
    """The scripts' own lines, in order, without the epoch logs' numbers."""
    keep = ("dropped ", "byte-BPE vocab", "src:", "out:", "held-out",
            "REVERSAL")
    return [ln for ln in out.splitlines() if ln.startswith(keep)]


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_seq2seq_example", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_prints_the_jax_lines_from_the_same_data(tmp_path):
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **KNOBS)
    weights = str(tmp_path / "weights.npz")
    t_out = _run([sys.executable, "-c", TWIN_CHILD], dict(
        base, HVT_DEVICE="cpu", WEIGHTS=weights,
        PS_MODEL_PATH=str(tmp_path / "twin")))
    j_env = dict(base, WEIGHTS=weights, SCRIPT=REF, JAX_PLATFORMS="cpu",
                 PS_MODEL_PATH=str(tmp_path / "jax"))
    j_env["XLA_FLAGS"] = re.sub(r"--xla_force_host_platform_device_count=\d+",
                                "", j_env.get("XLA_FLAGS", ""))
    j_out = _run([sys.executable, "-c", JAX_CHILD], j_env)
    t_lines, j_lines = _lines(t_out), _lines(j_out)
    assert [ln.split(":")[0].split(" ")[0] for ln in t_lines] == \
        [ln.split(":")[0].split(" ")[0] for ln in j_lines]
    assert t_lines[0] == j_lines[0]  # the vocab and the pair count
    assert re.fullmatch(r"held-out reversal token accuracy: \d\.\d{3}",
                        t_lines[-2])
    assert re.fullmatch(r"REVERSAL (NOT )?LEARNED", t_lines[-1])
    # The tokenizer file, byte for byte.
    t_tok = tmp_path / "twin" / "seq2seq-reversal" / "tokenizer.json"
    j_tok = tmp_path / "jax" / "seq2seq-reversal" / "tokenizer.json"
    assert t_tok.read_bytes() == j_tok.read_bytes()
    # The encoded arrays, byte for byte, through each side's own code.
    jex = _jax_example()
    pairs = twin_mod.corpus(int(KNOBS["DOCS"]))
    assert pairs == jex.corpus(int(KNOBS["DOCS"]))
    t_arrays = twin_mod.encode_pairs(TTok.load(str(t_tok)), pairs, 16)
    j_arrays = jex.encode_pairs(JTok.load(str(j_tok)), pairs, 16)
    for a, b in zip(t_arrays, j_arrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # The first step's loss, from the same weights on the same batch.
    got, want = _first(t_out), _first(j_out)
    assert len(got) == len(want) == 1
    assert abs(got[0] - want[0]) <= FIRST_LOSS_RTOL * abs(want[0]), (
        got, want)


def test_a_live_model_axis_is_refused(monkeypatch):
    monkeypatch.setenv("HVT_MESH", "data=4,model=2")
    monkeypatch.setenv("HVT_DEVICE", "cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        twin_mod.main()
