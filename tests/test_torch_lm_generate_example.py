"""The twin of ``examples/lm_generate.py`` (`horovod_tpu_torch.examples.
lm_generate`) at tiny knobs on the CPU: it trains, checkpoints, generates
greedy, streamed (ring cache + sinks), sampled and speculative output, and
exits 0 only when the speculative output equals plain greedy. It reads the
same knobs as the JAX script (plus ``HVT_DEVICE``).
"""

import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "horovod_tpu_torch", "examples", "lm_generate.py")
TINY = {"HVT_DEVICE": "cpu", "DRIVE_EPOCHS": "2", "DRIVE_STEPS": "4",
        "SEQ_LEN": "32", "DMODEL": "32", "NLAYERS": "2", "KV_HEADS": "4",
        "GAMMA": "4", "STREAM": "1", "WINDOW": "6", "SINKS": "2",
        "TOP_K": "8"}


def _knobs(path):
    with open(path) as f:
        return set(re.findall(r'os\.environ\.get\("([A-Z_]+)"', f.read()))


def test_twin_reads_the_reference_knobs():
    ref = _knobs(os.path.join(REPO, "examples", "lm_generate.py"))
    assert ref and _knobs(TWIN) == ref | {"HVT_DEVICE"}


def test_twin_runs_at_tiny_knobs(tmp_path):
    env = dict(os.environ, PS_MODEL_PATH=str(tmp_path), **TINY)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.lm_generate"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert len(re.findall(r"^Epoch \d/2", out, re.M)) == 2
    assert re.search(r"^final train loss: \d", out, re.M)
    assert re.search(r"^greedy recall of the copied half: [\d.]+%", out, re.M)
    assert re.search(r"^streamed generation \(2 sinks \+ 6-slot ring\)", out,
                     re.M)
    tail = re.search(r"^sampled tail: \[(.*)\]$", out, re.M)
    assert tail and len(tail.group(1).split(",")) == 8
    assert "outputs identical: True" in out
    ckpt = tmp_path / "lm-generate" / "checkpoint-final.pt"
    assert ckpt.exists()
    state = torch.load(ckpt, weights_only=False)
    assert state is not None
