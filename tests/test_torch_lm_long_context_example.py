"""The port's twin of ``examples/lm_long_context.py``
(`horovod_tpu_torch.examples.lm_long_context`), through the port's launcher
at four gloo ranks on the CPU, its ``main()`` run three times in one
launch:

* ``HVT_MESH="data=1,seq=2,model=2"`` (the flash ring over the local
  heads, the logits gathered over ``model``) and ``HVT_MESH="data=2,
  fsdp=2"`` with ``FUSED_CE=2`` (the fused head over the gathered weight),
  each for 2 epochs of 4 steps at a small width: the epoch loss falls,
  every rank ends with the same history, and rank 0 prints the recall
  report (``first-half``, ``recall-half``, the verdict) and the greedy
  decode's exact match, decoded from the gathered parameters;
* ``MOE_EVERY=2`` on ``data=2,model=2`` raises naming ROADMAP item 18.

In process: ``HVT_MESH="data=2,pipe=2"`` raises naming ROADMAP item 12.4
(the pipeline) before any rank starts, and `data.datasets.copy_task` is
byte-equal to the JAX package's for the script's seeds 0 and 99 at its
default shapes.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu.data import datasets as jds
from horovod_tpu_torch.data import datasets as tds
from horovod_tpu_torch.examples import lm_long_context as twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
KNOBS = dict(SEQ_LEN="32", VOCAB="16", DMODEL="32", NLAYERS="2",
             DRIVE_STEPS="4", DRIVE_EPOCHS="2", HVT_DEVICE="cpu")
RUNS = {"seq_model": {"HVT_MESH": "data=1,seq=2,model=2"},
        "fsdp": {"HVT_MESH": "data=2,fsdp=2", "FUSED_CE": "2"}}

CHILD = r'''
import json, os
import numpy as np
import horovod_tpu_torch as ht
from horovod_tpu_torch.examples import lm_long_context as twin

out = os.environ["OUT"]
res = {}
for name, env in json.loads(os.environ["RUNS"]).items():
    os.environ.update(env)
    got = twin.main()
    res[name + ".losses"] = np.array([e["loss"] for e in got["history"]])
    res[name + ".report"] = np.array([got["context_loss"],
                                      got["recall_loss"]])
    if got["exact_match"] is not None:
        res[name + ".exact"] = np.array(got["exact_match"])
    for k in env:
        del os.environ[k]
os.environ.update(HVT_MESH="data=2,model=2", MOE_EVERY="2")
try:
    twin.main()
    res["moe_refusal"] = ""
except NotImplementedError as e:
    res["moe_refusal"] = str(e)
np.savez(os.path.join(out, f"rank{ht.rank()}.npz"), **res)
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("lm_long_context")
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), RUNS=json.dumps(RUNS),
               PS_MODEL_PATH=str(tmp / "models"), **KNOBS)
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
    return dict(out=out, ranks=[dict(np.load(tmp / f"rank{r}.npz"))
                                for r in range(NPROCS)])


@pytest.mark.parametrize("name", list(RUNS))
def test_twin_learns_and_reports(run, name):
    ranks = run["ranks"]
    losses = ranks[0][name + ".losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    for res in ranks:
        np.testing.assert_array_equal(res[name + ".losses"], losses)
        np.testing.assert_array_equal(res[name + ".report"],
                                      ranks[0][name + ".report"])
    exact = float(ranks[0][name + ".exact"])
    assert 0.0 <= exact <= 1.0
    assert all(name + ".exact" not in res for res in ranks[1:])


def test_report_lines_printed_by_rank_0(run):
    out = run["out"]
    for line in ("first-half (irreducible) loss:", "recall-half loss:",
                 "long-range recall:", "greedy-decode recall exact-match:"):
        assert out.count(f"[rank 0] {line}") == len(RUNS), line
        assert f"[rank 1] {line}" not in out, line


def test_moe_on_a_model_axis_refused_naming_item_18(run):
    for res in run["ranks"]:
        assert "item 18" in str(res["moe_refusal"])


def test_pipe_axis_refused_naming_12_4(monkeypatch):
    monkeypatch.setenv("HVT_MESH", "data=2,pipe=2")
    monkeypatch.setenv("HVT_DEVICE", "cpu")
    with pytest.raises(NotImplementedError, match=r"item 12\.4 \(the pipe"):
        twin.main()


@pytest.mark.parametrize("n,seed", [(4096, 0), (64, 99)])
def test_copy_task_byte_equal_to_jax(n, seed):
    for a, b in zip(tds.copy_task(n, 512, vocab_size=64, seed=seed),
                    jds.copy_task(n, 512, vocab_size=64, seed=seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
