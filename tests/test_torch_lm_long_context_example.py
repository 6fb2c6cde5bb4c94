"""The port's twin of ``examples/lm_long_context.py``
(`horovod_tpu_torch.examples.lm_long_context`), through the port's launcher
at four gloo ranks on the CPU, its ``main()`` run three times in one
launch:

* ``HVT_MESH="data=1,seq=2,model=2"`` (the flash ring over the local
  heads, the logits gathered over ``model``) and ``HVT_MESH="data=2,
  fsdp=2"`` with ``FUSED_CE=2`` (the fused head over the gathered weight),
  ``HVT_MESH="data=1,pipe=2,model=2" SCHEDULE=1f1b`` (the pipelined
  model, Megatron TP inside each stage) and ``HVT_MESH="data=1,pipe=2,
  seq=2" SCHEDULE=1f1b`` (pp × sp, the JAX script's third pipe mesh at
  four ranks: the flash ring inside each stage, each rank holding its
  column block of the batch), each for 2 epochs of 4 steps at
  a small width: the epoch loss falls, every rank ends with the same
  history, and rank 0 prints the recall report (``first-half``,
  ``recall-half``, the verdict) and, for the `TransformerLM` runs, the
  greedy decode's exact match, decoded from the gathered parameters (the
  JAX script decodes no pipelined model);
* ``MOE_EVERY=2 N_EXPERTS=4`` on ``data=1,expert=2,model=2`` (the MoE
  blocks' experts over ``expert``, their hidden features over ``model``)
  learns and reports like the others, and its first step's loss equals
  JAX's MoE `TransformerLM` on the batch the twin fed, from the same
  weights, within 1e-5 relative (f32 on both sides).

In process: `data.datasets.copy_task` is
byte-equal to the JAX package's for the script's seeds 0 and 99 at its
default shapes.
"""

import os
import signal
import subprocess
import sys

import jax
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
        "fsdp": {"HVT_MESH": "data=2,fsdp=2", "FUSED_CE": "2"},
        "pipe_model": {"HVT_MESH": "data=1,pipe=2,model=2",
                       "SCHEDULE": "1f1b"},
        "pipe_seq": {"HVT_MESH": "data=1,pipe=2,seq=2", "SCHEDULE": "1f1b"},
        "moe_model": {"HVT_MESH": "data=1,expert=2,model=2",
                      "MOE_EVERY": "2", "N_EXPERTS": "4",
                      "FIRST_BATCH": "1"}}
# The runs on the pipelined model, which JAX's script does not decode.
PIPELINED = ("pipe_model", "pipe_seq")

CHILD = r'''
import json, os
import numpy as np
import horovod_tpu_torch as ht
from horovod_tpu_torch.examples import lm_long_context as twin

out = os.environ["OUT"]
res = {}

# Each run's first step: its loss and (where FIRST_BATCH is set) the batch
# the feed handed over.
from horovod_tpu_torch.training import feeding
first = {}
fit, pipeline = ht.Trainer.fit, feeding.training_pipeline


class First(ht.callbacks.Callback):
    def on_batch_end(self, batch, logs=None):
        first.setdefault("loss", float(logs["loss"]))


def recorded_fit(self, *args, **kwargs):
    kwargs["callbacks"] = list(kwargs.get("callbacks", [])) + [First()]
    return fit(self, *args, **kwargs)


def kept(*args, **kwargs):
    it, close = pipeline(*args, **kwargs)

    def batches():
        for i, b in enumerate(it):
            if i == 0 and os.environ.get("FIRST_BATCH"):
                first["batch"] = b
            yield b
    return batches(), close


ht.Trainer.fit, feeding.training_pipeline = recorded_fit, kept
for name, env in json.loads(os.environ["RUNS"]).items():
    os.environ.update(env)
    first.clear()
    got = twin.main()
    res[name + ".first_loss"] = np.array(first["loss"])
    if "batch" in first:
        res[name + ".first_x"], res[name + ".first_y"] = first["batch"]
    res[name + ".losses"] = np.array([e["loss"] for e in got["history"]])
    res[name + ".report"] = np.array([got["context_loss"],
                                      got["recall_loss"]])
    if got["exact_match"] is not None:
        res[name + ".exact"] = np.array(got["exact_match"])
    for k in env:
        del os.environ[k]
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
    if name in PIPELINED:
        assert all(name + ".exact" not in res for res in ranks)
        return
    exact = float(ranks[0][name + ".exact"])
    assert 0.0 <= exact <= 1.0
    assert all(name + ".exact" not in res for res in ranks[1:])


def test_report_lines_printed_by_rank_0(run):
    out = run["out"]
    for line, n in (("first-half (irreducible) loss:", len(RUNS)),
                    ("recall-half loss:", len(RUNS)),
                    ("long-range recall:", len(RUNS)),
                    ("greedy-decode recall exact-match:",
                     len(RUNS) - len(PIPELINED))):
        assert out.count(f"[rank 0] {line}") == n, line
        assert f"[rank 1] {line}" not in out, line


def test_moe_on_a_model_axis_matches_jax(run):
    """``MOE_EVERY=2`` at ``expert=2, model=2``: the first step's loss
    (every rank of the one data shard holds the whole batch; the objective
    with the sown load-balance loss, as both trainers log it) equals JAX's
    MoE model on the batch the twin fed, from the twin's seed-0 weights."""
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.models.convert import params_to_flax

    cfg = dict(vocab_size=int(KNOBS["VOCAB"]), d_model=int(KNOBS["DMODEL"]),
               n_heads=8, n_layers=int(KNOBS["NLAYERS"]), dropout=0.0,
               moe_every=2, n_experts=4)
    tm = ttr.TransformerLM(**cfg, device="cpu")  # the twin's weights
    params = params_to_flax(tm.state_dict(), n_heads=cfg["n_heads"])
    for res in run["ranks"]:
        x, y = res["moe_model.first_x"], res["moe_model.first_y"]
        logits, sown = jtr.TransformerLM(**cfg).apply(
            {"params": params}, jnp.asarray(x), train=True,
            mutable=["losses"], rngs={"dropout": jax.random.PRNGKey(0)})
        logp = np.asarray(jax.nn.log_softmax(logits, -1))
        want = float(-np.take_along_axis(logp, y[..., None], -1).mean())
        want += sum(float(v) for v in jax.tree.leaves(sown["losses"]))
        got = float(res["moe_model.first_loss"])
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("n,seed", [(4096, 0), (64, 99)])
def test_copy_task_byte_equal_to_jax(n, seed):
    for a, b in zip(tds.copy_task(n, 512, vocab_size=64, seed=seed),
                    jds.copy_task(n, 512, vocab_size=64, seed=seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
