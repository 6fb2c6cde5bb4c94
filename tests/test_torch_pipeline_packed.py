"""Packed rows and the sliding window through the port's pipeline (no
``seq`` axis), at four gloo ranks on the CPU in one launch of the port's
launcher: ``data=1,pipe=4`` under GPipe and 1F1B, and ``data=2,pipe=2``
under the interleaved schedule (8 layers, ``n_virtual`` 2, its stacks in
placement order). The segment ids and their positions ride the schedules
as ``extras``, never the handoffs. Against JAX's sequential
``PipelinedLM(mesh=None)`` on the same numpy weights (JAX's
``TestPackedPipeline`` and ``TestWindowedPipeline``):

* logits and every gathered gradient of a mean cross-entropy on packed
  rows (two documents of 16 in a row of 32) under GPipe and 1F1B, and
  each document equal to its solo run (packing invariance);
* a window of 5 under GPipe and 1F1B, and packed rows under a window of
  5 through the interleaved schedule, equal to JAX's windowed sequential
  model; the window binds (the full-causal model differs by more than
  1e-4).

Tolerances: JAX's own, f32 on both sides: logits rtol = atol = 2e-4 (the
packed documents against their solo runs 3e-4, the windowed logits 2e-5
as in JAX's window test), gradients rtol 2e-3 / atol 2e-5.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import pipelined_params_to_flax
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
NPROCS = 4
LOGITS_TOL, PACKED_TOL, WINDOW_TOL = 2e-4, 3e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
ROWS, T, VOCAB, WINDOW, V = 4, 32, 32, 5, 2
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_micro=2)
# name: (mesh, schedule, n_layers, window, packed)
RUNS = {"packed_gpipe": ("data=1,pipe=4", "gpipe", 4, None, True),
        "packed_1f1b": ("data=1,pipe=4", "1f1b", 4, None, True),
        "window_gpipe": ("data=1,pipe=4", "gpipe", 4, WINDOW, False),
        "window_1f1b": ("data=1,pipe=4", "1f1b", 4, WINDOW, False),
        "packed_window_interleaved": ("data=2,pipe=2", "interleaved", 8,
                                      WINDOW, True)}

CHILD = r'''
import json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.models.transformer import live_placements
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpipe

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
runs = json.loads(os.environ["RUNS"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def rows_of(mesh, a):
    b = a.shape[0] // mesh.data_shards
    return torch.from_numpy(a[mesh.data_index * b:(mesh.data_index + 1) * b])


for name, (tag, sched, n_layers, window, packed) in runs.items():
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    res[name + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
    model = tpl.PipelinedLM(**cfg, n_layers=n_layers, mesh=mesh,
                            schedule=sched, window=window, device="cpu",
                            seed=1)
    seg = rows_of(mesh, data["seg"]) if packed else None
    x, y = rows_of(mesh, data["x"]), rows_of(mesh, data["y"])
    logits = model(x, segment_ids=seg)
    res[name + ".logits"] = logits.detach().numpy()
    res[name + ".forward"] = np.array(tpipe.stats["forward"])
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    y.reshape(-1).long()).backward()
    specs = live_placements(tpl.param_specs(model, mesh), mesh)
    grads = {n: c.all_reduce_sum(p.grad, mesh.grad_group) / mesh.data_shards
             for n, p in model.named_parameters()}
    for n, g in gather_state_dict(grads, mesh, specs).items():
        res[f"{name}.g.{n}"] = g.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(31)
    x = rng.randint(1, VOCAB, (ROWS, T)).astype(np.int32)
    y = rng.randint(1, VOCAB, (ROWS, T)).astype(np.int32)
    seg = np.concatenate([np.ones((ROWS, T // 2)), 2 * np.ones(
        (ROWS, T // 2))], 1).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y, seg=seg)
    return dict(x=x, y=y, seg=seg)


def _jax_reference(d, n_layers, window, packed, sched):
    """JAX's sequential model on the port's seed-1 weights (an interleaved
    model's stacks taken in placement order): logits, each document's solo
    run, and the gradients of the mean cross-entropy in the stored
    order."""
    sd = tpl.PipelinedLM(**CFG, n_layers=n_layers, device="cpu",
                         seed=1).state_dict()
    tree = pipelined_params_to_flax(sd)
    if sched == "interleaved":
        tree = jpl.to_logical_order(tree, n_layers, 2, V)
    jm = jpl.PipelinedLM(**CFG, n_layers=n_layers, window=window, mesh=None)
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    seg = jnp.asarray(d["seg"]) if packed else None

    def loss(p):
        logits = jm.apply({"params": p}, x, segment_ids=seg)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    grads = jax.grad(loss)(tree)
    if sched == "interleaved":
        grads = jpl.to_interleaved_order(grads, n_layers, 2, V)
    h = T // 2
    return dict(
        logits=np.asarray(jm.apply({"params": tree}, x, segment_ids=seg)),
        solo=np.concatenate([np.asarray(jm.apply({"params": tree}, x[:, :h])),
                             np.asarray(jm.apply({"params": tree}, x[:, h:]))],
                            axis=1),
        full=np.asarray(jpl.PipelinedLM(**CFG, n_layers=n_layers).apply(
            {"params": tree}, x, segment_ids=seg)),
        grads={k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_packed")
    d = _data(tmp)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), RUNS=json.dumps(RUNS))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:  # the references compute while the ranks run
        refs = {name: _jax_reference(d, n_layers, window, packed, sched)
                for name, (_, sched, n_layers, window, packed)
                in RUNS.items()}
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    assert proc.returncode == 0, out
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)]
    return dict(data=d, refs=refs, ranks=ranks)


@pytest.mark.parametrize("name", list(RUNS))
def test_logits_and_gradients_match_jax_sequential(run, name):
    tag, _, _, window, _ = RUNS[name]
    ref = run["refs"][name]
    dp = tmesh.MeshSpec.from_string(tag).resolve(NPROCS)["data"]
    tol = WINDOW_TOL if window else LOGITS_TOL
    for res in run["ranks"]:
        i, b = int(res[name + ".coords"][0]), ROWS // dp
        np.testing.assert_allclose(res[name + ".logits"],
                                   ref["logits"][i * b:(i + 1) * b],
                                   rtol=tol, atol=tol)
        for key, g in ref["grads"].items():
            np.testing.assert_allclose(res[f"{name}.g.{key}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", ["packed_gpipe", "packed_1f1b"])
def test_packing_invariance_through_the_pipeline(run, name):
    """Each packed document equals its own unpacked run."""
    for res in run["ranks"]:
        np.testing.assert_allclose(res[name + ".logits"],
                                   run["refs"][name]["solo"],
                                   rtol=PACKED_TOL, atol=PACKED_TOL)


@pytest.mark.parametrize("name", ["window_gpipe",
                                  "packed_window_interleaved"])
def test_the_window_binds(run, name):
    ref = run["refs"][name]
    assert float(np.abs(ref["logits"] - ref["full"]).max()) > 1e-4
