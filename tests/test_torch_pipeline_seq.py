"""The port's pipeline composed with sequence parallelism (pp × sp), packed
rows and the sliding window, at four gloo ranks on the CPU in one launch
of the port's launcher on ``data=1,pipe=2,seq=2``: each rank holds rows
``[0, B)`` of the batch and columns ``[c·T/2, (c + 1)·T/2)`` at seq
coordinate c, every stage's attention runs the flash ring over the ``seq``
subgroup and the handoffs go over ``pipe``. Against JAX's sequential
``PipelinedLM(mesh=None)`` on the same numpy weights (JAX's
``TestPipeSeqComposition``, ``TestPackedPipeline`` and
``TestWindowedPipeline``):

* logits and every gathered gradient of a mean cross-entropy (each rank's
  CE summed over its block, divided by the global token count, the
  gradients summed over the gradient group) under GPipe and 1F1B;
* packed rows through pipe and seq (two documents of 8 in a row of 16, a
  document crossing no shard boundary, and one of 5 + 11 that does):
  equal to JAX's packed sequential model, and each document of the first
  to its solo run; the packed gradients under GPipe and 1F1B;
* a window of 5 under GPipe (forward and gradients) and 1F1B, equal to
  JAX's windowed sequential model, and the window binds (the full-causal
  model differs by more than 1e-4);
* the Trainer on ``pipe × seq`` with ``batch_specs=(P(('data', 'fsdp'),
  'seq'), ...)``: three Adam steps against the one-rank fit on the same
  batches, the stages' replicated leaves equal, and a row of 15 tokens
  refused with JAX's message (``seq length (15) must divide over the seq
  axis (2)``).

In process: the ``pipe`` subgroups of a ``data × pipe × seq`` mesh pair
exactly the ranks at one ``(data, seq)`` position, and each rank's stack
shards on JAX's own ``data=2,pipe=2,seq=2`` equal JAX's device shards.

Tolerances: JAX's own, f32 on both sides: logits rtol = atol = 2e-4 (the
packed documents against their solo runs 3e-4), gradients rtol 2e-3 /
atol 2e-5, the windowed logits 2e-5 (JAX's window test); the Adam fit as
``tests/test_torch_pipeline.py`` holds it (2e-5, but for one element in a
thousand within the steps' reach of 3·lr).
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
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import (
    pipelined_params_from_flax, pipelined_params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
NPROCS = 4
MESH = "data=1,pipe=2,seq=2"
LOGITS_TOL, PACKED_TOL, WINDOW_TOL = 2e-4, 3e-4, 2e-5
GRAD_RTOL, GRAD_ATOL, PARAM_ATOL = 2e-3, 2e-5, 2e-5
ROWS, T, VOCAB, STEPS, LR, WINDOW = 4, 16, 32, 3, 3e-3, 5
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4, n_micro=2)
# name: (schedule, window, packing)
RUNS = {"gpipe": ("gpipe", None, None), "1f1b": ("1f1b", None, None),
        "packed_gpipe": ("gpipe", None, "halves"),
        "packed_1f1b": ("1f1b", None, "halves"),
        "packed_cross_1f1b": ("1f1b", None, "cross"),
        "window_gpipe": ("gpipe", WINDOW, None),
        "window_1f1b": ("1f1b", WINDOW, None)}
SPLIT = {"halves": 8, "cross": 5}  # where the second document starts

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

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
runs = json.loads(os.environ["RUNS"])
steps, lr = int(os.environ["STEPS"]), float(os.environ["LR"])
data = np.load(os.path.join(out, "data.npz"))
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["MESH"]))
res = {"coords": np.array([mesh.coords[a] for a in tmesh.AXES])}
c0 = mesh.seq_index * data["x"].shape[2] // mesh.seq_shards
c1 = c0 + data["x"].shape[2] // mesh.seq_shards


def block(a):
    return torch.from_numpy(np.ascontiguousarray(a[:, c0:c1]))


for name, (sched, window, packing) in runs.items():
    model = tpl.PipelinedLM(**cfg, mesh=mesh, schedule=sched, window=window,
                            device="cpu", seed=1)
    seg = None if packing is None else block(data["seg_" + packing])
    x, y = block(data["x"][0]), block(data["y"][0])
    logits = model(x, segment_ids=seg)
    res[name + ".logits"] = logits.detach().numpy()
    n_tokens = data["x"].shape[1] * data["x"].shape[2]
    (F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                     y.reshape(-1).long(), reduction="sum")
     / n_tokens).backward()
    specs = live_placements(tpl.param_specs(model, mesh), mesh)
    grads = {n: c.all_reduce_sum(p.grad, mesh.grad_group) / mesh.data_shards
             for n, p in model.named_parameters()}
    for n, g in gather_state_dict(grads, mesh, specs).items():
        res[f"{name}.g.{n}"] = g.numpy()

# The Trainer on pipe x seq: three Adam steps from the seed-2 weights.
spec = tmesh.P(("data", "fsdp"), "seq")
model = tpl.PipelinedLM(**cfg, mesh=mesh, schedule="1f1b", device="cpu",
                        seed=2)
trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)), mesh=mesh,
                     param_specs=tpl.param_specs, batch_specs=(spec, spec),
                     loss="sparse_categorical_crossentropy", device="cpu")
trainer.fit(dataset=list(zip(data["x"], data["y"])), epochs=steps,
            steps_per_epoch=1, verbose=0,
            callbacks=[ht.callbacks.MetricAverageCallback()])
res["fit.losses"] = np.array([e["loss"] for e in trainer.history])
for n, p in trainer.state.full_model_state().items():
    res["fit." + n] = p.numpy()
for n, p in model.named_parameters():
    if n not in trainer.placements:
        res["fit.local." + n] = p.detach().numpy()
try:
    trainer.train_step(data["x"][0][:, :15], data["y"][0][:, :15])
    res["refusal"] = ""
except ValueError as e:
    res["refusal"] = str(e)
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(41)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    segs = {f"seg_{k}": np.concatenate(
        [np.ones((ROWS, s)), 2 * np.ones((ROWS, T - s))], 1).astype(np.int32)
        for k, s in SPLIT.items()}
    np.savez(tmp / "data.npz", x=x, y=y, **segs)
    return dict(x=x, y=y, **segs)


def _weights(seed, **kw):
    model = tpl.PipelinedLM(**CFG, device="cpu", seed=seed, **kw)
    return {n: t.clone() for n, t in model.state_dict().items()}


def _jax_reference(d, window, packing):
    """JAX's sequential model on the port's seed-1 weights: the logits of
    the batch and the gradients of its mean cross-entropy."""
    tree = pipelined_params_to_flax(_weights(1))
    jm = jpl.PipelinedLM(**CFG, window=window, mesh=None)
    x, y = jnp.asarray(d["x"][0]), jnp.asarray(d["y"][0])
    seg = None if packing is None else jnp.asarray(d["seg_" + packing])

    def loss(p):
        logits = jm.apply({"params": p}, x, segment_ids=seg)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    logits = jm.apply({"params": tree}, x, segment_ids=seg)
    grads = jax.grad(loss)(tree)
    solo = None
    if packing == "halves":
        s = SPLIT[packing]
        solo = np.concatenate(
            [np.asarray(jm.apply({"params": tree}, x[:, :s])),
             np.asarray(jm.apply({"params": tree}, x[:, s:]))], axis=1)
    return dict(logits=np.asarray(logits), solo=solo,
                grads={k: np.asarray(v) for k, v in grads.items()})


def _one_rank_fit(d):
    import horovod_tpu_torch as ht

    model = tpl.PipelinedLM(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(LR)),
                         loss="sparse_categorical_crossentropy",
                         device="cpu")
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    return dict(losses=np.array([e["loss"] for e in trainer.history]),
                params={n: p.detach().numpy()
                        for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_sp")
    d = _data(tmp)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), RUNS=json.dumps(RUNS),
               MESH=MESH, STEPS=str(STEPS), LR=str(LR))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:  # the references compute while the ranks run
        refs = {}
        for _, window, packing in RUNS.values():
            if (window, packing) not in refs:
                refs[window, packing] = _jax_reference(d, window, packing)
        refs["full"] = _jax_reference(d, None, None)
        fit = _one_rank_fit(d)
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
    return dict(data=d, refs=refs, fit=fit, ranks=ranks)


def _block(a, res):
    c = int(res["coords"][tmesh.AXES.index("seq")])
    return a[:, c * T // 2:(c + 1) * T // 2]


@pytest.mark.parametrize("name", list(RUNS))
def test_logits_and_gradients_match_jax_sequential(run, name):
    _, window, packing = RUNS[name]
    ref = run["refs"][window, packing]
    tol = WINDOW_TOL if window else LOGITS_TOL
    for res in run["ranks"]:
        np.testing.assert_allclose(res[name + ".logits"],
                                   _block(ref["logits"], res),
                                   rtol=tol, atol=tol)
        for key, g in ref["grads"].items():
            np.testing.assert_allclose(res[f"{name}.g.{key}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", ["packed_gpipe", "packed_1f1b"])
def test_packed_documents_equal_their_solo_runs(run, name):
    """JAX's packing invariance through pipe and seq: each document of a
    packed row equals its own unpacked run."""
    solo = run["refs"][None, "halves"]["solo"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res[name + ".logits"], _block(solo, res),
                                   rtol=PACKED_TOL, atol=PACKED_TOL)


def test_the_window_binds(run):
    windowed = run["refs"][WINDOW, None]["logits"]
    full = run["refs"]["full"]["logits"]
    assert float(np.abs(windowed - full).max()) > 1e-4


def test_trainer_on_pipe_x_seq_equals_one_rank(run):
    want = run["fit"]
    ranks = run["ranks"]
    for res in ranks:
        np.testing.assert_allclose(res["fit.losses"], want["losses"],
                                   rtol=1e-5)
        for name, p in want["params"].items():
            diff = np.abs(np.asarray(res["fit." + name], np.float64) - p)
            assert diff.max() <= STEPS * LR, (name, diff.max())
            assert (diff > PARAM_ATOL).mean() <= 1e-3, name
        for name in ("embed", "ln_f", "lm_head"):
            np.testing.assert_array_equal(res["fit.local." + name],
                                          ranks[0]["fit.local." + name])


def test_indivisible_seq_rejected_with_jax_message(run):
    for res in run["ranks"]:
        assert "seq length (15) must divide over the seq axis (2)" in str(
            res["refusal"]), res["refusal"]


# -- in process ---------------------------------------------------------------


def test_pipe_groups_pair_the_same_data_and_seq_position():
    """On ``data=2,pipe=2,seq=2`` the ``pipe`` subgroup of each rank is the
    ranks at its ``(data, seq)`` coordinates, stage by stage."""
    shape = tmesh.MeshSpec.from_string("data=2,pipe=2,seq=2").resolve(8)
    groups = tmesh.axis_rank_lists(shape, "pipe")
    assert sorted(r for g in groups for r in g) == list(range(8))
    for g in groups:
        meshes = [tmesh.build_mesh(tmesh.MeshSpec(**shape), n_ranks=8,
                                   rank=r) for r in g]
        assert [m.stage for m in meshes] == [0, 1]
        assert len({(m.coords["data"], m.coords["seq"])
                    for m in meshes}) == 1


def test_stack_shards_equal_jax_device_shards_on_pipe_x_seq():
    jm = jpl.PipelinedLM(**CFG)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((2, 8), jnp.int32))["params"])
    n = tmesh.MeshSpec.from_string("data=2,pipe=2,seq=2").resolve(8)
    jmsh = jmesh.build_mesh(jmesh.MeshSpec(**n), jax.devices("cpu")[:8])
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jmsh, s), jpl.param_specs(params, jmsh),
        is_leaf=lambda s: isinstance(s, JP)))
    full = pipelined_params_from_flax(params)
    devices = list(jmsh.devices.reshape(-1))
    for r in range(8):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=8, rank=r)
        mine = shard_state_dict(full, lay, tpl.param_specs(full, lay))
        theirs = pipelined_params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed))
        model = tpl.PipelinedLM(**CFG, mesh=lay, device="cpu")
        assert set(mine) == set(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), (r, name)
            assert tuple(getattr(model, name).shape) == tuple(t.shape)
