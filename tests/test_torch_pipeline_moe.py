"""The port's MoE pipeline and the schedules' ``extras`` / ``with_aux``
channel, at four gloo ranks on the CPU in one launch of the port's
launcher. Against JAX's sequential ``PipelinedLM(mesh=None, mlp="moe")``
on the same numpy weights (JAX's ``TestMoEPipeline``: 4 layers, d 32, 4
heads, 4 experts top-2, capacity 1.25, groups of 16 tokens — one row, the
grouping of every mesh here and of JAX's sequential model):

* logits, the sown load-balance loss and drop rate, and every gathered
  gradient of the mean cross-entropy plus the sown loss, router included
  (non-zero), under GPipe, 1F1B and the interleaved schedule at
  ``data=2,pipe=2`` (the aux's gradient through each schedule's own
  backward), under GPipe at ``data=1,pipe=2,expert=2`` (each rank's
  experts' columns of the one-hots, one sum over ``expert``), under 1F1B at
  ``data=1,pipe=2,model=2`` (the experts' hidden dim over ``model``), and
  on the sequential path at ``data=1,model=2,expert=2`` (one sum over
  ``expert`` and ``model``: JAX's ``test_ep_tp_sharding_matches_unsharded``
  at four ranks);
* the Trainer at ``data=1,pipe=2,expert=2`` under 1F1B: three Adam steps
  against the one-rank fit, ``moe_drop_rate`` in ``metric_names`` and in
  every epoch log, the expert stacks placed on ``pipe`` and ``expert``;
  its checkpoint equal to the one-rank fit's file (the full layout), the
  broadcast callback keeping each rank's expert shard, and the serving
  export of the seed-1 model there against JAX's sequential logits;
* a starved capacity (factor 0.25) reports a drop rate above 0.1;
* the schedules' ``extras`` and ``with_aux`` on a toy stage (a tanh layer
  plus a per-microbatch bias, aux = the activation's mean square): the
  outputs, the aux sums and the gradients of the outputs and the aux
  against the same layers run in sequence on one rank, under the three
  schedules at ``data=2,pipe=2``.

In process: the dense stacks absent under MoE; each rank's stack shards at
JAX's ``data=1,pipe=2,model=2,expert=2`` and ``data=2,pipe=2,expert=2``
equal JAX's device shards; the converters' round trip and the layer
orders with the MoE stacks; flax's initializer spreads on the expert
stacks (fan-in d, d and 4d).

Tolerances: JAX's (``tests/test_pipeline.py``), f32 on both sides: logits
rtol = atol = 2e-4, gradients rtol 2e-3 / atol 2e-5, the aux values 1e-5;
the Adam fit as ``tests/test_torch_pipeline.py`` holds it; the toy
schedules 1e-5.
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
LOGITS_TOL, GRAD_RTOL, GRAD_ATOL, AUX_TOL = 2e-4, 2e-3, 2e-5, 1e-5
PARAM_ATOL, TOY_TOL = 2e-5, 1e-5
ROWS, T, VOCAB, STEPS, LR, V = 8, 16, 32, 3, 3e-3, 2
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4, n_micro=4,
           mlp="moe", n_experts=4, moe_group_size=16)
# name: (mesh, schedule)
RUNS = {"dp.gpipe": ("data=2,pipe=2", "gpipe"),
        "dp.1f1b": ("data=2,pipe=2", "1f1b"),
        "dp.interleaved": ("data=2,pipe=2", "interleaved"),
        "ep.gpipe": ("data=1,pipe=2,expert=2", "gpipe"),
        "tp.1f1b": ("data=1,pipe=2,model=2", "1f1b"),
        "ep_tp.sequential": ("data=1,model=2,expert=2", "gpipe")}
FIT_MESH = "data=1,pipe=2,expert=2"
TOY = dict(layers=4, micro=4, rows=2, width=3)

CHILD = r'''
import json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
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
toy = json.loads(os.environ["TOY"])
steps, lr = int(os.environ["STEPS"]), float(os.environ["LR"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def rows_of(mesh, a):
    b = a.shape[0] // mesh.data_shards
    return a[mesh.data_index * b:(mesh.data_index + 1) * b]


for name, (tag, sched) in runs.items():
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    res[name + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
    model = tpl.PipelinedLM(**cfg, mesh=mesh, schedule=sched, device="cpu",
                            seed=1)
    x = torch.from_numpy(rows_of(mesh, data["x"][0]))
    y = torch.from_numpy(rows_of(mesh, data["y"][0]))
    logits = model(x, train=True)
    res[name + ".logits"] = logits.detach().numpy()
    aux = model.sown["losses"]["moe_load_balance"]
    res[name + ".aux"] = aux.detach().numpy()
    res[name + ".drop"] = model.sown["metrics"]["moe_drop_rate"].numpy()
    (F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                     y.reshape(-1).long()) + aux).backward()
    specs = live_placements(tpl.param_specs(model, mesh), mesh)
    grads = {n: c.all_reduce_sum(p.grad, mesh.grad_group) / mesh.data_shards
             for n, p in model.named_parameters()}
    for n, g in gather_state_dict(grads, mesh, specs).items():
        res[f"{name}.g.{n}"] = g.numpy()
    if name == "ep.gpipe":
        # The serving export of the seed-1 model: every rank calls (the
        # gather is a collective), rank 0 writes, at the batch's shape.
        res["export"] = checkpoint.export_serving(
            os.path.join(out, "export"), model, input_shape=data["x"][0].shape,
            input_dtype=np.int32, timestamp="19700101-000000")

# A starved capacity drops tokens, and says so.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,pipe=2"))
model = tpl.PipelinedLM(**dict(cfg, capacity_factor=0.25), mesh=mesh,
                        device="cpu", seed=1)
with torch.no_grad():
    model(torch.from_numpy(rows_of(mesh, data["x"][0])))
res["starved.drop"] = model.sown["metrics"]["moe_drop_rate"].numpy()

# The Trainer at pipe x expert: three Adam steps from the seed-2 weights.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["FIT_MESH"]))
res["fit.coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
model = tpl.PipelinedLM(**cfg, mesh=mesh, schedule="1f1b", device="cpu",
                        seed=2)
trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)), mesh=mesh,
                     param_specs=tpl.param_specs, device="cpu")
cbs = [ht.callbacks.MetricAverageCallback()]
if r == 0:
    cbs.append(ht.callbacks.ModelCheckpoint(
        os.path.join(out, "ckpt", "checkpoint-{epoch}.pt")))
trainer.fit(dataset=list(zip(data["x"], data["y"])), epochs=steps,
            steps_per_epoch=1, verbose=0, callbacks=cbs)
res["fit.losses"] = np.array([e["loss"] for e in trainer.history])
res["fit.drop"] = np.array([e["moe_drop_rate"] for e in trainer.history])
res["fit.metric_names"] = np.array(trainer.metric_names)
res["fit.placements"] = json.dumps(
    {n: {str(d): a for d, a in p.items()}
     for n, p in trainer.placements.items()})
for n, p in trainer.state.full_model_state().items():
    res["fit." + n] = p.numpy()
for n, p in model.named_parameters():
    res["fit.local." + n] = p.detach().numpy().copy()
with torch.no_grad():
    for p in model.parameters():
        p.add_(float(r + 1))
cb = ht.callbacks.BroadcastGlobalVariablesCallback(0)
cb.trainer = trainer
cb.on_train_begin()
for n, p in model.named_parameters():
    res["bcast." + n] = p.detach().numpy()

# The schedules' extras and aux on a toy stage, against the same layers
# in sequence on this rank.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,pipe=2"))
g = torch.Generator().manual_seed(7)
L, M, B, W = toy["layers"], toy["micro"], toy["rows"], toy["width"]
w_full = torch.randn(L, W, W, generator=g) / W ** 0.5
x_full = torch.randn(M, B, W, generator=g)
bias = torch.randn(M, W, generator=g)
ids = torch.arange(M)


def layer(a, w, bias_m, id_m):
    a = torch.tanh(a @ w + bias_m)
    return a, (a * a).mean() * (1.0 + id_m.float())


def stage(params, act, extra):
    (w,) = params
    b_m, id_m = extra
    total = 0.0
    for i in range(w.shape[0]):
        act, sq = layer(act, w[i], b_m, id_m)
        total = total + sq
    return act, {"sq": total, "n": torch.ones(())}


def objective(out_, aux_):
    return (out_ * out_).sum() + 3.0 * aux_["sq"]


x_seq = x_full.clone().requires_grad_()
w_seq = w_full.clone().requires_grad_()
outs, aux_seq = [], 0.0
for m in range(M):
    a = x_seq[m]
    for i in range(L):
        a, sq = layer(a, w_seq[i], bias[m], ids[m])
        aux_seq = aux_seq + sq
    outs.append(a)
out_seq = torch.stack(outs)
objective(out_seq, {"sq": aux_seq}).backward()
res["toy.seq.out"] = out_seq.detach().numpy()
res["toy.seq.aux"] = aux_seq.detach().numpy()
res["toy.seq.gw"] = w_seq.grad.numpy()
res["toy.seq.gx"] = x_seq.grad.numpy()
S, s = 2, mesh.stage
group = mesh.group("pipe")
for sched in ("gpipe", "1f1b", "interleaved"):
    if sched == "interleaved":
        order = tpipe.interleaved_layer_order(L, S, 2)
        mine = w_full[order][s * L // S:(s + 1) * L // S]
        mine = mine.reshape(2, L // (S * 2), W, W).clone()
    else:
        mine = w_full[s * L // S:(s + 1) * L // S].clone()
    w = mine.requires_grad_()
    x = x_full.clone().requires_grad_()
    kw = dict(group=group, extras=(bias, ids), with_aux=True)
    if sched == "gpipe":
        out_, aux_ = tpipe.spmd_pipeline(stage, [w], x, **kw)
    elif sched == "1f1b":
        out_, aux_ = tpipe.spmd_pipeline_1f1b(stage, [w], x, **kw)
    else:
        out_, aux_ = tpipe.spmd_pipeline_interleaved(stage, [w], x,
                                                     n_virtual=2, **kw)
    total = {k: c.leave_group(v, group) for k, v in aux_.items()}
    objective(out_, total).backward()
    gw = c.all_gather_tensor(w.grad, group).reshape(L, W, W)
    if sched == "interleaved":
        gw = gw[np.argsort(order)]
    res[f"toy.{sched}.out"] = out_.detach().numpy()
    res[f"toy.{sched}.aux"] = total["sq"].detach().numpy()
    res[f"toy.{sched}.n"] = aux_["n"].detach().numpy()
    res[f"toy.{sched}.gw"] = gw.numpy()
    res[f"toy.{sched}.gx"] = x.grad.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(61)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y)
    return dict(x=x, y=y)


def _weights(seed, **kw):
    model = tpl.PipelinedLM(**dict(CFG, **kw), device="cpu", seed=seed)
    return {n: t.clone() for n, t in model.state_dict().items()}


def _jax_reference(d, stages, sched):
    """JAX's sequential MoE model on the port's seed-1 weights (an
    interleaved model's stacks taken in placement order): logits, the sown
    loss and drop rate, and the gradients of CE + the sown loss, in the
    port's stored order."""
    tree = pipelined_params_to_flax(_weights(1))
    if sched == "interleaved":
        tree = jpl.to_logical_order(tree, CFG["n_layers"], stages, V)
    jm = jpl.PipelinedLM(**CFG, mesh=None)
    x, y = jnp.asarray(d["x"][0]), jnp.asarray(d["y"][0])

    def loss(p):
        logits, var = jm.apply({"params": p}, x, train=True,
                               mutable=["losses", "metrics"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return ce + var["losses"]["moe_load_balance"][0], (logits, var)

    grads, (logits, var) = jax.grad(loss, has_aux=True)(tree)
    if sched == "interleaved":
        grads = jpl.to_interleaved_order(grads, CFG["n_layers"], stages, V)
    return dict(logits=np.asarray(logits),
                aux=float(var["losses"]["moe_load_balance"][0]),
                drop=float(var["metrics"]["moe_drop_rate"][0]),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _one_rank_fit(d, tmp):
    import horovod_tpu_torch as ht

    model = tpl.PipelinedLM(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(LR)),
                         device="cpu")
    ckpt = tmp / "one"
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0, callbacks=[
                    ht.callbacks.ModelCheckpoint(
                        str(ckpt / "checkpoint-{epoch}.pt"))])
    return dict(losses=np.array([e["loss"] for e in trainer.history]),
                drop=np.array([e["moe_drop_rate"] for e in trainer.history]),
                params={n: p.detach().numpy()
                        for n, p in model.named_parameters()}, ckpt=ckpt)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_moe")
    d = _data(tmp)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), RUNS=json.dumps(RUNS),
               FIT_MESH=FIT_MESH, TOY=json.dumps(TOY), STEPS=str(STEPS),
               LR=str(LR))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:  # the references compute while the ranks run
        refs = {"stored": _jax_reference(d, 2, "gpipe"),
                "interleaved": _jax_reference(d, 2, "interleaved")}
        fit = _one_rank_fit(d, tmp)
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
    return dict(data=d, refs=refs, fit=fit, ranks=ranks, tmp=tmp)


@pytest.mark.parametrize("name", list(RUNS))
def test_moe_logits_aux_and_gradients_match_jax_sequential(run, name):
    tag, sched = RUNS[name]
    ref = run["refs"]["interleaved" if sched == "interleaved"
                      and "pipe" in tag else "stored"]
    dp = tmesh.MeshSpec.from_string(tag).resolve(NPROCS)["data"]
    assert float(np.abs(ref["grads"]["router"]).max()) > 0
    for res in run["ranks"]:
        i = int(res[name + ".coords"][0])
        b = ROWS // dp
        np.testing.assert_allclose(res[name + ".logits"],
                                   ref["logits"][i * b:(i + 1) * b],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        np.testing.assert_allclose(res[name + ".aux"], ref["aux"],
                                   rtol=AUX_TOL, atol=AUX_TOL)
        np.testing.assert_allclose(res[name + ".drop"], ref["drop"],
                                   rtol=AUX_TOL, atol=AUX_TOL)
        for key, g in ref["grads"].items():
            np.testing.assert_allclose(res[f"{name}.g.{key}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{name} {key}")


def test_starved_capacity_reports_drops(run):
    for res in run["ranks"]:
        assert float(res["starved.drop"]) > 0.1


def test_trainer_at_pipe_x_expert_equals_one_rank(run):
    want = run["fit"]
    for res in run["ranks"]:
        assert "moe_drop_rate" in list(res["fit.metric_names"])
        np.testing.assert_allclose(res["fit.losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["fit.drop"], want["drop"],
                                   rtol=1e-5, atol=1e-6)
        assert ((0.0 <= res["fit.drop"]) & (res["fit.drop"] <= 1.0)).all()
        for name, p in want["params"].items():
            diff = np.abs(np.asarray(res["fit." + name], np.float64) - p)
            assert diff.max() <= STEPS * LR, (name, diff.max())
            assert (diff > PARAM_ATOL).mean() <= 1e-3, name
        placed = json.loads(str(res["fit.placements"]))
        assert placed["moe_up"] == {"0": "pipe", "1": "expert"}
        assert placed["moe_down"] == {"0": "pipe", "1": "expert"}
        assert placed["router"] == {"0": "pipe"}


def test_checkpoint_at_pipe_x_expert_equals_the_one_rank_file(run):
    one = run["fit"]["ckpt"]
    for epoch in range(1, STEPS + 1):
        name = f"checkpoint-{epoch}.pt"
        got = torch.load(run["tmp"] / "ckpt" / name, weights_only=True)
        want = torch.load(one / name, weights_only=True)
        assert set(got["model"]) == set(want["model"])
        for n, t in got["model"].items():
            w = want["model"][n]
            assert t.shape == w.shape and t.dtype == w.dtype, n
            diff = (t.double() - w.double()).abs()
            assert float(diff.max()) <= STEPS * LR, n
            assert float((diff > PARAM_ATOL).double().mean()) <= 1e-3, n
        gs, ws = got["optimizer"]["state"], want["optimizer"]["state"]
        assert len(gs) == len(ws)
        for k, st in gs.items():
            for leaf in ("exp_avg", "exp_avg_sq"):
                assert st[leaf].shape == ws[k][leaf].shape, (k, leaf)


def test_export_at_pipe_x_expert_matches_jax_sequential(run):
    """`export_serving` of the seed-1 model held at ``data=1,pipe=2,
    expert=2`` (gathered inside the export; an MoE model exports at its
    batch's shape): the bundle's probabilities are the softmax of JAX's
    sequential logits."""
    from horovod_tpu_torch import checkpoint

    stamp = "19700101-000000"
    for res in run["ranks"]:
        assert str(res["export"]).endswith(stamp)
    fn = checkpoint.load_serving(str(run["tmp"] / "export" / stamp),
                                 device="cpu")
    want = jax.nn.softmax(run["refs"]["stored"]["logits"])
    np.testing.assert_allclose(fn(run["data"]["x"][0]), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_broadcast_callback_keeps_each_expert_shard(run):
    """Replicated leaves take the root's; each stage and expert shard keeps
    the one held at its (pipe, expert) place by its first data rank (data
    = 1 here: its own). Every rank added its rank + 1 before."""
    ranks = run["ranks"]
    root = ranks[0]
    for r, res in enumerate(ranks):
        for name in ("embed", "ln_f", "lm_head"):
            np.testing.assert_array_equal(res["bcast." + name],
                                          root["fit.local." + name] + 1.0)
        for name in ("moe_up", "moe_down", "router", "qkv"):
            np.testing.assert_array_equal(res["bcast." + name],
                                          res["fit.local." + name] + (r + 1.0))
    assert not np.array_equal(ranks[0]["fit.local.moe_up"],
                              ranks[1]["fit.local.moe_up"])


@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
def test_extras_and_aux_schedules_equal_the_sequential_run(run, sched):
    for res in run["ranks"]:
        for what in ("out", "aux", "gw", "gx"):
            np.testing.assert_allclose(res[f"toy.{sched}.{what}"],
                                       res[f"toy.seq.{what}"],
                                       rtol=TOY_TOL, atol=TOY_TOL,
                                       err_msg=f"{sched} {what}")
        # A constant aux sums one a pass: n_micro × v on every rank.
        v = 2 if sched == "interleaved" else 1
        assert float(res[f"toy.{sched}.n"]) == TOY["micro"] * v


# -- in process ---------------------------------------------------------------


def _jax_params(**kw):
    jm = jpl.PipelinedLM(**dict(CFG, **kw))
    return jax.device_get(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, 16), jnp.int32))["params"])


def test_dense_stacks_absent_under_moe():
    params = _jax_params()
    model = tpl.PipelinedLM(**CFG, device="cpu")
    names = set(model.state_dict())
    assert names == set(params)
    assert {"moe_up", "moe_down", "router"} <= names
    assert "mlp_up" not in names and "mlp_down" not in names


@pytest.mark.parametrize("spec", ["data=1,pipe=2,model=2,expert=2",
                                  "data=2,pipe=2,expert=2"])
def test_expert_stack_shards_equal_jax_device_shards(spec):
    params = _jax_params()
    n = tmesh.MeshSpec.from_string(spec).resolve(8)
    jm = jmesh.build_mesh(jmesh.MeshSpec(**n), jax.devices("cpu")[:8])
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jm, s), jpl.param_specs(params, jm),
        is_leaf=lambda s: isinstance(s, JP)))
    full = pipelined_params_from_flax(params)
    devices = list(jm.devices.reshape(-1))
    for r in range(8):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=8, rank=r)
        mine = shard_state_dict(full, lay, tpl.param_specs(full, lay))
        theirs = pipelined_params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed))
        model = tpl.PipelinedLM(**CFG, mesh=lay, device="cpu")
        assert set(mine) == set(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), (spec, r, name)
            assert tuple(getattr(model, name).shape) == tuple(t.shape)


def test_converters_and_layer_orders_carry_the_moe_stacks():
    params = _jax_params()
    sd = pipelined_params_from_flax(params)
    back = pipelined_params_to_flax(sd)
    assert set(back) == set(params)
    for name, a in params.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    model = tpl.PipelinedLM(**CFG, device="cpu")
    model.load_state_dict(sd)
    for ours, theirs in ((tpl.to_interleaved_order, jpl.to_interleaved_order),
                         (tpl.to_logical_order, jpl.to_logical_order)):
        got = ours(sd, 4, 2, V)
        want = theirs(params, 4, 2, V)
        for name, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                          err_msg=name)
    for name in ("router", "moe_up", "moe_down"):
        assert not torch.equal(tpl.to_interleaved_order(sd, 4, 2, V)[name],
                               sd[name])


def test_expert_stack_initialization_follows_flax():
    """flax's ``lecun_normal(batch_axis=...)``: the router's and
    ``moe_up``'s fan-in is d, ``moe_down``'s 4d — the layer and expert
    dims left out — on both sides within 8 % in law."""
    cfg = dict(CFG, n_layers=8, d_model=64, n_experts=8)
    jp = _jax_params(n_layers=8, d_model=64, n_experts=8)
    tm = tpl.PipelinedLM(**cfg, device="cpu", seed=4)
    for name, fan_in in (("router", 64), ("moe_up", 64), ("moe_down", 256)):
        law = 1 / np.sqrt(fan_in)
        for side, std in (("port", float(getattr(tm, name).std())),
                          ("jax", float(np.asarray(jp[name]).std()))):
            assert abs(std - law) <= 0.08 * law, (name, side, std, law)
