"""The port's pipeline at four gloo ranks on the CPU, through the port's
launcher in one launch: `models.pipelined_lm.PipelinedLM` on ``data=2,
pipe=2`` and ``data=1,pipe=4`` under the three schedules (GPipe, 1F1B,
and the interleaved one at 8 layers, ``n_virtual`` 2) and on ``data=1,
pipe=2,model=2`` (Megatron TP inside each stage) under GPipe and 1F1B,
every rank running every check on its batch shard (rows ``[4i, 4i + 4)``
of the 8-row global batch at ``data=2``).

* logits and every gathered gradient of a cross-entropy (summed over the
  gradient group and divided by dp, as the optimizer does) against JAX's
  sequential ``PipelinedLM(mesh=None)`` on the same weights — an
  interleaved model's placement-ordered stacks through JAX's own
  ``to_logical_order`` — and the forward and backward passes each rank ran
  against JAX's tick model (``T + S − 1`` and ``v·T + S − 1`` ticks,
  n_micro passes a stage a round);
* each rank's stack shards against JAX's own device shards under its
  ``pipelined_lm.param_specs`` on the conftest's 8 virtual devices (here
  in the parent, on layout meshes, JAX's ``data=2,pipe=4`` and
  ``data=2,pipe=2,model=2`` included);
* three Adam ``fit`` steps (the Trainer on ``pipelined_lm.param_specs``,
  its default batch layout) against the one-rank fit, the parameters
  bit-equal across the data ranks of a stage;
* the broadcast callback: replicated leaves take the root's, stage shards
  their stage's first data rank's;
* checkpoints written at ``pipe=2`` (GPipe, and interleaved in placement
  order) equal the one-rank fit's files, and the GPipe file loads on
  ``pipe=2,model=2``;
* the serving bundles of the GPipe and the interleaved model at
  ``pipe=2`` (gathered inside the export) against JAX's sequential model
  on the logical-order weights;
* a `TransformerLM` on ``data=2,pipe=2``: replicated over ``pipe``, as
  JAX's runs under GSPMD, its fit equal to one rank's.

Tolerances: JAX's own, f32 on both sides (``tests/test_pipeline.py``):
logits rtol = atol = 2e-4, gradients rtol 2e-3 / atol 2e-5; against the
port at one rank after three Adam steps 2e-5 absolute, but for at most
one element in a thousand, which stays within the three steps' reach of
3·lr: the two sides sum the same gradients in other orders, and Adam's
g/√v turns a rounding difference of a small gradient into a step of up to
lr. Shards are equal exactly. JAX's test meshes
``data=2,pipe=4`` and ``data=2,pipe=2,model=2`` are held for the shards
only: the launched checks run at four ranks for the time budget.
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
from horovod_tpu_torch.parallel import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
NPROCS = 4
LOGITS_TOL, GRAD_RTOL, GRAD_ATOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5, 2e-5
ROWS, T, VOCAB, STEPS, LR, N_MICRO, V = 8, 16, 32, 3, 3e-3, 4, 2
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_micro=N_MICRO)
# (mesh, schedule, n_layers)
RUNS = [("data=2,pipe=2", "gpipe", 4), ("data=2,pipe=2", "1f1b", 4),
        ("data=2,pipe=2", "interleaved", 8), ("data=1,pipe=4", "gpipe", 4),
        ("data=1,pipe=4", "1f1b", 4), ("data=1,pipe=4", "interleaved", 8),
        ("data=1,pipe=2,model=2", "gpipe", 4),
        ("data=1,pipe=2,model=2", "1f1b", 4)]
CKPT = {"gpipe": "data=2,pipe=2.gpipe",
        "interleaved": "data=2,pipe=2.interleaved"}

CHILD = r'''
import json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpipe

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
runs = json.loads(os.environ["RUNS"])
ckpt = json.loads(os.environ["CKPT"])
steps, lr = int(os.environ["STEPS"]), float(os.environ["LR"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def rows_of(mesh, a):
    b = a.shape[0] // mesh.data_shards
    return a[mesh.data_index * b:(mesh.data_index + 1) * b]


def fit(trainer, mesh, callbacks=()):
    batches = [(rows_of(mesh, x), rows_of(mesh, y))
               for x, y in zip(data["x"], data["y"])]
    trainer.fit(dataset=batches, epochs=steps, steps_per_epoch=1,
                callbacks=[ht.callbacks.MetricAverageCallback(), *callbacks],
                verbose=0)
    return np.array([e["loss"] for e in trainer.history])


for tag, sched, n_layers in runs:
    key = f"{tag}.{sched}"
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    res[tag + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
    x0 = torch.from_numpy(rows_of(mesh, data["x"][0]))
    y0 = torch.from_numpy(rows_of(mesh, data["y"][0]))
    model = tpl.PipelinedLM(**cfg, n_layers=n_layers, mesh=mesh,
                            schedule=sched, device="cpu", seed=1)
    specs = ttr.live_placements(tpl.param_specs(model, mesh), mesh)
    with torch.no_grad():
        res[key + ".logits"] = model(x0).numpy()
    logits = model(x0)
    res[key + ".ticks"] = np.array(tpipe.stats["ticks"])
    res[key + ".forward"] = np.array(tpipe.stats["forward"])
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    y0.reshape(-1).long()).backward()
    res[key + ".backward_ticks"] = np.array(tpipe.stats["backward_ticks"])
    res[key + ".backward"] = np.array(tpipe.stats["backward"])
    grads = {n: c.all_reduce_sum(p.grad, mesh.grad_group) / mesh.data_shards
             for n, p in model.named_parameters()}
    for n, g in gather_state_dict(grads, mesh, specs).items():
        res[f"{key}.g.{n}"] = g.numpy()
    for n, p in model.named_parameters():
        res[f"{key}.local.{n}"] = p.detach().numpy().copy()
    if key in ckpt.values():
        # The serving export of the seed-1 model: every rank calls (the
        # gather is a collective) and rank 0 writes.
        res[key + ".export"] = checkpoint.export_serving(
            os.path.join(out, "export-" + sched), model,
            input_shape=(2, data["x"].shape[2]), input_dtype=np.int32,
            timestamp="19700101-000000")

    # Three Adam steps from the seed-2 weights.
    model = tpl.PipelinedLM(**cfg, n_layers=n_layers, mesh=mesh,
                            schedule=sched, device="cpu", seed=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)),
                         mesh=mesh, param_specs=tpl.param_specs, device="cpu")
    cbs = ()
    if key in ckpt.values() and r == 0:
        cbs = (ht.callbacks.ModelCheckpoint(os.path.join(
            out, "ckpt-" + sched, "checkpoint-{epoch}.pt")),)
    res[key + ".fit.losses"] = fit(trainer, mesh, cbs)
    res[key + ".fit.eager"] = trainer._runner.eager_steps
    for n, p in trainer.state.full_model_state().items():
        res[f"{key}.fit.{n}"] = p.numpy()
    for n, p in model.named_parameters():
        res[f"{key}.fit.local.{n}"] = p.detach().numpy().copy()

    if key == ckpt["gpipe"]:
        # The broadcast callback from a state that differs by rank.
        with torch.no_grad():
            for p in model.parameters():
                p.add_(float(r + 1))
        cb = ht.callbacks.BroadcastGlobalVariablesCallback(0)
        cb.trainer = trainer
        cb.on_train_begin()
        for n, p in model.named_parameters():
            res["bcast." + n] = p.detach().numpy()

# The GPipe checkpoint, written at data=2,pipe=2, loads on pipe=2,model=2.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=1,pipe=2,model=2"))
model = tpl.PipelinedLM(**cfg, n_layers=4, mesh=mesh, device="cpu", seed=3)
trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)), mesh=mesh,
                     param_specs=tpl.param_specs, device="cpu")
trainer.build()
_, epoch = checkpoint.restore_latest_and_broadcast(
    os.path.join(out, "ckpt-gpipe"), trainer.state)
res["restored.epoch"] = epoch
with torch.no_grad():
    res["restored.logits"] = model(torch.from_numpy(data["x"][0])).numpy()

# A TransformerLM on a pipe mesh: replicated over `pipe`, as under GSPMD.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,pipe=2"))
lm = ttr.TransformerLM(vocab_size=cfg["vocab_size"], d_model=32, n_heads=4,
                       n_layers=2, dropout=0.0, device="cpu", seed=4,
                       sharding=ttr.ShardingConfig(mesh=mesh))
trainer = ht.Trainer(lm, ht.DistributedOptimizer(ht.adam(lr)), mesh=mesh,
                     param_specs=ttr.param_specs, device="cpu")
res["lm.losses"] = fit(trainer, mesh)
for n, p in lm.named_parameters():
    res["lm." + n] = p.detach().numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(0)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y)
    return dict(x=x, y=y)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), RUNS=json.dumps(RUNS),
               CKPT=json.dumps(CKPT), STEPS=str(STEPS), LR=str(LR))
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, tmp):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)], out


def _stages(tag):
    return tmesh.MeshSpec.from_string(tag).resolve(NPROCS)["pipe"]


def _weights(n_layers, seed):
    model = tpl.PipelinedLM(**CFG, n_layers=n_layers, device="cpu",
                            seed=seed)
    return {n: t.clone() for n, t in model.state_dict().items()}


def _jax_reference(d, n_layers, stages, sched):
    """JAX's sequential model on the port's seed-1 weights (an
    interleaved model's stacks taken in placement order): logits of the
    global batch and the gradients of its mean cross-entropy, in the
    port's stored order."""
    tree = pipelined_params_to_flax(_weights(n_layers, 1))
    if sched == "interleaved":
        tree = jpl.to_logical_order(tree, n_layers, stages, V)
    jm = jpl.PipelinedLM(**CFG, n_layers=n_layers, mesh=None)
    x, y = jnp.asarray(d["x"][0]), jnp.asarray(d["y"][0])

    def loss(p):
        logits = jm.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    logits = jax.jit(lambda p: jm.apply({"params": p}, x))(tree)
    grads = jax.jit(jax.grad(loss))(tree)
    if sched == "interleaved":
        grads = jpl.to_interleaved_order(grads, n_layers, stages, V)
    return dict(logits=np.asarray(logits),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _one_rank_fit(d, n_layers, stages, sched, tmp):
    """The port at one rank: three Adam steps from the seed-2 weights (in
    logical order), with a checkpoint a step; parameters back in the
    stored order."""
    import horovod_tpu_torch as ht

    sd = _weights(n_layers, 2)
    if sched == "interleaved":
        sd = tpl.to_logical_order(sd, n_layers, stages, V)
    model = tpl.PipelinedLM(**CFG, n_layers=n_layers, device="cpu")
    model.load_state_dict(sd)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adam(LR)),
                         device="cpu")
    ckpt = tmp / f"one-{n_layers}-{stages}-{sched}"
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0, callbacks=[
                    ht.callbacks.ModelCheckpoint(
                        str(ckpt / "checkpoint-{epoch}.pt"))])
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    if sched == "interleaved":
        params = tpl.to_interleaved_order(params, n_layers, stages, V)
    return dict(losses=np.array([e["loss"] for e in trainer.history]),
                params={n: p.numpy() for n, p in params.items()}, ckpt=ckpt)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    d = _data(tmp)
    proc = _start(tmp)  # the ranks run while the references compute
    try:
        refs, fits = {}, {}
        for tag, sched, n_layers in RUNS:
            k = (n_layers, _stages(tag) if sched == "interleaved" else 0,
                 sched == "interleaved")
            if k not in refs:
                refs[k] = _jax_reference(d, n_layers, _stages(tag), sched)
                fits[k] = _one_rank_fit(d, n_layers, _stages(tag), sched,
                                        tmp)
        one_lm = _one_rank_lm(d)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    ranks, out = _finish(proc, tmp)
    return dict(data=d, refs=refs, fits=fits, ranks=ranks, out=out,
                tmp=tmp, one_lm=one_lm)


def _one_rank_lm(d):
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models import transformer as ttr

    lm = ttr.TransformerLM(vocab_size=VOCAB, d_model=32, n_heads=4,
                           n_layers=2, dropout=0.0, device="cpu", seed=4)
    trainer = ht.Trainer(lm, ht.DistributedOptimizer(ht.adam(LR)),
                         device="cpu")
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    return dict(losses=np.array([e["loss"] for e in trainer.history]),
                params={n: p.detach().numpy()
                        for n, p in lm.named_parameters()})


def _key(tag, sched, n_layers):
    return (n_layers, _stages(tag) if sched == "interleaved" else 0,
            sched == "interleaved")


def _rows(a, coords, tag):
    shape = tmesh.MeshSpec.from_string(tag).resolve(NPROCS)
    dp = shape["data"] * shape["fsdp"]
    di = int(coords[0]) * shape["fsdp"] + int(coords[1])
    b = a.shape[0] // dp
    return a[di * b:(di + 1) * b]


IDS = [f"{t}-{s}" for t, s, _ in RUNS]


def _adam_close(got, want, what):
    """Parameters after STEPS Adam steps: within PARAM_ATOL but for at
    most one element in a thousand, and every element within STEPS·LR."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    assert diff.max() <= STEPS * LR, (what, diff.max())
    assert (diff > PARAM_ATOL).mean() <= 1e-3, (
        what, int((diff > PARAM_ATOL).sum()), diff.size)


@pytest.mark.parametrize("tag,sched,n_layers", RUNS, ids=IDS)
def test_logits_and_gradients_match_jax_sequential(run, tag, sched,
                                                   n_layers):
    ref = run["refs"][_key(tag, sched, n_layers)]
    key = f"{tag}.{sched}"
    for res in run["ranks"]:
        coords = res[tag + ".coords"]
        np.testing.assert_allclose(res[key + ".logits"],
                                   _rows(ref["logits"], coords, tag),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(res[f"{key}.g.{name}"], g,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{key} {name}")


@pytest.mark.parametrize("tag,sched,n_layers", RUNS, ids=IDS)
def test_passes_follow_the_tick_model(run, tag, sched, n_layers):
    """At tick t stage s ran microbatch (t − s) mod T of round (t − s) div
    T, n_micro passes a round; 1F1B drained τ − (S − 1 − s); the tick
    counts are JAX's."""
    S = _stages(tag)
    v = V if sched == "interleaved" else 1
    for res in run["ranks"]:
        s = int(res[tag + ".coords"][2])
        key = f"{tag}.{sched}"
        assert int(res[key + ".ticks"]) == v * N_MICRO + S - 1
        assert [tuple(p) for p in res[key + ".forward"]] == \
            tpipe.tick_table(s, S, N_MICRO, v)
        assert len(res[key + ".forward"]) == v * N_MICRO
        back = [tuple(p) for p in res[key + ".backward"]]
        if sched == "1f1b":
            assert int(res[key + ".backward_ticks"]) == N_MICRO + S - 1
            assert back == [(tau, m, 0) for tau, m in
                            tpipe.drain_table(s, S, N_MICRO)]
            assert back[0][1] == 0 and back[0][0] == S - 1 - s
        else:  # the reverse of the forward's ticks
            assert int(res[key + ".backward_ticks"]) == v * N_MICRO + S - 1
            assert back == tpipe.tick_table(s, S, N_MICRO, v)[::-1]


@pytest.mark.parametrize("tag,sched,n_layers", RUNS, ids=IDS)
def test_adam_fit_equals_one_rank(run, tag, sched, n_layers):
    want = run["fits"][_key(tag, sched, n_layers)]
    key = f"{tag}.{sched}"
    ranks = run["ranks"]
    for res in ranks:
        np.testing.assert_allclose(res[key + ".fit.losses"], want["losses"],
                                   rtol=1e-5)
        assert int(res[key + ".fit.eager"]) == STEPS  # CPU: no graphs
        for name, p in want["params"].items():
            _adam_close(res[f"{key}.fit.{name}"], p, f"{key} {name}")
    # The data ranks of one stage (and model part) hold the same part.
    by_place = {}
    for res in ranks:
        c = res[tag + ".coords"]
        by_place.setdefault((int(c[2]), int(c[4])), []).append(res)
    for group in by_place.values():
        for res in group[1:]:
            for name in want["params"]:
                assert np.array_equal(res[f"{key}.fit.local.{name}"],
                                      group[0][f"{key}.fit.local.{name}"])


def test_broadcast_callback_syncs_replicated_leaves_and_keeps_stages(run):
    tag, key = "data=2,pipe=2", CKPT["gpipe"]
    ranks = run["ranks"]
    root = ranks[0]
    for res in ranks:
        c = res[tag + ".coords"]
        first = next(r for r, o in enumerate(ranks)
                     if int(o[tag + ".coords"][2]) == int(c[2])
                     and int(o[tag + ".coords"][0]) == 0)
        for name in ("embed", "ln_f", "lm_head"):
            np.testing.assert_array_equal(
                res["bcast." + name], root[f"{key}.fit.local.{name}"] + 1.0)
        for name in tpl._STACKED:
            # The stage keeps its own rows, its first data rank's (each
            # rank added its rank + 1 before the broadcast).
            np.testing.assert_array_equal(
                res["bcast." + name],
                ranks[first][f"{key}.fit.local.{name}"] + (first + 1.0))


@pytest.mark.parametrize("sched", ["gpipe", "interleaved"])
def test_checkpoint_at_pipe_2_equals_the_one_rank_file(run, sched):
    key = CKPT[sched]
    tag, _, n_layers = next(r for r in RUNS if f"{r[0]}.{r[1]}" == key)
    one = run["fits"][_key(tag, sched, n_layers)]
    for epoch in range(1, STEPS + 1):
        name = f"checkpoint-{epoch}.pt"
        got = torch.load(run["tmp"] / f"ckpt-{sched}" / name,
                         weights_only=True)
        want = torch.load(one["ckpt"] / name, weights_only=True)
        assert got["step"] == want["step"] == epoch
        wm = want["model"]
        if sched == "interleaved":
            wm = tpl.to_interleaved_order(wm, n_layers, _stages(tag), V)
        assert set(got["model"]) == set(wm)
        for n, t in got["model"].items():
            assert t.shape == wm[n].shape and t.dtype == wm[n].dtype, n
            _adam_close(t.numpy(), wm[n].numpy(), f"{sched} {epoch} {n}")
        gs, ws = got["optimizer"]["state"], want["optimizer"]["state"]
        assert len(gs) == len(ws)
        for k, st in gs.items():
            for leaf in ("exp_avg", "exp_avg_sq"):
                assert st[leaf].shape == ws[k][leaf].shape, (k, leaf)


@pytest.mark.parametrize("sched", ["gpipe", "interleaved"])
def test_export_at_pipe_2_matches_jax_sequential(run, sched):
    """`export_serving` of the seed-1 model held at ``data=2,pipe=2``
    (every rank called it and got the bundle's directory; rank 0 wrote
    one): the bundle's probabilities equal the softmax of JAX's sequential
    apply on the logical-order weights, so an interleaved model's
    placement-ordered stacks are exported in the order they run."""
    from horovod_tpu_torch import checkpoint

    key = CKPT[sched]
    tag, _, n_layers = next(r for r in RUNS if f"{r[0]}.{r[1]}" == key)
    stamp = "19700101-000000"
    for res in run["ranks"]:
        assert str(res[key + ".export"]).endswith(stamp)
    where = run["tmp"] / ("export-" + sched)
    assert os.listdir(where) == [stamp]
    fn = checkpoint.load_serving(str(where / stamp), device="cpu")
    want = jax.nn.softmax(run["refs"][_key(tag, sched, n_layers)]["logits"])
    np.testing.assert_allclose(fn(run["data"]["x"][0]), np.asarray(want),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_gpipe_checkpoint_loads_on_pipe_2_model_2(run):
    tag, sched, n_layers = RUNS[0]
    want_params = run["fits"][_key(tag, sched, n_layers)]["params"]
    plain = tpl.PipelinedLM(**CFG, n_layers=n_layers, device="cpu")
    plain.load_state_dict({n: torch.from_numpy(p)
                           for n, p in want_params.items()})
    with torch.no_grad():
        want = plain(torch.from_numpy(run["data"]["x"][0])).numpy()
    for res in run["ranks"]:
        assert int(res["restored.epoch"]) == STEPS
        np.testing.assert_allclose(res["restored.logits"], want, atol=1e-4,
                                   rtol=0)


def test_transformer_lm_replicated_over_pipe(run):
    one = run["one_lm"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res["lm.losses"], one["losses"],
                                   rtol=1e-5)
        for name, p in one["params"].items():
            _adam_close(res["lm." + name], p, name)


# -- the cut, against JAX's NamedSharding (in process) ------------------------


def _jax_params(n_layers):
    jm = jpl.PipelinedLM(**CFG, n_layers=n_layers)
    return jax.device_get(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, 8), jnp.int32))["params"])


@pytest.mark.parametrize("spec", ["data=2,pipe=2", "data=1,pipe=4",
                                  "data=1,pipe=2,model=2", "data=2,pipe=4",
                                  "data=2,pipe=2,model=2"])
def test_stack_shards_equal_jax_device_shards(spec):
    """Each rank's part of each parameter — `shard_state_dict` of the
    converted JAX tree, and what a `PipelinedLM` built on the rank's layout
    holds — equals JAX's shard on the device at the rank's coordinates
    under ``pipelined_lm.param_specs``; the pipelined ``qkv``'s head-major
    columns cut contiguously."""
    params = _jax_params(8)
    size = 8 if spec in ("data=2,pipe=4", "data=2,pipe=2,model=2") else 4
    n = tmesh.MeshSpec.from_string(spec).resolve(size)
    jm = jmesh.build_mesh(jmesh.MeshSpec(**n), jax.devices("cpu")[:size])
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jm, s), jpl.param_specs(params, jm),
        is_leaf=lambda s: isinstance(s, JP)))
    full = pipelined_params_from_flax(params)
    devices = list(jm.devices.reshape(-1))
    for r in range(size):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=size, rank=r)
        specs = tpl.param_specs(full, lay)
        mine = shard_state_dict(full, lay, specs)
        theirs = pipelined_params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed))
        model = tpl.PipelinedLM(**CFG, n_layers=8, mesh=lay, device="cpu")
        model.load_state_dict(mine)
        assert set(mine) == set(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), (spec, r, name)
            assert tuple(getattr(model, name).shape) == tuple(t.shape)


@pytest.mark.parametrize("spec", ["data=2,pipe=2", "data=1,pipe=2,model=2"])
def test_the_model_holds_its_cut_of_the_one_rank_weights(spec):
    n = tmesh.MeshSpec.from_string(spec).resolve(4)
    one = _weights(4, 5)
    for r in range(4):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=4, rank=r)
        model = tpl.PipelinedLM(**CFG, n_layers=4, mesh=lay, device="cpu",
                                seed=5)
        want = shard_state_dict(one, lay, model.cuts)
        for name, t in model.state_dict().items():
            assert torch.equal(t, want[name]), (spec, r, name)
        assert tuple(model.qkv.shape) == (
            4 // n["pipe"], 32, 96 // n["model"])
