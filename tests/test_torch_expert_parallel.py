"""Expert parallelism in the port, through its launcher at gloo ranks on
the CPU: meshes ``(data=1, expert=2)``, ``(data=1, expert=4)`` and
``(data=2, expert=2)``, one launch each, every rank running several
checks on its batch shard (``data=2``: rows ``[4i, 4i + 4)`` of each
global batch; aligned, 1024 tokens a shard against the JAX layer's
global groups of 1024):

* the mesh's subgroups — each rank's expert and batch groups are the
  ranks JAX's flat layout puts there;
* the `MoEMlp` layer sharded over ``expert`` — its output rows and the
  gradients of its input and every parameter (expert shards gathered,
  shard gradients summed) against the JAX unsharded layer and the one-rank
  port on the global input;
* the MoE `TransformerLM` — per-token loss, the aux loss, and every
  gradient (averaged over the batch shards, as the optimizer does) against
  the one-rank port on the global batch;
* three `Trainer.fit` steps with SGD — losses (averaged over the ranks)
  and every parameter against the one-rank fit on the same global
  batches; replicated parameters bit-equal on every rank, each expert
  shard bit-equal across its batch group; the steps ran eagerly (gloo);
  then ``evaluate(cache="device")`` against the one-rank evaluate;
* a checkpoint at ``expert=2`` (AdamW): the file holds the full experts
  and their optimizer state, restores at one rank (in this process) and
  round-trips at two;
* at ``data=2``, shards of 1536 tokens whose JAX groups of 1024 straddle
  them: the per-token loss, the aux loss and the drop rate against the
  one-rank model on the global batch.

JAX's three refusals of ``param_specs`` run in-process.

Tolerances: f32 on both sides, the same sums in other orders (the expert
group's all-reduce adds partial outputs): outputs, losses and gradients
1e-5 relative to each tensor's largest element; parameters after three
SGD steps 1e-5 abs.
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

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
RTOL, PARAM_ATOL = 1e-5, 1e-5
B_SHARD, T, D, E, STEPS, LR = 4, 256, 32, 4, 3, 0.5
CFG = dict(vocab_size=64, d_model=D, n_heads=4, n_layers=2, dropout=0.0,
           moe_every=2, n_experts=E, capacity_factor=1.0, fused_head_chunks=2)
LAYER = dict(n_experts=E, k=2, capacity_factor=1.0)

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, checkpoint
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
layer_kw = json.loads(os.environ["LAYER"])
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["MESH"]))
data = np.load(os.path.join(out, "data.npz"))
dp, di = mesh.data_shards, mesh.data_index
b = data["x"].shape[1] // dp
mine = slice(di * b, (di + 1) * b)
shard = ttr.ShardingConfig(mesh=mesh)
res = {"coords": np.array([mesh.coords[a] for a in tmesh.AXES])}


def members(group):
    if group is c.SELF:
        return [r]
    got = [None] * c.group_size(group)
    torch.distributed.all_gather_object(got, r, group=group)
    return got


res["expert_members"] = np.array(members(mesh.group("expert")))
bg = mesh.batch_group
res["batch_members"] = np.array(members(bg) if bg is not None
                                else list(range(ht.size())))


def batch_sum(t):
    return t if bg is None or bg is c.SELF else c.all_reduce_sum(t, bg)


def full_grads(module, specs, scale):
    grads = {n: batch_sum(p.grad) * scale
             for n, p in module.named_parameters()}
    return gather_state_dict(grads, mesh, specs)


# -- the layer --------------------------------------------------------------
layer = tmoe.MoEMlp(cfg["d_model"], sharding=shard, seed=5, **layer_kw)
xin = torch.from_numpy(data["h"][mine]).requires_grad_()
y = layer(xin, train=True)
aux = layer.sown["losses"]["moe_load_balance"]
((y ** 2).sum() + aux / dp).backward()
lspecs = {n: ({0: "expert"} if n.startswith("moe_") else {})
          for n, _ in layer.named_parameters()}
res["layer_out"] = y.detach().numpy()
res["layer_gx"] = xin.grad.numpy()
for n, g in full_grads(layer, lspecs, 1.0).items():
    res["layer_g." + n] = g.numpy()
res["layer_drop"] = float(layer.sown["metrics"]["moe_drop_rate"])

# -- the LM -----------------------------------------------------------------
model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=1)
specs = ttr.live_placements(ttr.param_specs(model, mesh), mesh)
x = torch.from_numpy(data["x"][0][mine])
yl = torch.from_numpy(data["y"][0][mine])
loss, _ = model(x, labels=yl, train=True, dropout_seed=0)
obj = loss.mean() + sum(model.sown_losses())
obj.backward()
res["lm_loss"] = loss.detach().numpy()
res["lm_obj"] = float(obj.detach())
for n, g in full_grads(model, specs, 1.0 / dp).items():
    res["lm_g." + n] = g.numpy()

# -- three SGD steps --------------------------------------------------------
model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=2)
trainer = ht.Trainer(model, ht.DistributedOptimizer(functools.partial(
    torch.optim.SGD, lr=float(os.environ["LR"]))), loss="module", mesh=mesh,
    param_specs=ttr.param_specs, device="cpu")
batches = [(xs[mine], ys[mine]) for xs, ys in zip(data["x"], data["y"])]
trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
            callbacks=[callbacks.MetricAverageCallback()], verbose=0)
res["fit_losses"] = np.array([e["loss"] for e in trainer.history])
res["fit_drop"] = np.array([e["moe_drop_rate"] for e in trainer.history])
res["fit_eager"] = trainer._runner.eager_steps
for n, p in model.named_parameters():
    res["local." + n] = p.detach().numpy()
for n, t in trainer.state.full_model_state().items():
    res["fit." + n] = t.numpy()
# The device-cached evaluate stays allowed on an EP mesh: shard r holds
# rows [r·per, (r+1)·per), the one-rank evaluate's batches.
ev = trainer.evaluate(data["x"][0], data["y"][0], batch_size=b,
                      cache="device")
res["eval_cached"] = np.array([ev["loss"], ev["accuracy"]])

# -- a checkpoint ------------------------------------------------------------
if os.environ.get("CKPT"):
    ck = os.path.join(out, "ckpt")
    model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=3)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(ht.adamw(1e-2)),
                         loss="module", mesh=mesh,
                         param_specs=ttr.param_specs, device="cpu")
    cbs = ([callbacks.ModelCheckpoint(os.path.join(ck, "checkpoint-{epoch}.pt"))]
           if r == 0 else [])
    trainer.fit(dataset=batches[:2], epochs=2, steps_per_epoch=1,
                callbacks=cbs, verbose=0)
    full = trainer.state.full_model_state()
    opt = trainer.tx.state_dict()
    for n, t in full.items():
        res["ck." + n] = t.numpy()
    for i, st in opt["state"].items():
        res[f"ck_opt.{i}"] = st["exp_avg"].numpy()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    fresh = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=4)
    t2 = ht.Trainer(fresh, ht.DistributedOptimizer(ht.adamw(1e-2)),
                    loss="module", mesh=mesh, param_specs=ttr.param_specs,
                    device="cpu")
    state, epoch = checkpoint.restore_latest_and_broadcast(ck, t2.build())
    res["restored_epoch"] = epoch
    res["restored_equal"] = all(torch.equal(p, before[n])
                                for n, p in fresh.named_parameters())

# -- groups across the data shards ---------------------------------------------
if dp > 1:
    # 1536 tokens a shard: JAX's three groups of 1024, the middle one
    # across the shards.
    odd = torch.from_numpy(data["odd"][3 * di:3 * di + 3])
    model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=6)
    loss, _ = model(odd, labels=torch.roll(odd, -1, 1), train=True,
                    dropout_seed=0)
    res["odd_loss"] = loss.detach().numpy()
    res["odd_aux"] = float(model.sown_losses()[0].detach())
    res["odd_drop"] = float(model.sown_metrics()["moe_drop_rate"])

np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _launch(tmp, nprocs, mesh, ckpt=False):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), MESH=mesh, CFG=json.dumps(CFG),
               LAYER=json.dumps(LAYER), LR=str(LR),
               CKPT="1" if ckpt else "")
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nprocs)]


def _data(tmp, dp):
    rng = np.random.RandomState(dp)
    x = rng.randint(0, CFG["vocab_size"], (STEPS, dp * B_SHARD, T))
    y = np.roll(x, -1, axis=2)
    h = rng.randn(dp * B_SHARD, T, D).astype(np.float32)
    odd = rng.randint(0, CFG["vocab_size"], (3 * dp, 512)).astype(np.int64)
    np.savez(tmp / "data.npz", x=x.astype(np.int32), y=y.astype(np.int32),
             h=h, odd=odd)
    return x.astype(np.int32), y.astype(np.int32), h, odd


WORLDS = {"data1_expert2": (2, "data=1,expert=2", True),
          "data1_expert4": (4, "data=1,expert=4", False),
          "data2_expert2": (4, "data=2,expert=2", False)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``get(name)``: the world's launch, made once."""
    done: dict = {}

    def get(name):
        if name not in done:
            nprocs, mesh, ckpt = WORLDS[name]
            tmp = tmp_path_factory.mktemp(name)
            shape = tmesh.MeshSpec.from_string(mesh).resolve(nprocs)
            data = _data(tmp, shape["data"])
            ranks = _launch(tmp, nprocs, mesh, ckpt)
            done[name] = dict(name=name, nprocs=nprocs, mesh=mesh,
                              dp=shape["data"], shape=shape, data=data,
                              ranks=ranks, tmp=tmp)
        return done[name]

    return get


@pytest.fixture(params=list(WORLDS))
def world(request, worlds):
    return worlds(request.param)


def _rel_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= RTOL, (what, err)


def test_subgroups_are_the_flat_layout(world):
    shape = world["shape"]
    for r, res in enumerate(world["ranks"]):
        ex = [g for g in tmesh.axis_rank_lists(shape, "expert") if r in g][0]
        bg = [g for g in tmesh.axis_rank_lists(shape, ("data", "fsdp"))
              if r in g][0]
        assert list(res["expert_members"]) == ex
        assert list(res["batch_members"]) == (
            bg if len(bg) < world["nprocs"] else list(range(world["nprocs"])))
        want = tmesh.build_mesh(tmesh.MeshSpec.from_string(world["mesh"]),
                                n_ranks=world["nprocs"], rank=r)
        assert list(res["coords"]) == [want.coords[a] for a in tmesh.AXES]


def _flax_layer_params(layer):
    return {"router": {"kernel": layer.router.weight.detach().numpy().T},
            "moe_up": layer.moe_up.detach().numpy(),
            "moe_down": layer.moe_down.detach().numpy()}


def test_layer_matches_jax_and_one_rank(world):
    _, _, h, _ = world["data"]
    dp = world["dp"]
    one = tmoe.MoEMlp(D, seed=5, **LAYER)
    xin = torch.from_numpy(h).requires_grad_()
    y = one(xin, train=True)
    ((y ** 2).sum() + one.sown["losses"]["moe_load_balance"]).backward()
    jm = jmoe.MoEMlp(D, **LAYER)

    def loss_fn(p, xx):
        out, st = jm.apply({"params": p}, xx, train=True,
                           mutable=["losses", "metrics"])
        aux = st["losses"]["moe_load_balance"][0]
        return (out ** 2).sum() + aux, out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(_flax_layer_params(one),
                                               jnp.asarray(h))
    jgrads = {"router.weight": np.asarray(jg["router"]["kernel"]).T,
              "moe_up": np.asarray(jg["moe_up"]),
              "moe_down": np.asarray(jg["moe_down"])}
    b = h.shape[0] // dp
    for r, res in enumerate(world["ranks"]):
        di = res["coords"][0]
        rows = slice(di * b, (di + 1) * b)
        _rel_close(res["layer_out"], np.asarray(jout)[rows], "out vs jax")
        _rel_close(res["layer_out"], y.detach().numpy()[rows], "out")
        _rel_close(res["layer_gx"], np.asarray(jgx)[rows], "gx vs jax")
        _rel_close(res["layer_gx"], xin.grad.numpy()[rows], "gx")
        for n, p in one.named_parameters():
            _rel_close(res["layer_g." + n], jgrads[n], n + " vs jax")
            _rel_close(res["layer_g." + n], p.grad.numpy(), n)


def test_lm_loss_and_grads_match_one_rank(world):
    x, y, _, _ = world["data"]
    dp = world["dp"]
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=1)
    loss, _ = tm(torch.from_numpy(x[0]), labels=torch.from_numpy(y[0]),
                 train=True, dropout_seed=0)
    obj = loss.mean() + sum(tm.sown_losses())
    obj.backward()
    b = x.shape[1] // dp
    per_shard = {}
    for res in world["ranks"]:
        di = int(res["coords"][0])
        _rel_close(res["lm_loss"], loss.detach().numpy()[di * b:(di + 1) * b],
                   "loss")
        per_shard.setdefault(di, float(res["lm_obj"]))
        for n, p in tm.named_parameters():
            _rel_close(res["lm_g." + n], p.grad.numpy(), n)
    # Each shard's objective holds its own groups' aux loss; their mean is
    # the one-rank objective.
    assert np.mean(list(per_shard.values())) == pytest.approx(
        float(obj.detach()), rel=RTOL)


def test_fit_equals_one_rank_fit(world):
    x, y, _, _ = world["data"]
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=LR)), loss="module", device="cpu")
    trainer.fit(dataset=list(zip(x, y)), epochs=STEPS, steps_per_epoch=1,
                verbose=0)
    want_losses = [e["loss"] for e in trainer.history]
    want_drop = [e["moe_drop_rate"] for e in trainer.history]
    ev = trainer.evaluate(x[0], y[0], batch_size=B_SHARD)
    ranks = world["ranks"]
    for res in ranks:
        _rel_close(res["fit_losses"], want_losses, "losses")
        _rel_close(res["eval_cached"], [ev["loss"], ev["accuracy"]],
                   "cached evaluate")
        np.testing.assert_allclose(res["fit_drop"], want_drop, atol=1e-6)
        assert int(res["fit_eager"]) == STEPS  # gloo: eager steps
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(res["fit." + n], p.detach().numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)
    # Replicated parameters bit-equal on every rank; each expert shard
    # bit-equal across its batch group.
    shape = world["shape"]
    for n in [k for k in ranks[0] if k.startswith("local.")]:
        if ".moe.moe_" in n:
            for g in tmesh.axis_rank_lists(shape, ("data", "fsdp")):
                for r in g[1:]:
                    assert np.array_equal(ranks[r][n], ranks[g[0]][n]), n
        else:
            for res in ranks[1:]:
                assert np.array_equal(res[n], ranks[0][n]), n


def test_checkpoint_restores_at_one_rank(worlds):
    world = worlds("data1_expert2")
    ranks = world["ranks"]
    assert int(ranks[0]["restored_epoch"]) == 2
    assert all(bool(res["restored_equal"]) for res in ranks)
    path = checkpoint.latest_checkpoint(str(world["tmp"] / "ckpt"))
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=9)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adamw(1e-2)),
                         loss="module", device="cpu")
    state = checkpoint.restore(path, trainer.build())
    for n, t in state.model.state_dict().items():
        assert np.array_equal(t.numpy(), ranks[0]["ck." + n]), n
        assert t.shape == tuple(ranks[0]["ck." + n].shape)
    up = state.model.blocks[1].moe.moe_up
    assert up.shape[0] == E  # the full experts
    opt = state.optimizer.state_dict()["state"]
    for i, st in opt.items():
        assert np.array_equal(st["exp_avg"].numpy(), ranks[0][f"ck_opt.{i}"])


def test_misaligned_grouping_refused(worlds):
    """A data shard of 1536 tokens, whose JAX groups of 1024 straddle the
    shards, now groups as JAX does: each shard's per-token loss, and the
    global aux loss and drop rate on every rank, equal the one-rank
    model's on the global batch."""
    world = worlds("data2_expert2")
    odd = world["data"][3]
    one = ttr.TransformerLM(**CFG, device="cpu", seed=6)
    x = torch.from_numpy(odd)
    loss, _ = one(x, labels=torch.roll(x, -1, 1), train=True,
                  dropout_seed=0)
    b = odd.shape[0] // world["dp"]
    for res in world["ranks"]:
        di = int(res["coords"][0])
        _rel_close(res["odd_loss"], loss.detach().numpy()[di * b:(di + 1) * b],
                   "loss")
        _rel_close(res["odd_aux"], float(one.sown_losses()[0]), "aux")
        assert float(res["odd_drop"]) == pytest.approx(
            float(one.sown_metrics()["moe_drop_rate"]), abs=1e-6)


@pytest.mark.parametrize("kw", [
    dict(tx=dict(compression="bf16")),
    dict(tx=dict(backward_passes_per_step=2)),
    dict(trainer=dict(shard_update=True)),
], ids=["compression", "backward_passes_per_step", "shard_update"])
def test_param_specs_refusals_match_jax(kw):
    jkw = dict(kw.get("tx", {}))
    jtx = hvt.DistributedOptimizer(optax.adam(1e-3), **jkw)
    with pytest.raises(ValueError) as ref:
        hvt.Trainer(jtr.TransformerLM(**CFG), jtx,
                    param_specs=jtr.param_specs, **kw.get("trainer", {}))
    ttx = ht.DistributedOptimizer(ht.adam(1e-3), **jkw)
    with pytest.raises(ValueError) as port:
        ht.Trainer(ttr.TransformerLM(**CFG, device="cpu"), ttx,
                   param_specs=ttr.param_specs, device="cpu",
                   **kw.get("trainer", {}))
    assert str(port.value) == str(ref.value)
