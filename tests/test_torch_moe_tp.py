"""The MoE `TransformerLM` on a live ``model`` or ``fsdp`` axis — the port of
tests/test_moe.py::test_ep_tp_composition — through the port's launcher at
four gloo ranks on the CPU, meshes ``(data=1, expert=2, model=2)`` (every
rank holds the whole batch: 4 096 tokens, four dispatch groups of 1 024)
and ``(data=2, fsdp=2)`` (rows ``[4i, 4i + 4)`` of the 16-row batch: 1 024
tokens a shard, aligned with the JAX layer's global groups) in one launch:

* the `MoEMlp` layer at ``expert=2, model=2`` (``moe_up`` ``(expert, None,
  model)``, ``moe_down`` ``(expert, model, None)``) on JAX's test input:
  its output and the gradients of its input and every parameter against
  JAX's unsharded layer at JAX's tolerances, and its output against JAX's
  layer sharded over ``data=2, expert=2, model=2`` on the conftest's eight
  virtual devices;
* the MoE LM on both meshes — per-token loss and every gradient (gathered,
  summed over the shard groups and divided by dp, as the optimizer does)
  against the one-rank port on the global batch;
* three SGD ``fit`` steps on both meshes against the one-rank fit: losses,
  ``moe_drop_rate`` and every parameter; the steps ran eagerly (gloo);
* greedy decoding at ``expert=2, model=2`` (``capacity_factor=4``,
  drop-free) against JAX's `make_generate_fn` from the same weights;
* in process: each rank's cut of the expert stacks equals the conversion of
  JAX's device shard under its ``param_specs`` at ``data=2, expert=2,
  model=2``, and a model built on an eight-rank layout holds its cut of the
  one-rank weights.

Tolerances: the layer against JAX rtol 1e-4, atol 1e-5
(``test_ep_tp_composition``); everything else f32 on both sides with the
same sums in other orders (g and the expert group's all-reduces add
partial outputs): 1e-5 relative to each tensor's largest element,
parameters after three SGD steps 1e-5 abs; decoded tokens and shards
exactly.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import horovod_tpu_torch as ht
from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    params_from_flax, params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
RTOL, PARAM_ATOL, JAX_RTOL, JAX_ATOL = 1e-5, 1e-5, 1e-4, 1e-5
ROWS, T, STEPS, LR = 16, 256, 3, 0.5
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, dropout=0.0,
           moe_every=2, n_experts=4, capacity_factor=1.0, fused_head_chunks=2)
# tests/test_moe.py::test_ep_tp_composition's layer and input.
LAYER_D = 16
LAYER = dict(n_experts=4, k=2, capacity_factor=2.0)
MESHES = ["data=1,expert=2,model=2", "data=2,fsdp=2"]
PROMPT, NEW = (2, 8), 6

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.decoding import make_generate_fn
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
layer_kw = json.loads(os.environ["LAYER"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def full_grads(module, mesh, specs, scale):
    """Every gradient whole: an fsdp shard's summed over the data ranks
    (its gather's reduce-scatter summed it over fsdp), the rest over the
    gradient group, as the optimizer reduces them."""
    grads = {}
    for n, p in module.named_parameters():
        group = (mesh.shard_grad_group if "fsdp" in specs.get(n, {}).values()
                 else mesh.grad_group)
        g = p.grad if group is c.SELF else c.all_reduce_sum(p.grad, group)
        grads[n] = g * scale
    return gather_state_dict(grads, mesh, specs)


for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    shard = ttr.ShardingConfig(mesh=mesh)
    dp, di = mesh.data_shards, mesh.data_index
    b = data["x"].shape[1] // dp
    mine = slice(di * b, (di + 1) * b)
    res[tag + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])

    if mesh.shape["model"] > 1:
        layer = tmoe.MoEMlp(data["h"].shape[-1], sharding=shard, seed=5,
                            **layer_kw)
        xin = torch.from_numpy(data["h"]).requires_grad_()
        y = layer(xin, train=True)
        ((y ** 2).sum() + layer.sown["losses"]["moe_load_balance"]).backward()
        lspecs = ttr.live_placements(
            {"moe_up": {0: "expert", 2: "model"},
             "moe_down": {0: "expert", 1: "model"}}, mesh)
        res["layer_out"] = y.detach().numpy()
        res["layer_gx"] = xin.grad.numpy()
        for n, g in full_grads(layer, mesh, lspecs, 1.0).items():
            res["layer_g." + n] = g.numpy()

    model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=1)
    specs = ttr.live_placements(ttr.param_specs(model, mesh), mesh)
    x = torch.from_numpy(data["x"][0][mine])
    yl = torch.from_numpy(data["y"][0][mine])
    loss, _ = model(x, labels=yl, train=True, dropout_seed=0)
    (loss.mean() + sum(model.sown_losses())).backward()
    res[tag + ".loss"] = loss.detach().numpy()
    for n, g in full_grads(model, mesh, specs, 1.0 / dp).items():
        res[f"{tag}.g.{n}"] = g.numpy()

    model = ttr.TransformerLM(**cfg, sharding=shard, device="cpu", seed=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(functools.partial(
        torch.optim.SGD, lr=float(os.environ["LR"]))), loss="module",
        mesh=mesh, param_specs=ttr.param_specs, device="cpu")
    batches = [(xs[mine], ys[mine]) for xs, ys in zip(data["x"], data["y"])]
    trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
                callbacks=[callbacks.MetricAverageCallback()], verbose=0)
    res[tag + ".fit_losses"] = np.array([e["loss"] for e in trainer.history])
    res[tag + ".fit_drop"] = np.array(
        [e["moe_drop_rate"] for e in trainer.history])
    res[tag + ".fit_eager"] = trainer._runner.eager_steps
    for n, t in trainer.state.full_model_state().items():
        res[f"{tag}.fit.{n}"] = t.numpy()

    if mesh.shape["model"] > 1:
        model = ttr.TransformerLM(**dict(cfg, capacity_factor=4.0),
                                  sharding=shard, device="cpu", seed=3)
        gen = make_generate_fn(model, max_new_tokens=int(os.environ["NEW"]),
                               include_prompt=False)
        res["decode"] = gen(torch.from_numpy(data["prompt"])).numpy()
        res["decode_eager"] = gen.steps.eager_steps

np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(3)
    x = rng.randint(0, CFG["vocab_size"], (STEPS, ROWS, T)).astype(np.int32)
    y = np.roll(x, -1, axis=2).astype(np.int32)
    h = np.random.RandomState(7).rand(2, 8, LAYER_D).astype(np.float32)
    prompt = rng.randint(1, CFG["vocab_size"], PROMPT).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y, h=h, prompt=prompt)
    return dict(x=x, y=y, h=h, prompt=prompt)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), LAYER=json.dumps(LAYER),
               MESHES=json.dumps(MESHES), LR=str(LR), NEW=str(NEW))
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)]


def _one_rank(d):
    """The one-rank port on the global batch: the LM's loss and gradients,
    and the three-step fit."""
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=1)
    loss, _ = tm(torch.from_numpy(d["x"][0]), labels=torch.from_numpy(
        d["y"][0]), train=True, dropout_seed=0)
    (loss.mean() + sum(tm.sown_losses())).backward()
    one = dict(loss=loss.detach().numpy(),
               grads={n: p.grad.numpy() for n, p in tm.named_parameters()})
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=LR)), loss="module", device="cpu")
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    one["losses"] = [e["loss"] for e in trainer.history]
    one["drop"] = [e["moe_drop_rate"] for e in trainer.history]
    one["params"] = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    return one


def _flax_layer_params(layer):
    return {"router": {"kernel": layer.router.weight.detach().numpy().T},
            "moe_up": layer.moe_up.detach().numpy(),
            "moe_down": layer.moe_down.detach().numpy()}


def _jax_layer(d):
    """JAX's unsharded layer (output and gradients) and its layer sharded
    over ``data=2, expert=2, model=2`` (output), from the port's seed-5
    weights."""
    one = tmoe.MoEMlp(LAYER_D, seed=5, **LAYER)
    params = _flax_layer_params(one)
    jm = jmoe.MoEMlp(LAYER_D, **LAYER)

    def loss_fn(p, xx):
        out, st = jm.apply({"params": p}, xx, train=True,
                           mutable=["losses", "metrics"])
        return (out ** 2).sum() + st["losses"]["moe_load_balance"][0], out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(d["h"]))
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=2, expert=2, model=2),
                            jax.devices("cpu"))
    sharded = jmoe.MoEMlp(LAYER_D, **LAYER,
                          sharding=jtr.ShardingConfig(mesh=mesh))
    out_sharded = jax.jit(lambda v, t: sharded.apply(v, t))(
        {"params": params}, jnp.asarray(d["h"]))
    return dict(out=np.asarray(jout), gx=np.asarray(jgx),
                sharded=np.asarray(out_sharded),
                grads={"router.weight": np.asarray(jg["router"]["kernel"]).T,
                       "moe_up": np.asarray(jg["moe_up"]),
                       "moe_down": np.asarray(jg["moe_down"])})


def _jax_decode(d):
    """JAX's greedy decode at ``capacity_factor=4`` from the port's seed-3
    weights."""
    cfg = dict(CFG, capacity_factor=4.0)
    tm = ttr.TransformerLM(**cfg, device="cpu", seed=3)
    jm = jtr.TransformerLM(**cfg)
    params = params_to_flax(tm.state_dict(), n_heads=CFG["n_heads"])
    fn = jdec.make_generate_fn(jm, max_new_tokens=NEW, include_prompt=False)
    jax_tokens = np.asarray(fn(params, jnp.asarray(d["prompt"]),
                               jax.random.PRNGKey(0)))
    port = tdec.make_generate_fn(tm, max_new_tokens=NEW,
                                 include_prompt=False)
    return jax_tokens, port(torch.from_numpy(d["prompt"])).numpy()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_tp")
    d = _data(tmp)
    proc = _start(tmp)  # the ranks run while the references compute
    try:
        refs = dict(one=_one_rank(d), layer=_jax_layer(d),
                    decode=_jax_decode(d))
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return dict(data=d, ranks=_finish(proc, tmp), **refs)


def _rel_close(got, want, what, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


def test_ep_tp_layer_matches_jax(run):
    """``test_ep_tp_composition``'s function: the layer at ``expert=2,
    model=2`` against JAX's unsharded layer and JAX's own sharded one."""
    ref = run["layer"]
    for res in run["ranks"]:
        for key, want in (("out", ref["out"]), ("gx", ref["gx"])):
            np.testing.assert_allclose(res["layer_" + key], want,
                                       rtol=JAX_RTOL, atol=JAX_ATOL)
        np.testing.assert_allclose(res["layer_out"], ref["sharded"],
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
        for n, g in ref["grads"].items():
            np.testing.assert_allclose(res["layer_g." + n], g,
                                       rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=n)


@pytest.mark.parametrize("mesh", MESHES)
def test_lm_loss_and_grads_match_one_rank(run, mesh):
    one = run["one"]
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    dp = shape["data"] * shape["fsdp"]
    b = ROWS // dp
    for res in run["ranks"]:
        c = res[mesh + ".coords"]
        di = int(c[0]) * shape["fsdp"] + int(c[1])
        _rel_close(res[mesh + ".loss"], one["loss"][di * b:(di + 1) * b],
                   "loss")
        for n, g in one["grads"].items():
            _rel_close(res[f"{mesh}.g.{n}"], g, n)


@pytest.mark.parametrize("mesh", MESHES)
def test_fit_equals_one_rank_fit(run, mesh):
    one = run["one"]
    for res in run["ranks"]:
        _rel_close(res[mesh + ".fit_losses"], one["losses"], "losses")
        np.testing.assert_allclose(res[mesh + ".fit_drop"], one["drop"],
                                   atol=1e-6)
        assert int(res[mesh + ".fit_eager"]) == STEPS  # gloo: eager steps
        for n, p in one["params"].items():
            np.testing.assert_allclose(res[f"{mesh}.fit.{n}"], p,
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)


def test_decode_on_a_model_axis_matches_jax(run):
    jax_tokens, one = run["decode"]
    np.testing.assert_array_equal(one, jax_tokens)
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["decode"], jax_tokens)
        assert int(res["decode_eager"]) == NEW - 1  # gloo: eager steps


def _jax_params():
    jm = jtr.TransformerLM(**CFG)
    return jax.device_get(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"])


def test_expert_stacks_cut_as_jax_shards():
    """At ``data=2, expert=2, model=2`` on eight devices: each rank's part
    of every parameter (``expert`` and ``model`` placements; JAX's
    ``fsdp`` is not live there) is the conversion of JAX's shard on the
    device at its coordinates."""
    spec = "data=2,expert=2,model=2"
    params = _jax_params()
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    jspecs = jtr.param_specs(params, jm)
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jm, s), jspecs,
        is_leaf=lambda s: isinstance(s, JP)))
    assert tuple(jspecs["Block_1"]["moe"]["moe_up"]) == (
        "expert", None, "model")
    full = params_from_flax(params)
    devices = list(jm.devices.reshape(-1))
    for r in range(8):
        tm = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                              rank=r)
        mine = shard_state_dict(full, tm, ttr.live_placements(
            ttr.param_specs(full, tm), tm))
        theirs = params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed))
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), (r, name)


@pytest.mark.parametrize("spec", ["data=1,expert=2,model=2,fsdp=2",
                                  "data=2,fsdp=2,model=2"])
def test_the_model_holds_its_cut_of_the_one_rank_weights(spec):
    one = ttr.TransformerLM(**CFG, device="cpu", seed=4)
    for r in range(8):
        mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                                rank=r)
        tm = ttr.TransformerLM(**CFG, device="cpu", seed=4,
                               sharding=ttr.ShardingConfig(mesh=mesh))
        want = shard_state_dict(one.state_dict(), mesh, ttr.live_placements(
            ttr.param_specs(tm, mesh), mesh))
        for name, t in tm.state_dict().items():
            assert torch.equal(t, want[name]), (spec, r, name)
        # Experts over `expert`, hidden features over `model`, and the
        # first free divisible dim (d) over `fsdp`.
        moe, n = tm.blocks[1].moe, mesh.shape
        assert tuple(moe.moe_up.shape) == (
            4 // n["expert"], 32 // n["fsdp"], 128 // n["model"])
        assert tuple(moe.moe_down.shape) == (
            4 // n["expert"], 128 // n["model"], 32 // n["fsdp"])
        assert moe.full_shape("moe_up") == (4, 32, 128)
