"""LoRA on a live ``model`` or ``fsdp`` axis (`horovod_tpu_torch.models.lora`),
through the port's launcher at four gloo ranks on the CPU, meshes
``(data=2, model=2)`` and ``(data=2, fsdp=2)`` in one launch, on
tests/test_lora.py's model (vocab 64, d 32, 4 heads, 2 layers; x [16, 12],
rows ``[8i, 8i + 8)`` on data shard i):

* the wrapped forward and the adapters' gradients of a cross-entropy
  (gathered, summed as the optimizer sums them and divided by dp) from
  JAX's parameters moved by seeded noise (B nonzero) against JAX's
  `LoRAModel`: on ``model`` the adapters stay whole on every rank, as
  JAX's `param_specs` leaves them, and their delta is cut as the kernel
  is, behind Megatron's f; on ``fsdp`` they hold JAX's ``fsdp`` placement
  of their own shapes and are gathered at use;
* five ``freeze_base(adamw)`` steps under the Trainer against JAX's
  `LoRAModel` under its Trainer: losses, the base untouched, the adapters;
  `LoRAModel.unsharded` (the exports' gather) holds the trainer's whole
  state;
* in process, JAX's four ``TestLoRAWithTP`` rules on models built on
  eight-rank layouts: rank-3 adapters whole on a ``data=4, model=2``
  mesh while the base holds its cut; a wrapped `LoRAModel` keeps the
  exemption; a submodule merely named ``lora`` keeps its TP placement;
  adapters of expert weights skip the expert rule — built on a ``model``
  mesh, and refused naming ROADMAP queue A item 17 where ``expert`` shards
  the stacks; and the adapters' ``fsdp`` dims at ``data=2, fsdp=2,
  model=2`` are JAX's.

Tolerances (tests/test_torch_lora.py's): logits and gradients 1e-5
relative to each tensor's largest element, losses 1e-5 abs; after five
AdamW steps the adapters within 1e-5 abs except where a gradient element
was tiny but not zero at some step of the one-rank port's fit (Adam's
g / (|g| + eps) turns f32 rounding into up to ±lr a step): 2·lr·steps
there.
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
from torch import nn

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.models import lora as jlora
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import lora
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import lm_kernels, lora_params_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
RANK, ALPHA, LR, STEPS, TINY, RTOL = 4, 8.0, 1e-2, 5, 1e-4, 1e-5
MESHES = ["data=2,model=2", "data=2,fsdp=2"]

CHILD = r'''
import json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import lora, transformer as ttr
from horovod_tpu_torch.models.convert import (
    gather_state_dict, shard_state_dict,
)
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
rank, alpha = int(os.environ["RANK"]), float(os.environ["ALPHA"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def build(mesh, key):
    model = lora.LoRAModel(ttr.TransformerLM(
        **cfg, device="cpu", sharding=ttr.ShardingConfig(mesh=mesh)),
        rank=rank, alpha=alpha)
    specs = ttr.live_placements(ttr.param_specs(model, mesh), mesh)
    full = {k[len(key) + 1:]: torch.from_numpy(v) for k, v in data.items()
            if k.startswith(key + ".")}
    model.load_state_dict(shard_state_dict(full, mesh, specs))
    return model, specs


for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    dp, di = mesh.data_shards, mesh.data_index
    b = data["x"].shape[0] // dp
    mine = slice(di * b, (di + 1) * b)
    x = torch.from_numpy(data["x"][mine])
    y = torch.from_numpy(data["y"][mine]).long()
    model, specs = build(mesh, "bumped")
    res[tag + ".whole"] = np.array([
        tuple(p.shape) == tuple(data["bumped." + n].shape)
        for n, p in model.named_parameters() if n.startswith("lora.")])
    logits = model(x)
    res[tag + ".logits"] = logits.detach().numpy()
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    y.reshape(-1)).backward()
    grads = {}
    for n, p in model.named_parameters():
        if n.startswith("lora."):
            group = (mesh.shard_grad_group
                     if "fsdp" in specs.get(n, {}).values()
                     else mesh.grad_group)
            g = p.grad if group is c.SELF else c.all_reduce_sum(p.grad, group)
            grads[n] = g / dp
    for n, g in gather_state_dict(grads, mesh, specs).items():
        res[f"{tag}.g.{n}"] = g.numpy()

    model, _ = build(mesh, "p0")
    trainer = ht.Trainer(
        model, ht.DistributedOptimizer(lora.freeze_base(ht.adamw(float(
            os.environ["LR"])))), loss="sparse_categorical_crossentropy",
        mesh=mesh, param_specs=ttr.param_specs, device="cpu")
    steps = int(os.environ["STEPS"])
    trainer.fit(dataset=[(data["x"][mine], data["y"][mine])] * steps,
                epochs=steps, steps_per_epoch=1,
                callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
    res[tag + ".losses"] = np.array([e["loss"] for e in trainer.history])
    full = trainer.state.full_model_state()
    for n, t in full.items():
        res[f"{tag}.fit.{n}"] = t.numpy()
    # The export's gather: a plain LoRAModel holding the whole state.
    plain = model.unsharded().state_dict()
    res[tag + ".unsharded_equal"] = set(plain) == set(full) and all(
        torch.equal(plain[n], t) for n, t in full.items())

np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 64, size=(16, 12)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _tlm(mesh=None, **kw):
    return ttr.TransformerLM(**CFG, **kw, device="cpu",
                             sharding=ttr.ShardingConfig(mesh=mesh))


def _jax_model():
    return jlora.LoRAModel(inner=jtr.TransformerLM(**CFG), rank=RANK,
                           alpha=ALPHA)


def _references(tmp):
    """JAX's LoRAModel: its init (``p0``), the same with seeded noise on
    every leaf (B nonzero: ``bumped``) and that tree's logits and adapter
    gradients; five freeze_base AdamW steps from ``p0`` under JAX's
    Trainer; and the one-rank port's fit from ``p0`` (its tiny-gradient
    elements)."""
    x, y = _data()
    jm = _jax_model()
    trainer = hvt.Trainer(
        jm, hvt.DistributedOptimizer(jlora.freeze_base(optax.adamw(LR))),
        loss="sparse_categorical_crossentropy")
    state = trainer.build(x)
    p0 = jax.device_get(state.params)
    zero = trainer.zero_metrics()
    losses = []
    for _ in range(STEPS):
        state, metrics, _ = trainer._train_step(
            state, trainer._shard((x, y)), np.float32(1.0), zero)
        losses.append(float(metrics["loss"]))
    p1 = jax.device_get(state.params)
    # Every leaf moved by seeded noise: B nonzero, and not constant along
    # a dim (a constant B makes A's gradient a sum that the softmax and
    # the LayerNorms cancel to rounding noise).
    noise = np.random.RandomState(1)
    bumped = jax.tree.map(
        lambda p: p + 0.01 * noise.standard_normal(p.shape).astype(
            np.float32), p0)

    def loss_fn(p):
        lg = jm.apply({"params": p}, jnp.asarray(x))
        logp = jax.nn.log_softmax(lg, -1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[..., None],
                                    -1).mean(), lg

    (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(bumped)
    one = lora.LoRAModel(_tlm(), rank=RANK, alpha=ALPHA)
    sd = {"p0": lora_params_from_flax(p0, one),
          "bumped": lora_params_from_flax(jax.device_get(bumped), one)}
    np.savez(tmp / "data.npz", x=x, y=y, **{
        f"{k}.{n}": t.numpy() for k, d in sd.items() for n, t in d.items()})
    jgrads = {n: t.numpy() for n, t in lora_params_from_flax(
        jax.device_get(grads), one).items() if n.startswith("lora.")}
    # The one-rank port's fit: which adapter elements saw a tiny gradient.
    one.load_state_dict(sd["p0"])
    t1 = ht.Trainer(one, ht.DistributedOptimizer(lora.freeze_base(
        ht.adamw(LR))), loss="sparse_categorical_crossentropy", device="cpu")
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in one.lora.named_parameters()}
    for _ in range(STEPS):
        t1.train_step(x, y)
        for n, p in one.lora.named_parameters():
            g = p.grad.abs()
            tiny[n] |= (g < TINY * g.max()) & (g > 0)
    return dict(x=x, y=y, logits=np.asarray(logits), grads=jgrads,
                losses=losses, p0=sd["p0"],
                p1=lora_params_from_flax(p1, one), tiny=tiny)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), MESHES=json.dumps(MESHES),
               RANK=str(RANK), ALPHA=str(ALPHA), LR=str(LR),
               STEPS=str(STEPS))
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lora_tp")
    refs = _references(tmp)  # the ranks read the weights it writes
    proc = _start(tmp)
    return dict(refs=refs, ranks=_finish(proc, tmp))


def _rel_close(got, want, what, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_and_adapter_gradients_match_jax(run, mesh):
    refs = run["refs"]
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    dp = shape["data"] * shape["fsdp"]
    b = refs["x"].shape[0] // dp
    for r, res in enumerate(run["ranks"]):
        tm = tmesh.build_mesh(tmesh.MeshSpec.from_string(mesh),
                              n_ranks=NPROCS, rank=r)
        rows = slice(tm.data_index * b, (tm.data_index + 1) * b)
        _rel_close(res[mesh + ".logits"], refs["logits"][rows], "logits")
        # Whole on model; JAX's fsdp placement cuts them on fsdp.
        assert res[mesh + ".whole"].all() == ("model" in mesh)
        for n, g in refs["grads"].items():
            _rel_close(res[f"{mesh}.g.{n}"], g, n)


@pytest.mark.parametrize("mesh", MESHES)
def test_freeze_base_steps_match_jax_trainer(run, mesh):
    refs = run["refs"]
    for res in run["ranks"]:
        np.testing.assert_allclose(res[mesh + ".losses"], refs["losses"],
                                   atol=1e-5, rtol=0)
        for n, t in refs["p0"].items():
            got = res[f"{mesh}.fit.{n}"]
            if n.startswith("base."):
                np.testing.assert_array_equal(got, t.numpy(), err_msg=n)
                continue
            inner = n[len("lora."):]
            tol = torch.where(refs["tiny"][inner], 2 * LR * STEPS, 1e-5)
            err = (torch.from_numpy(got) - refs["p1"][n]).abs()
            assert bool((err <= tol).all()), (n, float(err.max()))
            assert not torch.equal(torch.from_numpy(got), t), n  # it moved
        assert bool(res[mesh + ".unsharded_equal"])


def _layout(spec, n=8, rank=0):
    return tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=n,
                            rank=rank)


def test_rank_3_adapters_whole_on_the_model_axis():
    """Rule 1 on a live model: rank 3 does not divide model 2; every
    rank's adapters are the one-rank adapters, whole, while the base
    holds its cut."""
    one = lora.LoRAModel(_tlm(), rank=3)
    for r in range(8):
        mesh = _layout("data=4,model=2", rank=r)
        model = lora.LoRAModel(_tlm(mesh), rank=3)
        specs = ttr.param_specs(model, mesh)
        for n, p in model.named_parameters():
            if n.startswith("lora."):
                assert specs[n] == {}, n
                assert torch.equal(p, one.get_parameter(n)), n
        qkv = model.base.blocks[0].qkv.weight
        assert tuple(qkv.shape) == (48, 32) and specs[
            "base.blocks.0.qkv.weight"] == {0: "model"}


def test_wrapped_lora_model_keeps_the_exemption():
    """Rule 2: a LoRAModel nested under a wrapper, on a live model."""
    mesh = _layout("data=4,model=2")

    class Wrap(nn.Module):
        def __init__(self):
            super().__init__()
            self.peft = lora.LoRAModel(_tlm(mesh), rank=3)

    specs = ttr.param_specs(Wrap(), mesh)
    adapters = [n for n in specs if n.split(".")[-1] in ("a", "b")]
    assert adapters and all(specs[n] == {} for n in adapters)


def test_submodule_named_lora_keeps_tp():
    """Rule 3: a user module merely containing a submodule named 'lora'."""

    class Sub(nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp_up = nn.Parameter(torch.zeros(128, 32))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.lora = Sub()

    assert ttr.param_specs(Net(), _layout("data=4,model=2"))[
        "lora.mlp_up"] == {0: "model"}


def test_expert_adapters_skip_the_expert_rule():
    """Rule 4: adapters of expert weights meet neither the expert nor the
    Megatron rule. On a model mesh the stacks' hidden dim is cut and the
    adapter's delta follows; where ``expert`` shards the stacks the port
    refuses, naming item 17."""
    targets = ("moe_up", "moe_down", "qkv")
    mesh = _layout("data=4,model=2")
    model = lora.LoRAModel(_tlm(mesh, moe_every=2, n_experts=4), rank=2,
                           targets=targets)
    specs = ttr.param_specs(model, mesh)
    adapters = {n: s for n, s in specs.items() if n.startswith("lora.")}
    assert any(".moe_up." in n for n in adapters)
    assert all(s == {} for s in adapters.values()), adapters
    assert model.base_cuts["blocks.1.moe.moe_up"] == {2: "model"}
    em = _layout("data=2,expert=2,model=2")
    jm = jlora.LoRAModel(inner=jtr.TransformerLM(**CFG, moe_every=2,
                                                 n_experts=4), rank=2,
                         targets=targets)
    jparams = jm.init(jax.random.PRNGKey(0), _data()[0])["params"]
    jtr.param_specs(jparams, jmesh.build_mesh(
        jmesh.MeshSpec(data=2, expert=2, model=2)))  # JAX does not raise
    with pytest.raises(NotImplementedError, match="item 17"):
        lora.LoRAModel(_tlm(em, moe_every=2, n_experts=4), rank=2,
                       targets=targets)


def test_adapters_take_jax_fsdp_placement():
    spec = "data=2,fsdp=2,model=2"
    jm = _jax_model()
    jparams = jm.init(jax.random.PRNGKey(0), _data()[0])["params"]
    jspecs = jtr.param_specs(jparams, jmesh.build_mesh(
        jmesh.MeshSpec.from_string(spec)))
    mesh = _layout(spec)
    model = lora.LoRAModel(_tlm(mesh), rank=RANK, alpha=ALPHA)
    specs = ttr.param_specs(model, mesh)
    kernels = lm_kernels(model.base)
    n_cut = 0
    for name, ad in model.adapters().items():
        js = jspecs["lora"]
        for key in kernels[name].path:
            js = js[key]
        for leaf in ("a", "b"):
            want = {d: ax for d, ax in enumerate(tuple(js[leaf]))
                    if ax is not None}
            assert specs[f"lora.{name}.{leaf}"] == want, (name, leaf)
            # The model holds that part of each adapter.
            whole = model.lora.get_submodule(name).full_shapes[leaf]
            for d in want:
                assert ad[leaf].shape[d] * 2 == whole[d], (name, leaf)
                n_cut += 1
    assert n_cut
