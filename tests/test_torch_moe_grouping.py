"""MoE dispatch groups across data and sequence shards in the port
(`horovod_tpu_torch.models.moe.grouping_plan` and `route_tokens`), against
the JAX package's layers on the global batch, whose GSPMD groups every
shard's tokens together.

* In process, no launch: for every rank of the JAX meshes ``data=2,seq=2,
  expert=2``, ``data=4,seq=2``, ``data=8`` and ``data=2,fsdp=2`` and at
  shard shapes whose groups are shorter than, as long as and longer than a
  shard's rows, and one whose groups straddle data shards, the plan's
  (group, place) of each local token equals JAX's: the global flat index
  of the token JAX's device holds there, divided and reduced by JAX's
  group length.
* One launched world of four gloo ranks on the CPU, the meshes ``data=1,
  seq=2,expert=2``, ``data=2,seq=2`` and ``data=2,model=2`` in turn, six
  global rows of 16 tokens in groups of 32 (two rows: a group spans the
  sequence shards, and at ``data=2`` the middle group straddles the data
  shards): the `MoEMlp` layer (top-2 at a binding capacity, and expert
  choice) and the sequential MoE `PipelinedLM` — outputs, the sown aux
  loss, ``moe_drop_rate`` / ``moe_uncovered_rate``, and the gradients of
  the input, the router and the experts (summed over the gradient group,
  each rank's objective its tokens' share and the aux loss over the data
  shards, as the optimizer does) against JAX's unsharded layer and model;
  and at ``data=2,model=2`` `Trainer.evaluate` and `predict` of the MoE
  `TransformerLM` over 7 rows of 512 at 3 rows a shard — groups of 1024
  that straddle the shards, the tail batch padded by its last row —
  against JAX's model on the padded global batches, the padding masked or
  dropped.

Tolerances: f32 on both sides, JAX's own for this equality under GSPMD
(tests/test_moe.py:420-425): rtol 2e-4, atol 2e-5.
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

from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    params_to_flax, pipelined_params_to_flax,
)
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
RTOL, ATOL = 2e-4, 2e-5
NPROCS, ROWS, T, D, E, GROUP = 4, 6, 16, 16, 4, 32
LAYER = dict(n_experts=E, k=2, capacity_factor=1.0, group_size=GROUP)
LM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, mlp="moe",
          n_experts=E, moe_group_size=GROUP)
EVAL_LM = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2,
               dropout=0.0, moe_every=2, n_experts=E)
EVAL_ROWS, EVAL_T, EVAL_BATCH = 7, 512, 3
MESHES = ("data=1,seq=2,expert=2", "data=2,seq=2", "data=2,model=2")

# -- the plan, in process -------------------------------------------------------

PLAN_MESHES = ("data=2,seq=2,expert=2", "data=4,seq=2", "data=8",
               "data=2,fsdp=2")
# (rows, tokens a row, group_size): groups shorter than, as long as and
# longer than a shard's rows, and groups straddling data shards.
PLAN_SHAPES = {"s<T": (2, 8, 4), "s=T": (2, 8, 8), "s>T": (2, 8, 24),
               "straddle": (3, 8, 64)}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
@pytest.mark.parametrize("spec", PLAN_MESHES)
def test_plan_is_jax_flat_grouping(spec, shape):
    b, t, group_size = PLAN_SHAPES[shape]
    n_dev = 4 if "fsdp" in spec else 8
    n = tmesh.MeshSpec.from_string(spec).resolve(n_dev)
    jm = jmesh.build_mesh(jmesh.MeshSpec(**n), jax.devices("cpu")[:n_dev])
    dp, sp = n["data"] * n["fsdp"], n["seq"]
    total = dp * b * sp * t
    s = total // jmoe.dispatch_group_count(total, group_size)
    ids = jax.device_put(jnp.arange(total).reshape(dp * b, sp * t),
                         NamedSharding(jm, JP(("data", "fsdp"), "seq")))
    devices = list(jm.devices.reshape(-1))
    for r in range(n_dev):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=n_dev, rank=r)
        plan = tmoe.TokenShards.of(lay).plan(b, t, group_size)
        theirs = np.asarray(next(sh.data for sh in ids.addressable_shards
                                 if sh.device == devices[r]))
        group, place = (a.numpy().reshape(b, t)
                        for a in plan.group_and_place("cpu"))
        assert plan.s == s and plan.n == total // s
        np.testing.assert_array_equal(group, theirs // s, err_msg=str(r))
        np.testing.assert_array_equal(place, theirs % s, err_msg=str(r))
        # The groups this shard meets, in order, and its rows in their
        # [m · s] layout.
        touched = np.unique(theirs // s)
        assert plan.m == len(touched)
        assert plan.aligned == (plan.m * s == b * t)
        slots = plan.slots("cpu").numpy().reshape(b, t)
        np.testing.assert_array_equal(
            slots, np.searchsorted(touched, theirs // s) * s + theirs % s)
        span = plan.span_rows("cpu").numpy().reshape(b, t)
        np.testing.assert_array_equal(span, theirs - touched[0] * s)


# -- the launched world ----------------------------------------------------------

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
layer_kw, lm_kw = json.loads(os.environ["LAYER"]), json.loads(os.environ["LM"])
eval_kw = json.loads(os.environ["EVAL_LM"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def live(mesh, spec):
    return {d: ax for d, ax in spec.items() if mesh.shape[ax] > 1}


for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    dp, di, sp, ci = (mesh.data_shards, mesh.data_index, mesh.seq_shards,
                      mesh.seq_index)
    b, t = data["x"].shape[0] // dp, data["x"].shape[1] // sp
    rows, cols = slice(di * b, (di + 1) * b), slice(ci * t, (ci + 1) * t)
    gg = mesh.grad_group

    def grad_sum(module, specs):
        grads = {n: c.all_reduce_sum(p.grad, gg)
                 for n, p in module.named_parameters()}
        return gather_state_dict(grads, mesh, specs)

    # -- the layer, top-2 and expert choice --------------------------------
    lspecs = {n: live(mesh, {0: "expert", 2: "model"} if n == "moe_up" else
                      {0: "expert", 1: "model"} if n == "moe_down" else {})
              for n in ("router.weight", "moe_up", "moe_down")}
    for router in ("top_k", "expert_choice"):
        key = f"{tag}.{router}"
        layer = tmoe.MoEMlp(data["h"].shape[-1], router=router, seed=5,
                            sharding=ttr.ShardingConfig(mesh=mesh), **layer_kw)
        xin = torch.from_numpy(
            np.ascontiguousarray(data["h"][rows, cols])).requires_grad_()
        y = layer(xin, train=True)
        obj = (y ** 2).sum()
        for v in layer.sown.get("losses", {}).values():
            obj = obj + v / dp
            res[key + ".aux"] = float(v.detach())
        obj.backward()
        res[key + ".out"] = y.detach().numpy()
        res[key + ".gx"] = xin.grad.numpy()
        for n, v in layer.sown["metrics"].items():
            res[f"{key}.{n}"] = float(v)
        for n, g in grad_sum(layer, lspecs).items():
            res[f"{key}.g.{n}"] = g.numpy()

    # -- the sequential MoE PipelinedLM --------------------------------------
    model = tpl.PipelinedLM(**lm_kw, mesh=mesh, device="cpu", seed=3)
    x = torch.from_numpy(np.ascontiguousarray(data["x"][rows, cols]))
    y = torch.from_numpy(np.ascontiguousarray(data["y"][rows, cols]))
    logits = model(x, train=True)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
        reduction="sum") / data["x"].size
    aux = model.sown["losses"]["moe_load_balance"]
    (ce + aux / dp).backward()
    res[tag + ".lm.logits"] = logits.detach().numpy()
    res[tag + ".lm.aux"] = float(aux.detach())
    res[tag + ".lm.drop"] = float(model.sown["metrics"]["moe_drop_rate"])
    res[tag + ".lm.reduces"] = model.reduces_over_ranks
    for n, g in grad_sum(model, model.cuts).items():
        res[f"{tag}.lm.g.{n}"] = g.numpy()

    # -- evaluate over a padded tail batch -----------------------------------
    if mesh.shape["seq"] == 1 and dp > 1:
        lm = ttr.TransformerLM(**eval_kw, device="cpu", seed=4,
                               sharding=ttr.ShardingConfig(mesh=mesh))
        trainer = ht.Trainer(lm, ht.DistributedOptimizer(ht.adam(1e-3)),
                             mesh=mesh, param_specs=ttr.param_specs,
                             device="cpu")
        trainer.build()
        ev = trainer.evaluate(data["ex"], data["ey"],
                              batch_size=int(os.environ["EVAL_BATCH"]))
        res[tag + ".eval"] = np.array([ev["loss"], ev["accuracy"]])
        res[tag + ".predict"] = trainer.predict(
            data["ex"], batch_size=int(os.environ["EVAL_BATCH"]))
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(19)
    x = rng.randint(0, LM["vocab_size"], (ROWS, T)).astype(np.int32)
    ex = rng.randint(0, EVAL_LM["vocab_size"],
                     (EVAL_ROWS, EVAL_T)).astype(np.int32)
    d = dict(x=x, y=np.roll(x, -1, axis=1).astype(np.int32),
             h=rng.randn(ROWS, T, D).astype(np.float32), ex=ex,
             ey=np.roll(ex, -1, axis=1).astype(np.int32))
    np.savez(tmp / "data.npz", **d)
    return d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_grouping")
    data = _data(tmp)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), LAYER=json.dumps(LAYER), LM=json.dumps(LM),
               EVAL_LM=json.dumps(EVAL_LM), EVAL_BATCH=str(EVAL_BATCH),
               MESHES=json.dumps(MESHES))
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
    return dict(data=data, ranks=[dict(np.load(tmp / f"rank{r}.npz"))
                                  for r in range(NPROCS)])


def _blocks(spec):
    """Each rank's (rows, columns) of the global batch on ``spec``."""
    n = tmesh.MeshSpec.from_string(spec).resolve(NPROCS)
    out = []
    for r in range(NPROCS):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=NPROCS, rank=r)
        b, t = ROWS // lay.data_shards, T // lay.seq_shards
        out.append((slice(lay.data_index * b, (lay.data_index + 1) * b),
                    slice(lay.seq_index * t, (lay.seq_index + 1) * t)))
    return out


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("router", ["top_k", "expert_choice"])
@pytest.mark.parametrize("spec", MESHES)
def test_layer_matches_jax_on_the_global_batch(world, spec, router):
    h = world["data"]["h"]
    one = tmoe.MoEMlp(D, router=router, seed=5, **LAYER)
    params = {"router": {"kernel": one.router.weight.detach().numpy().T},
              "moe_up": one.moe_up.detach().numpy(),
              "moe_down": one.moe_down.detach().numpy()}
    jm = jmoe.MoEMlp(D, router=router, **LAYER)

    def loss_fn(p, xx):
        y, var = jm.apply({"params": p}, xx, train=True,
                          mutable=["losses", "metrics"])
        aux = sum(jax.tree.leaves(var.get("losses", {})))
        return (y ** 2).sum() + aux, (y, var)

    (_, (jout, var)), (jg, jgx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    grads = {"router.weight": np.asarray(jg["router"]["kernel"]).T,
             "moe_up": np.asarray(jg["moe_up"]),
             "moe_down": np.asarray(jg["moe_down"])}
    metric = ("moe_uncovered_rate" if router == "expert_choice"
              else "moe_drop_rate")
    key = f"{spec}.{router}"
    for res, (rows, cols) in zip(world["ranks"], _blocks(spec)):
        _close(res[key + ".out"], np.asarray(jout)[rows, cols], "out")
        _close(res[key + ".gx"], np.asarray(jgx)[rows, cols], "gx")
        for n, g in grads.items():
            _close(res[f"{key}.g.{n}"], g, n)
        _close(res[f"{key}.{metric}"], float(var["metrics"][metric][0]),
               metric)
        if router == "top_k":
            _close(res[key + ".aux"],
                   float(var["losses"]["moe_load_balance"][0]), "aux")
            assert 0.0 < float(res[f"{key}.{metric}"]) < 1.0  # it binds


@pytest.mark.parametrize("spec", MESHES)
def test_sequential_pipelined_lm_matches_jax(world, spec):
    x, y = world["data"]["x"], world["data"]["y"]
    tm = tpl.PipelinedLM(**LM, device="cpu", seed=3)
    params = pipelined_params_to_flax(tm.state_dict())
    jm = jpl.PipelinedLM(**{k: v for k, v in LM.items()}, mesh=None)

    def loss_fn(p):
        logits, var = jm.apply({"params": p}, jnp.asarray(x), train=True,
                               mutable=["losses", "metrics"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return ce + var["losses"]["moe_load_balance"][0], (logits, var)

    grads, (logits, var) = jax.grad(loss_fn, has_aux=True)(params)
    for res, (rows, cols) in zip(world["ranks"], _blocks(spec)):
        assert bool(res[spec + ".lm.reduces"])
        _close(res[spec + ".lm.logits"], np.asarray(logits)[rows, cols],
               "logits")
        _close(res[spec + ".lm.aux"],
               float(var["losses"]["moe_load_balance"][0]), "aux")
        _close(res[spec + ".lm.drop"],
               float(var["metrics"]["moe_drop_rate"][0]), "drop")
        for n, g in grads.items():
            _close(res[f"{spec}.lm.g.{n}"], np.asarray(g), n)


def _jax_padded_batches(world):
    """JAX's evaluate and predict batches of the eval rows: global batches
    of EVAL_BATCH × 2 rows, the last padded by repeating its last row,
    through JAX's MoE model from the port's seed-4 weights. Yields (labels,
    logits, real rows)."""
    ex, ey = world["data"]["ex"], world["data"]["ey"]
    tm = ttr.TransformerLM(**EVAL_LM, device="cpu", seed=4)
    params = params_to_flax(tm.state_dict(), n_heads=EVAL_LM["n_heads"])
    jm = jtr.TransformerLM(**EVAL_LM)
    glob = 2 * EVAL_BATCH
    for start in range(0, EVAL_ROWS, glob):
        xb, yb = ex[start:start + glob], ey[start:start + glob]
        real = len(xb)
        xb, yb = (np.concatenate([a, np.repeat(a[-1:], glob - real, 0)])
                  for a in (xb, yb))
        yield yb, np.asarray(jm.apply({"params": params},
                                      jnp.asarray(xb))), real


def test_evaluate_pads_the_tail_batch_as_jax(world):
    """The padding takes slots in the tail batch's groups (on the last
    data shard), and is masked out of the sums."""
    loss_sum = correct = count = 0.0
    for yb, logits, real in _jax_padded_batches(world):
        logp = np.asarray(jax.nn.log_softmax(logits, -1))
        ce = -np.take_along_axis(logp, yb[..., None], -1)[..., 0]
        loss_sum += float(ce[:real].sum())
        correct += float((logits.argmax(-1) == yb)[:real].sum())
        count += real * EVAL_T
    want = [loss_sum / count, correct / count]
    for res in world["ranks"]:
        _close(res["data=2,model=2.eval"], want, "evaluate")


def test_predict_pads_the_tail_batch_as_jax(world):
    """`Trainer.predict` cuts JAX's global batches over the data shards
    and gathers the probabilities: every rank holds all rows', JAX's."""
    want = np.concatenate([np.asarray(jax.nn.softmax(logits, -1))[:real]
                           for _, logits, real in _jax_padded_batches(world)])
    for res in world["ranks"]:
        _close(res["data=2,model=2.predict"], want, "predict")


def test_an_export_groups_the_batch_it_is_given(tmp_path):
    """A model whose MoE layers hold a shard's place (data shard 1 of 2, as
    the Trainer sets it) exports, on one rank and with no collective, the
    function JAX exports: its dispatch groups are the exported batch's."""
    from horovod_tpu_torch import checkpoint

    tm = tpl.PipelinedLM(**LM, device="cpu", seed=3)
    plain = tpl.PipelinedLM(**LM, device="cpu", seed=3)
    tm.token_shards = tmoe.TokenShards(data_shards=2, data_index=1)
    # 48 tokens: as shard 1 of 2 its groups of 32 would straddle shards.
    x = np.random.RandomState(7).randint(0, LM["vocab_size"], (3, T))
    out = checkpoint.export_serving(str(tmp_path), tm, input_shape=x.shape,
                                    input_dtype=np.int64,
                                    timestamp="19700101-000000")
    assert tm.token_shards.data_shards == 2  # held again after the export
    with torch.no_grad():
        want = torch.softmax(plain(torch.from_numpy(x)), -1).numpy()
    got = checkpoint.load_serving(out, device="cpu")(x)
    _close(got, want, "exported probabilities")


def test_no_refusal_is_left():
    """Every ``ValueError`` the port's MoE raises is JAX's own."""
    src = open(tmoe.__file__).read() + open(tpl.__file__).read()
    assert "12.5" not in src and "check_grouping" not in src
    with pytest.raises(ValueError, match="must be divisible by the expert"):
        tmoe.MoEMlp(D, n_experts=3, sharding=ttr.ShardingConfig(
            mesh=tmesh.build_mesh(tmesh.MeshSpec(data=4, expert=2),
                                  n_ranks=8, rank=0)))
    assert torch.equal(*(tmoe.grouping_plan(2, 8, 4).slots("cpu"),
                         torch.arange(16)))
