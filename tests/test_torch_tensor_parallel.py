"""Tensor parallelism in the port's model: the `TransformerLM` on a live
``model`` axis (Megatron's column/row cut, f and g around it), through the
port's launcher at four gloo ranks on the CPU — meshes ``(data=2,
model=2)`` and ``(data=1, seq=2, model=2)`` in one launch, every rank
running every check on its shard (rows ``[2i, 2i + 2)`` of the 4-row
global batch on the first, columns ``[16c, 16c + 16)`` of its 32 on the
second).

* the fused ``qkv`` and ``kv_proj`` rows cut per part by heads: every
  rank's shard of every parameter (`convert.shard_state_dict` of the
  converted JAX tree) equals the conversion of JAX's own device shard
  under its ``param_specs`` ``NamedSharding`` on the conftest's 8 virtual
  devices, at ``data=4,model=2`` and, on the ``model`` axis alone, at
  ``data=2,fsdp=2,model=2`` (the ``fsdp`` dim follows each layout's own
  order, `tests/test_torch_mesh.py`) — MHA and GQA;
* logits, the fused-CE loss and every gathered gradient (the loss joined
  over ``seq``, gradients summed over the gradient group and divided by
  dp, as the optimizer does), and the gradients of a cross-entropy on the
  gathered logits, against JAX's sharded apply on the same mesh and the
  port at one rank — MHA and GQA;
* three SGD ``fit`` steps at ``data=2,model=2`` with ``batch_specs=None``
  (JAX's default layout) against the one-rank fit, every rank's
  parameters bit-equal within its ``model`` part;
* one dropout seed and mask a ``model`` group (the training loss with
  dropout 0.1 equals the one rank's), other seeds across ``data``;
* `collectives.gather_weight`'s two backwards: ``"reduce_scatter"`` sums
  the members' gradients, ``"slice"`` keeps this member's own;
* the decode cache at ``[B, L, H_kv/tp, D]``;
* JAX's two ``ValueError``s word for word; MoE, int8 weights and caches,
  LoRA and seq2seq on a live ``model`` axis (and MoE, ``int8_compute``,
  LoRA and seq2seq on a live ``fsdp`` axis), once refused naming ROADMAP
  item 18, computing the one-rank model's function (their full parity
  with JAX is tests/test_torch_{moe,int8,seq2seq,lora}_tp.py's); a live
  ``pipe`` axis carried (the model replicated over it), and a pipelined
  model on pp × sp built with its stage's rows;
* the serving and generation exports of a model held in its
  ``fsdp=2,model=2`` cut, gathered inside by every rank, equal to the
  one-rank model (JAX's ``TestExportFromShardedState``).

Tolerances: f32 on both sides. Against JAX's sharded apply rtol = atol =
5e-4, JAX's ``test_matches_unsharded_forward``; against the port at one
rank (the same sums, other orders and two partial products summed by g)
1e-5 relative to each tensor's largest element; parameters after three
SGD steps within 1e-5 absolute. The shards are equal exactly.
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

from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import lora, quant, seq2seq as tseq
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    params_from_flax, params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding as shard_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
JAX_TOL, RTOL, PARAM_ATOL = 5e-4, 1e-5, 1e-5
ROWS, T, VOCAB, STEPS, LR = 4, 32, 64, 3, 0.5
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
KINDS = {"mha": {}, "gqa": {"n_kv_heads": 2}}
MESHES = ["data=2,model=2", "data=1,seq=2,model=2"]

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
kinds = json.loads(os.environ["KINDS"])
lr = float(os.environ["LR"])
data = np.load(os.path.join(out, "data.npz"))
res = {}
for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    dp, di, n, ci = (mesh.data_shards, mesh.data_index, mesh.seq_shards,
                     mesh.seq_index)
    b, t = data["x"].shape[1] // dp, data["x"].shape[2] // n
    rows, cols = slice(di * b, (di + 1) * b), slice(ci * t, (ci + 1) * t)
    sg, gg = mesh.group("seq"), mesh.grad_group
    res[tag + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])

    def local(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))

    x0, y0 = local(data["x"][0]), local(data["y"][0])
    for kind, kw in kinds.items():
        key = f"{tag}.{kind}"
        model = ttr.TransformerLM(**cfg, **kw, device="cpu", seed=1,
                                  sharding=ttr.ShardingConfig(mesh=mesh))
        specs = ttr.live_placements(ttr.param_specs(model, mesh), mesh)
        with torch.no_grad():
            res[key + ".logits"] = model(x0).numpy()
        loss, _ = model(x0, labels=y0, train=True, dropout_seed=0)
        res[key + ".loss"] = loss.detach().numpy()
        c.all_gather_tiled(loss, sg, 1).mean().backward()
        grads = {pn: c.all_reduce_sum(p.grad, gg) / dp
                 for pn, p in model.named_parameters()}
        for pn, g in gather_state_dict(grads, mesh, specs).items():
            res[f"{key}.g.{pn}"] = g.numpy()
        model.zero_grad()
        logits = model(x0)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             y0.reshape(-1).long(),
                             reduction="none").view(y0.shape)
        c.all_gather_tiled(ce, sg, 1).mean().backward()
        grads = {pn: c.all_reduce_sum(p.grad, gg) / dp
                 for pn, p in model.named_parameters()}
        for pn, g in gather_state_dict(grads, mesh, specs).items():
            res[f"{key}.ce.g.{pn}"] = g.numpy()
        cache = model.new_cache(2, 8)
        res[key + ".cache_shape"] = np.array(cache["Block_0"]["k"].shape)

# Three SGD steps at data=2,model=2 with JAX's default layout.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,model=2"))
b = data["x"].shape[1] // mesh.data_shards
rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
model = ttr.TransformerLM(**cfg, device="cpu", seed=2,
                          sharding=ttr.ShardingConfig(mesh=mesh))
trainer = ht.Trainer(model, ht.DistributedOptimizer(
    functools.partial(torch.optim.SGD, lr=lr)), loss="module", mesh=mesh,
    param_specs=ttr.param_specs, device="cpu")
batches = [(xb[rows], yb[rows]) for xb, yb in zip(data["x"], data["y"])]
trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
            callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
res["fit.losses"] = np.array([e["loss"] for e in trainer.history])
res["fit.seed"] = trainer._dropout_seed(0, step=0)
res["fit.eager"] = trainer._runner.eager_steps
for pn, p in model.named_parameters():
    res["fit.local." + pn] = p.detach().numpy()
for pn, p in trainer.state.full_model_state().items():
    res["fit." + pn] = p.numpy()

# Dropout on the Megatron-replicated activations: one mask a model group
# (the trainer's seeds are equal there), so the loss is the one rank's.
model = ttr.TransformerLM(**dict(cfg, dropout=0.1), device="cpu", seed=1,
                          sharding=ttr.ShardingConfig(mesh=mesh))
loss, _ = model(torch.from_numpy(data["x"][0][rows]),
                labels=torch.from_numpy(data["y"][0][rows]), train=True,
                dropout_seed=5)
res["dropout.loss"] = loss.detach().numpy()

# gather_weight's two backwards over the model group: the members hold
# rows [2m, 2m + 2) of a [4, 3] weight; each weighs the whole by its own
# coefficients, so the reduce-scatter sums the members' coefficients over
# this member's rows and the slice keeps its own.
g = mesh.group("model")
m = mesh.coords["model"]
for how in ("reduce_scatter", "slice"):
    w = torch.full((2, 3), 1.0, requires_grad=True)
    coef = torch.arange(12, dtype=torch.float32).view(4, 3) * (1 + m)
    (c.gather_weight(w, 0, g, how) * coef).sum().backward()
    res["gather." + how] = w.grad.numpy()

# The exports of a model held in its fsdp=2,model=2 cut: every rank calls
# them (the gather is a collective) and rank 0 writes.
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.serving import export_generate
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("fsdp=2,model=2"))
model = ttr.TransformerLM(**cfg, device="cpu", seed=7,
                          sharding=ttr.ShardingConfig(mesh=mesh))
res["export.serving"] = checkpoint.export_serving(
    os.path.join(out, "export"), model, input_shape=(2, 8),
    input_dtype=np.int32, timestamp="19700101-000000")
res["export.generate"] = export_generate(
    os.path.join(out, "generate"), model, batch_size=2, prompt_len=8,
    max_new_tokens=4, timestamp="19700101-000000")
# Item 18's modules on a live model or fsdp axis, each as its one-rank
# self (`ITEM_18_CASES`): prefill logits for the MoE LM (decode treats
# its tokens as the whole batch), int8 logits, int8-cache tokens, this
# rank's quantized tree, LoRA and seq2seq logits.
from horovod_tpu_torch.models import lora, quant, seq2seq as tseq
from horovod_tpu_torch.models.decoding import make_generate_fn
from horovod_tpu_torch.parallel import sharding as shard_lib
meshes = {t: tmesh.build_mesh(tmesh.MeshSpec.from_string(t))
          for t in ("data=2,model=2", "data=2,fsdp=2")}
x0 = torch.from_numpy(data["x"][0])
s2s = dict(vocab_size=cfg["vocab_size"], d_model=32, n_heads=4,
           n_enc_layers=1, n_dec_layers=1, dropout=0.0)


def lm(tag, **kw):
    return ttr.TransformerLM(**cfg, **kw, device="cpu", seed=4,
                             sharding=ttr.ShardingConfig(mesh=meshes[tag]))


with torch.no_grad():
    for case, tag in (("moe_model", "data=2,model=2"),
                      ("moe_fsdp", "data=2,fsdp=2")):
        res["i18." + case] = lm(tag, moe_every=2, n_experts=4).decode(
            x0, max_decode_len=x0.shape[1])[0].numpy()
    for case, tag in (("int8_compute_model", "data=2,model=2"),
                      ("int8_compute_fsdp", "data=2,fsdp=2")):
        res["i18." + case] = lm(tag, int8_compute=True)(x0).numpy()
    res["i18.clone_int8_model"] = lm("data=2,model=2").clone(
        int8_compute=True)(x0).numpy()
    res["i18.quantized_cache_model"] = make_generate_fn(
        lm("data=2,model=2"), max_new_tokens=4, quantized_cache=True)(
        x0[:, :8]).numpy()
    m = lm("data=2,model=2")
    mesh2 = meshes["data=2,model=2"]
    specs = ttr.live_placements(ttr.param_specs(m, mesh2), mesh2)
    for n, leaf in quant.quantize_params(m, min_size=16).items():
        if quant.is_qleaf(leaf):
            res["i18.quantize_params_model." + n] = leaf["int8_q"].numpy()
    for case, tag in (("lora_model", "data=2,model=2"),
                      ("lora_fsdp", "data=2,fsdp=2")):
        model = lora.LoRAModel(lm(tag), rank=2)
        for ab in model.adapters().values():
            ab["b"].fill_(0.05)  # a delta in the forward
        res["i18." + case] = model(x0).numpy()
    for case, tag in (("seq2seq_model", "data=2,model=2"),
                      ("seq2seq_fsdp", "data=2,fsdp=2")):
        model = tseq.Seq2SeqTransformer(
            **s2s, device="cpu", seed=4,
            sharding=ttr.ShardingConfig(mesh=meshes[tag]))
        res["i18." + case] = model({"src": x0, "tgt": x0}).numpy()

np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(0)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = np.roll(x, -1, axis=2).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y)
    return dict(x=x, y=y)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), KINDS=json.dumps(KINDS),
               MESHES=json.dumps(MESHES), LR=str(LR))
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


def _jax_sharded(d, mesh_spec):
    """JAX's model on ``mesh_spec`` (the conftest's virtual devices) from
    the port's seed-1 weights: logits, per-token loss and gradients of the
    global batch, by kind."""
    nd = tmesh.MeshSpec.from_string(mesh_spec).resolve(NPROCS)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(**nd), jax.devices()[:NPROCS])
    x, y = jnp.asarray(d["x"][0]), jnp.asarray(d["y"][0])
    refs = {}
    for kind, kw in KINDS.items():
        jm = jtr.TransformerLM(**CFG, **kw, sharding=jtr.ShardingConfig(
            mesh=mesh, attn="ring"))
        params = params_to_flax(
            ttr.TransformerLM(**CFG, **kw, device="cpu", seed=1).state_dict(),
            n_heads=CFG["n_heads"])

        def loss_fn(p):
            loss, _ = jm.apply({"params": p}, x, labels=y)
            return loss.mean(), loss

        logits = jax.jit(lambda p: jm.apply({"params": p}, x))(params)
        (_, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)
        refs[kind] = dict(logits=np.asarray(logits), loss=np.asarray(loss),
                          grads=params_from_flax(jax.device_get(grads)))
    return refs


def _one_rank(d):
    one = {}
    x, y = torch.from_numpy(d["x"][0]), torch.from_numpy(d["y"][0])
    for kind, kw in KINDS.items():
        tm = ttr.TransformerLM(**CFG, **kw, device="cpu", seed=1)
        with torch.no_grad():
            logits = tm(x).numpy()
        loss, _ = tm(x, labels=y, train=True, dropout_seed=0)
        loss.mean().backward()
        one[kind] = dict(logits=logits, loss=loss.detach().numpy(),
                         grads={n: p.grad.numpy()
                                for n, p in tm.named_parameters()})
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=2)
    trainer = _sgd_trainer(tm)
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    one["fit"] = dict(losses=[e["loss"] for e in trainer.history],
                      params={n: p.detach().numpy()
                              for n, p in tm.named_parameters()})
    return one


def _sgd_trainer(tm):
    import horovod_tpu_torch as ht

    return ht.Trainer(tm, ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=LR)), loss="module", device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    d = _data(tmp)
    proc = _start(tmp)  # the ranks run while the references compute
    try:
        jax_refs = {m: _jax_sharded(d, m) for m in MESHES}
        one = _one_rank(d)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return dict(data=d, jax=jax_refs, one=one, ranks=_finish(proc, tmp),
                tmp=tmp)


def _rel_close(got, want, what, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


def _shard(a, coords, shape):
    """The block of a global [rows, T, ...] array at ``coords``."""
    dp, n = shape["data"] * shape["fsdp"], shape["seq"]
    b, t = a.shape[0] // dp, a.shape[1] // n
    di = int(coords[0]) * shape["fsdp"] + int(coords[1])
    ci = int(coords[3])
    return a[di * b:(di + 1) * b, ci * t:(ci + 1) * t]


# -- the cut, against JAX's NamedSharding ----------------------------------------


def _jax_params(kw):
    jm = jtr.TransformerLM(**CFG, **kw)
    return jax.device_get(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.mark.parametrize("spec", ["data=4,model=2", "data=2,fsdp=2,model=2"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_qkv_and_kv_proj_cut_by_heads_as_jax_shards(spec, kind):
    """Each rank's part of each parameter is the conversion of JAX's shard
    on the device at its coordinates (the ``model`` placements; on the
    fsdp mesh JAX's ``fsdp`` dims are left whole on both sides)."""
    params = _jax_params(KINDS[kind])
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    jspecs = jax.tree.map(
        lambda s: JP(*[None if a == "fsdp" else a for a in tuple(s)]),
        jtr.param_specs(params, jm), is_leaf=lambda s: isinstance(s, JP))
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jm, s), jspecs,
        is_leaf=lambda s: isinstance(s, JP)))
    full = params_from_flax(params)
    devices = list(jm.devices.reshape(-1))
    for r in range(8):
        tm = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                              rank=r)
        specs = {n: {d: ax for d, ax in p.items() if ax == "model"}
                 for n, p in ttr.param_specs(full, tm).items()}
        mine = shard_state_dict(full, tm, specs)
        theirs = params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed))
        assert set(mine) == set(theirs)
        for name, t in mine.items():
            assert torch.equal(t, theirs[name]), (spec, r, name)


def test_the_model_holds_its_cut_of_the_one_rank_weights():
    mesh = tmesh.build_mesh(tmesh.MeshSpec(data=1, model=2), n_ranks=2,
                            rank=1)
    tm = ttr.TransformerLM(**CFG, n_kv_heads=2, device="cpu", seed=3,
                           sharding=ttr.ShardingConfig(mesh=mesh))
    one = ttr.TransformerLM(**CFG, n_kv_heads=2, device="cpu", seed=3)
    want = shard_state_dict(one.state_dict(), mesh, tm.cuts)
    for name, t in tm.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert tuple(tm.blocks[0].kv_proj.weight.shape) == (2 * 1 * 8, 32)
    assert tuple(tm.lm_head.weight.shape) == (VOCAB // 2, 32)


# -- the launched ranks ------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_jax_sharded_and_one_rank(run, mesh, kind):
    jref, one = run["jax"][mesh][kind], run["one"][kind]
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    key = f"{mesh}.{kind}"
    for res in run["ranks"]:
        coords = res[mesh + ".coords"]
        for what in ("logits", "loss"):
            got = res[f"{key}.{what}"]
            np.testing.assert_allclose(got, _shard(jref[what], coords, shape),
                                       rtol=JAX_TOL, atol=JAX_TOL)
            _rel_close(got, _shard(one[what], coords, shape),
                       f"{key} {what} vs one rank")
        for pn, g in one["grads"].items():
            for path in ("g", "ce.g"):
                got = res[f"{key}.{path}.{pn}"]
                _rel_close(got, jref["grads"][pn].numpy(),
                           f"{key} {path} {pn} vs jax", JAX_TOL)
                _rel_close(got, g, f"{key} {path} {pn} vs one rank")
        h_kv = CFG["n_heads"] // (2 if kind == "gqa" else 1)
        assert tuple(res[key + ".cache_shape"]) == (2, 8, h_kv // 2, 8)


def test_fit_with_the_default_layout_equals_one_rank(run):
    want = run["one"]["fit"]
    ranks = run["ranks"]
    for res in ranks:
        _rel_close(res["fit.losses"], want["losses"], "losses")
        assert int(res["fit.eager"]) == STEPS  # gloo: eager steps
        for pn, p in want["params"].items():
            np.testing.assert_allclose(res["fit." + pn], p, atol=PARAM_ATOL,
                                       rtol=0, err_msg=pn)
    # The two data ranks of one model coordinate hold the same part.
    for a, b in ((0, 2), (1, 3)):
        for pn in want["params"]:
            assert np.array_equal(ranks[a]["fit.local." + pn],
                                  ranks[b]["fit.local." + pn]), pn


def test_dropout_seeds_and_masks_shared_by_a_model_group(run):
    ranks = run["ranks"]
    seeds = [int(res["fit.seed"]) for res in ranks]
    data = [int(res["data=2,model=2.coords"][0]) for res in ranks]
    for a in range(NPROCS):
        for b in range(NPROCS):
            assert (seeds[a] == seeds[b]) == (data[a] == data[b]), seeds
    # The mask hashes (seed, site, element index): one rank on the same
    # rows with the same seed draws the same masks.
    tm = ttr.TransformerLM(**dict(CFG, dropout=0.1), device="cpu", seed=1)
    for res in ranks:
        d = int(res["data=2,model=2.coords"][0])
        x, y = (torch.from_numpy(run["data"][k][0][2 * d:2 * d + 2])
                for k in ("x", "y"))
        with torch.no_grad():
            want, _ = tm(x, labels=y, train=True, dropout_seed=5)
            plain, _ = tm(x, labels=y)
        _rel_close(res["dropout.loss"], want.numpy(), "dropout loss")
        assert not np.allclose(want.numpy(), plain.numpy())


def test_gather_weight_backwards(run):
    coef = np.arange(12, dtype=np.float32).reshape(4, 3)
    for res in run["ranks"]:
        m = int(res["data=2,model=2.coords"][4])
        rows = slice(2 * m, 2 * m + 2)
        np.testing.assert_array_equal(res["gather.reduce_scatter"],
                                      coef[rows] * (1 + 2))
        np.testing.assert_array_equal(res["gather.slice"],
                                      coef[rows] * (1 + m))


# -- refusals -----------------------------------------------------------------------


def _layout(spec, n):
    return tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=n,
                            rank=0)


@pytest.mark.parametrize("kw,spec", [
    (dict(n_heads=4), "model=8"),
    (dict(n_heads=8, n_kv_heads=2), "model=4,data=2"),
], ids=["heads", "kv_heads"])
def test_head_divisibility_errors_match_jax(kw, spec):
    cfg = dict(CFG, **kw)
    with pytest.raises(ValueError) as port:
        ttr.TransformerLM(**cfg, device="cpu", sharding=ttr.ShardingConfig(
            mesh=_layout(spec, 8)))
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    model = jtr.TransformerLM(**cfg, sharding=jtr.ShardingConfig(mesh=jm))
    with pytest.raises(ValueError) as ref:
        model.init(jax.random.PRNGKey(0), jnp.zeros((8, 16), jnp.int32))
    assert str(port.value) == str(ref.value)


def _lm(spec, **kw):
    return ttr.TransformerLM(**CFG, **kw, device="cpu",
                             sharding=ttr.ShardingConfig(mesh=_layout(spec, 2)))


def _one_rank_case(name, x):
    """Case ``name`` of the launched ranks' item-18 section at one rank."""
    from horovod_tpu_torch.models.decoding import make_generate_fn

    def lm(**kw):
        return ttr.TransformerLM(**CFG, **kw, device="cpu", seed=4)

    x = torch.from_numpy(x)
    s2s = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_enc_layers=1,
               n_dec_layers=1, dropout=0.0)
    with torch.no_grad():
        if name.startswith("moe_"):
            return lm(moe_every=2, n_experts=4).decode(
                x, max_decode_len=T)[0].numpy()
        if name.startswith("int8_compute_"):
            return lm(int8_compute=True)(x).numpy()
        if name == "clone_int8_model":
            return lm().clone(int8_compute=True)(x).numpy()
        if name == "quantized_cache_model":
            return make_generate_fn(lm(), max_new_tokens=4,
                                    quantized_cache=True)(x[:, :8]).numpy()
        if name == "quantize_params_model":
            return quant.quantize_params(lm(), min_size=16)
        if name.startswith("lora_"):
            model = lora.LoRAModel(lm(), rank=2)
            for ab in model.adapters().values():
                ab["b"].fill_(0.05)
            return model(x).numpy()
        return tseq.Seq2SeqTransformer(**s2s, device="cpu", seed=4)(
            {"src": x, "tgt": x}).numpy()


ITEM_18_CASES = ("moe_model", "moe_fsdp", "int8_compute_model",
                 "int8_compute_fsdp", "quantized_cache_model",
                 "clone_int8_model", "quantize_params_model", "lora_model",
                 "lora_fsdp", "seq2seq_model", "seq2seq_fsdp")


@pytest.mark.parametrize("name", ITEM_18_CASES)
def test_item_18_runs_as_one_rank(run, name):
    """What the port once refused naming ROADMAP item 18 runs on a live
    ``model`` or ``fsdp`` axis, each rank computing the one-rank model's
    function: logits within 1e-5 relative (int8 within
    tests/test_torch_quant.py's 1e-5 abs), tokens and int8 values
    exactly — each rank's quantized values its part of the one-rank
    tree's."""
    want = _one_rank_case(name, run["data"]["x"][0])
    for r, res in enumerate(run["ranks"]):
        if name == "quantize_params_model":
            mesh = tmesh.build_mesh(tmesh.MeshSpec(data=2, model=2),
                                    n_ranks=NPROCS, rank=r)
            one = ttr.TransformerLM(**CFG, device="cpu", seed=4)
            specs = ttr.live_placements(ttr.param_specs(one, mesh), mesh)
            n_q = 0
            for n, leaf in want.items():
                if quant.is_qleaf(leaf):
                    part = shard_lib.shard_tensor(leaf["int8_q"], n,
                                                  specs.get(n, {}), mesh)
                    np.testing.assert_array_equal(
                        res[f"i18.{name}.{n}"], part.numpy(), err_msg=n)
                    n_q += 1
            assert n_q >= 5 * CFG["n_layers"]
        elif name == "quantized_cache_model":
            np.testing.assert_array_equal(res["i18." + name], want)
        elif "int8" in name:
            np.testing.assert_allclose(res["i18." + name], want, rtol=0,
                                       atol=1e-5)
        else:
            _rel_close(res["i18." + name], want, name)


def test_pipe_axis_refused_naming_12_4():
    """A live ``pipe`` axis is carried: the `TransformerLM` is replicated
    over it (no cut, the one-rank weights, as GSPMD runs JAX's), and a
    placement on it is live (the pipelined model's stacks). pp × sp is
    carried now: a `PipelinedLM` on it builds, holding its stage's rows of
    every stack and a live ``seq`` axis (its compute is
    `tests/test_torch_pipeline_seq.py`'s)."""
    tm = _lm("pipe=2")
    assert tm.cuts == {}
    one = ttr.TransformerLM(**CFG, device="cpu")
    for name, t in tm.state_dict().items():
        assert torch.equal(t, one.state_dict()[name]), name
    assert ttr.live_placements({"w": {0: "pipe"}}, _layout("pipe=2", 2)) == {
        "w": {0: "pipe"}}
    pm = tpl.PipelinedLM(vocab_size=VOCAB, d_model=32, n_heads=4,
                         mesh=_layout("data=1,pipe=2,seq=2", 4), device="cpu")
    assert pm.sp == 2 and pm.pipe == 2 and pm.reduces_over_ranks
    assert pm.cuts["qkv"] == {0: "pipe"} and tuple(pm.qkv.shape) == (
        2, 32, 96)


def test_sharded_exports_refused(run, tmp_path):
    """JAX's ``TestExportFromShardedState``: the exports of a model held in
    its ``fsdp=2,model=2`` cut gather it whole inside (every launched rank
    called them and got the bundle's directory; rank 0 wrote one bundle
    each). The serving bundle's probabilities equal the one-rank model's,
    the generation bundle holds its weights exactly. A module that holds
    shards with no ``unsharded()`` to gather them is still refused."""
    from horovod_tpu_torch import checkpoint
    from horovod_tpu_torch.models.moe import MoEMlp
    from horovod_tpu_torch.serving import bundle

    stamp = "19700101-000000"
    for res in run["ranks"]:
        assert str(res["export.serving"]).endswith(stamp)
        assert str(res["export.generate"]).endswith(stamp)
    assert os.listdir(run["tmp"] / "export") == [stamp]
    plain = ttr.TransformerLM(**CFG, device="cpu", seed=7)
    fn = checkpoint.load_serving(str(run["tmp"] / "export" / stamp),
                                 device="cpu")
    x = np.arange(16, dtype=np.int32).reshape(2, 8) % VOCAB
    with torch.no_grad():
        want = torch.softmax(plain(torch.from_numpy(x)).float(), -1).numpy()
    np.testing.assert_allclose(fn(x), want, atol=1e-6, rtol=0)
    gen = run["tmp"] / "generate" / stamp
    weights = torch.load(gen / bundle.GEN_WEIGHTS_FILE, weights_only=True)
    for name, t in plain.state_dict().items():
        assert torch.equal(weights[name], t), name
    assert bundle.load_generate(str(gen), device="cpu") is not None
    moe = MoEMlp(32, n_experts=4, sharding=ttr.ShardingConfig(
        mesh=_layout("expert=2", 2)))
    with pytest.raises(ValueError, match=r"no unsharded\(\)"):
        checkpoint.export_serving(str(tmp_path), moe, input_shape=(2, 8))
    assert not list(tmp_path.iterdir())
