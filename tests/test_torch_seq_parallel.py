"""Sequence parallelism in the port's model and Trainer: the `TransformerLM`
on a live ``seq`` axis and ``Trainer(batch_specs=...)``, through the port's
launcher at gloo ranks on the CPU — meshes ``(data=1, seq=2)`` and
``(data=2, seq=2)``, one launch each, every rank running every check on
its shard (rows ``[4i/dp, 4(i+1)/dp)`` of the 4-row global batch, columns
``[16c, 16c + 16)`` of its 32).

* the model with ``attn`` ``ring`` (the flash ring), ``ring_dense`` and
  ``ulysses``, packed ids with a document across the shard boundary
  (ring and Ulysses), and window + sinks (the ring's ``q_offset`` hops and
  sink block): logits, per-token loss and every gradient (the loss joined
  over the ``seq`` group, gradients summed over the gradient group and
  divided by dp, as the optimizer does) against JAX's unsharded model
  and the port at one rank on the global batch;
* ``masked_ce`` (the packed example's per-row loss) as a callable loss:
  the loss and every gradient against JAX and one rank;
* three SGD ``fit`` steps with ``batch_specs`` against the one-rank fit —
  losses and parameters — with every parameter bit-equal on every rank;
  the same fit with ``overlap_reduction`` on (bit-equal: the reduction
  runs after the backward on a seq mesh); ``evaluate`` streamed with the
  batch layout, and with ``cache="device"`` (the streamed path, as JAX);
  ``predict`` whole on every rank; ``generate`` on the seq mesh; distinct
  dropout seeds on every rank;
* the refusals: JAX's three ``ValueError``s word for word, MoE on a seq
  mesh naming ROADMAP 12.5, ``cache="device"`` with ``batch_specs`` as
  JAX, accumulation with ``batch_specs`` as JAX (in-process), and every
  layout that leaves a part of two or more dims whole on dim 1 (JAX's
  default among them) on fit, evaluate and predict, naming 12.4.

Tolerances: f32 on both sides, the same sums in other orders: logits,
losses and gradients within 1e-5 relative to each tensor's largest
element; parameters after three SGD steps within 1e-5 absolute.
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
from jax.sharding import PartitionSpec as JP

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.examples.lm_packed_pretraining import (
    PackedLM, masked_ce,
)
from horovod_tpu_torch.models import decoding
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
RTOL, PARAM_ATOL = 1e-5, 1e-5
ROWS, T, VOCAB, STEPS, LR, NEW = 4, 32, 64, 3, 0.5, 6
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
# name: (model knobs, attn, packed)
VARIANTS = {
    "ring": ({}, "ring", False),
    "ring_dense": ({}, "ring_dense", False),
    "ulysses": ({}, "ulysses", False),
    "ring_packed": ({}, "ring", True),
    "ulysses_packed": ({}, "ulysses", True),
    "ring_window_sinks": (dict(window=12, attention_sinks=4), "ring", False),
    "ring_window_sinks_packed": (dict(window=12, attention_sinks=4), "ring",
                                 True),
}

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.examples.lm_packed_pretraining import PackedLM, masked_ce
from horovod_tpu_torch.models import decoding
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
variants = json.loads(os.environ["VARIANTS"])
lr, new = float(os.environ["LR"]), int(os.environ["NEW"])
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["MESH"]))
data = np.load(os.path.join(out, "data.npz"))
dp, di, n, ci = (mesh.data_shards, mesh.data_index, mesh.seq_shards,
                 mesh.seq_index)
b, t = data["x"].shape[1] // dp, data["x"].shape[2] // n
rows, cols = slice(di * b, (di + 1) * b), slice(ci * t, (ci + 1) * t)
spec = tmesh.P(("data", "fsdp"), "seq", None)
sg, gg = mesh.group("seq"), mesh.grad_group
res = {"coords": np.array([mesh.coords[a] for a in tmesh.AXES])}


def local(a):
    return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))


def sgd():
    return ht.DistributedOptimizer(functools.partial(torch.optim.SGD, lr=lr))


x0, y0, seg = data["x"][0], data["y"][0], data["seg"]
# -- the model: logits, per-token loss, gradients ------------------------------
for name, (kw, attn, packed) in variants.items():
    model = ttr.TransformerLM(**cfg, **kw, device="cpu", seed=1,
                              sharding=ttr.ShardingConfig(mesh=mesh, attn=attn))
    ids = local(seg) if packed else None
    with torch.no_grad():
        res[name + ".logits"] = model(local(x0), segment_ids=ids).numpy()
    loss, _ = model(local(x0), labels=local(y0), segment_ids=ids, train=True,
                    dropout_seed=0)
    res[name + ".loss"] = loss.detach().numpy()
    c.all_gather_tiled(loss, sg, 1).mean().backward()
    for pn, p in model.named_parameters():
        res[f"{name}.g.{pn}"] = (c.all_reduce_sum(p.grad, gg) / dp).numpy()

# -- masked_ce as a callable loss ----------------------------------------------
xs, ys = data["xs"], data["ys"]
pm = PackedLM(ttr.TransformerLM(**cfg, device="cpu", seed=1,
                                sharding=ttr.ShardingConfig(mesh=mesh)))
tr = ht.Trainer(pm, sgd(), loss=masked_ce, mesh=mesh, device="cpu",
                batch_specs=(spec, spec))
tr.build()
lv, _ = tr._loss_and_correct(torch.from_numpy(tr.cut(xs[rows], 0)),
                             torch.from_numpy(tr.cut(ys[rows], 1)),
                             train=True, seed=0)
lv.mean().backward()
tr.tx.reduce_gradients()
res["mce.loss"] = lv.detach().numpy()
for pn, p in pm.named_parameters():
    res["mce.g." + pn] = p.grad.numpy()

# -- three SGD steps, with the overlap off and on -------------------------------
batches = [(xb[rows], yb[rows]) for xb, yb in zip(data["x"], data["y"])]
for tag, overlap in (("fit", False), ("fit_overlap", True)):
    model = ttr.TransformerLM(**cfg, device="cpu", seed=2,
                              sharding=ttr.ShardingConfig(mesh=mesh))
    trainer = ht.Trainer(model, sgd(), loss="module", mesh=mesh, device="cpu",
                         batch_specs=(spec, spec), overlap_reduction=overlap)
    trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
                callbacks=[callbacks.MetricAverageCallback()], verbose=0)
    res[tag + ".losses"] = np.array([e["loss"] for e in trainer.history])
    res[tag + ".eager"] = trainer._runner.eager_steps
    for pn, p in model.named_parameters():
        res[f"{tag}.{pn}"] = p.detach().numpy()
res["seed"] = trainer._dropout_seed(0, step=0)
ex, ey = data["ex"], data["ey"]
ev = trainer.evaluate(ex, ey, batch_size=2)
res["eval"] = np.array([ev["loss"], ev["accuracy"]])
res["predict"] = trainer.predict(ex[:5], batch_size=2)
# cache="device" with batch_specs on a seq mesh takes the streamed path,
# as in JAX.
ev = trainer.evaluate(ex, ey, batch_size=2, cache="device")
res["eval_cached"] = np.array([ev["loss"], ev["accuracy"]])
res["generate"] = decoding.generate(
    model, torch.from_numpy(data["prompt"]), new).numpy()

# -- refusals --------------------------------------------------------------------


def refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return ""


def forward(attn, packed=False, **kw):
    m = ttr.TransformerLM(**cfg, **kw, device="cpu",
                          sharding=ttr.ShardingConfig(mesh=mesh, attn=attn))
    return lambda: m(local(x0), segment_ids=local(seg) if packed else None)


res["refuse.dense"] = refusal(forward("dense"))
res["refuse.ring_dense_segments"] = refusal(forward("ring_dense", True))
res["refuse.ring_dense_sinks"] = refusal(
    forward("ring_dense", window=12, attention_sinks=4))
res["refuse.moe"] = refusal(forward("ring", moe_every=2, n_experts=4))
res["refuse.cache"] = refusal(lambda: trainer.fit(
    x=data["x"][0], y=data["y"][0], batch_size=b, cache="device", verbose=0))
res["refuse.layout_default"] = refusal(lambda: ht.Trainer(
    model, sgd(), loss="module", mesh=mesh, device="cpu"))


def whole(x_spec, y_spec, verb):
    tr = ht.Trainer(model, sgd(), loss="module", mesh=mesh, device="cpu",
                    batch_specs=(x_spec, y_spec))
    tr.build()
    return {"fit": lambda: tr.fit(dataset=batches[:1], steps_per_epoch=1,
                                  verbose=0),
            "evaluate": lambda: tr.evaluate(ex, ey, batch_size=2),
            "predict": lambda: tr.predict(ex[:2])}[verb]


# x (or y) laid out whole on dim 1: the token input of the seq-parallel
# model must be cut, so these refuse rather than train on a wrong batch.
for key, xs_, ys_ in (("x_none", tmesh.P(("data", "fsdp"), None), spec),
                      ("x_short", tmesh.P(("data", "fsdp")), spec),
                      ("y_short", spec, tmesh.P(("data", "fsdp")))):
    for verb in ("fit", "evaluate", "predict"):
        if verb == "predict" and key == "y_short":
            continue
        res[f"refuse.{key}.{verb}"] = refusal(whole(xs_, ys_, verb))
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(0)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = np.roll(x, -1, axis=2).astype(np.int32)
    # Three documents a row, the middle one across the shard boundary at 16.
    seg = np.zeros((ROWS, T), np.int32)
    for i in range(ROWS):
        seg[i, 3 + i:] = 1
        seg[i, 24 + i:] = 2
    w = (rng.rand(ROWS, T) > 0.3).astype(np.int32)
    xs = np.stack([x[0], seg], axis=-1)
    ys = np.stack([y[0], w], axis=-1)
    ex = rng.randint(1, VOCAB, (7, T)).astype(np.int32)
    ey = np.roll(ex, -1, axis=1).astype(np.int32)
    prompt = rng.randint(1, VOCAB, (2, 8)).astype(np.int32)
    d = dict(x=x, y=y, seg=seg, xs=xs, ys=ys, ex=ex, ey=ey, prompt=prompt)
    np.savez(tmp / "data.npz", **d)
    return d


def _start(tmp, nprocs, mesh):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), MESH=mesh, CFG=json.dumps(CFG),
               VARIANTS=json.dumps(VARIANTS), LR=str(LR), NEW=str(NEW))
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, tmp, nprocs):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nprocs)]


def _jax_model(kw, params):
    jm = jtr.TransformerLM(**CFG, **kw)
    return jm, params_to_flax(params, n_heads=CFG["n_heads"])


def _jax_refs(d):
    """JAX's unsharded model on the global batch, from the port's seed-1
    weights: logits, per-token loss and gradients of every variant, and
    masked_ce's loss and gradients."""
    refs = {}
    x, y, seg = (jnp.asarray(d[k][0] if k != "seg" else d[k])
                 for k in ("x", "y", "seg"))
    for name, (kw, _, packed) in VARIANTS.items():
        tm = ttr.TransformerLM(**CFG, **kw, device="cpu", seed=1)
        jm, params = _jax_model(kw, tm.state_dict())
        skw = {"segment_ids": seg} if packed else {}

        def loss_fn(p):
            loss, _ = jm.apply({"params": p}, x, labels=y, **skw)
            return loss.mean(), loss

        (_, loss), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        refs[name] = dict(
            logits=np.asarray(jm.apply({"params": params}, x, **skw)),
            loss=np.asarray(loss), grads=params_from_flax(
                jax.device_get(grads)))
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=1)
    jm, params = _jax_model({}, tm.state_dict())
    xs, ys = jnp.asarray(d["xs"]), jnp.asarray(d["ys"])

    def jax_masked_ce(p):
        logits = jm.apply({"params": p}, xs[..., 0], segment_ids=xs[..., 1])
        targets, weights = ys[..., 0], ys[..., 1].astype(jnp.float32)
        per = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), targets)
        row = (per * weights).sum(-1) / jnp.maximum(weights.sum(-1), 1.0)
        return row.mean(), row

    (_, row), grads = jax.value_and_grad(jax_masked_ce, has_aux=True)(params)
    refs["mce"] = dict(loss=np.asarray(row),
                       grads=params_from_flax(jax.device_get(grads)))
    return refs


def _one_rank(d):
    """The port at one rank on the global batch: each variant's logits,
    loss and gradients; masked_ce; the fit, evaluate, predict and
    generate."""
    one = {}
    x, y, seg = (torch.from_numpy(d[k][0] if k != "seg" else d[k])
                 for k in ("x", "y", "seg"))
    for name, (kw, _, packed) in VARIANTS.items():
        tm = ttr.TransformerLM(**CFG, **kw, device="cpu", seed=1)
        ids = seg if packed else None
        with torch.no_grad():
            logits = tm(x, segment_ids=ids).numpy()
        loss, _ = tm(x, labels=y, segment_ids=ids, train=True, dropout_seed=0)
        loss.mean().backward()
        one[name] = dict(logits=logits, loss=loss.detach().numpy(),
                         grads={n: p.grad for n, p in tm.named_parameters()})
    pm = PackedLM(ttr.TransformerLM(**CFG, device="cpu", seed=1))
    row = masked_ce(pm(torch.from_numpy(d["xs"])), torch.from_numpy(d["ys"]))
    row.mean().backward()
    one["mce"] = dict(loss=row.detach().numpy(),
                      grads={n: p.grad for n, p in pm.named_parameters()})
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=LR)), loss="module", device="cpu")
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    ev = trainer.evaluate(d["ex"], d["ey"], batch_size=2)
    one["fit"] = dict(losses=[e["loss"] for e in trainer.history],
                      params={n: p.detach().numpy()
                              for n, p in tm.named_parameters()},
                      eval=[ev["loss"], ev["accuracy"]],
                      predict=trainer.predict(d["ex"][:5], batch_size=2),
                      generate=decoding.generate(
                          tm, torch.from_numpy(d["prompt"]), NEW).numpy())
    return one


WORLDS = {"data1_seq2": (2, "data=1,seq=2"), "data2_seq2": (4, "data=2,seq=2")}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_refs")
    d = _data(tmp)
    return dict(data=d, jax=_jax_refs(d), one=_one_rank(d))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    done: dict = {}

    def get(name):
        if name not in done:
            nprocs, mesh = WORLDS[name]
            tmp = tmp_path_factory.mktemp(name)
            _data(tmp)
            ranks = _finish(_start(tmp, nprocs, mesh), tmp, nprocs)
            shape = tmesh.MeshSpec.from_string(mesh).resolve(nprocs)
            done[name] = dict(ranks=ranks, shape=shape)
        return done[name]

    return get


@pytest.fixture(params=list(WORLDS))
def world(request, worlds):
    return worlds(request.param)


def _rel_close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= RTOL, (what, err)


def _shard(a, res, shape):
    """``res``'s rank's block of a global [rows, T, ...] array."""
    dp, n = shape["data"], shape["seq"]
    b, t = a.shape[0] // dp, a.shape[1] // n
    di, ci = int(res["coords"][0]), int(res["coords"][3])
    return a[di * b:(di + 1) * b, ci * t:(ci + 1) * t]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_model_matches_jax_and_one_rank(world, refs, name):
    jref, one = refs["jax"][name], refs["one"][name]
    for res in world["ranks"]:
        for key in ("logits", "loss"):
            _rel_close(res[f"{name}.{key}"],
                       _shard(jref[key], res, world["shape"]),
                       f"{name} {key} vs jax")
            _rel_close(res[f"{name}.{key}"],
                       _shard(one[key], res, world["shape"]),
                       f"{name} {key} vs one rank")
        for pn, g in one["grads"].items():
            _rel_close(res[f"{name}.g.{pn}"], jref["grads"][pn].numpy(),
                       f"{name} {pn} vs jax")
            _rel_close(res[f"{name}.g.{pn}"], g.numpy(), f"{name} {pn}")


def test_masked_ce_callable_loss(world, refs):
    jref, one = refs["jax"]["mce"], refs["one"]["mce"]
    dp = world["shape"]["data"]
    for res in world["ranks"]:
        di = int(res["coords"][0])
        rows = slice(di * ROWS // dp, (di + 1) * ROWS // dp)
        _rel_close(res["mce.loss"], jref["loss"][rows], "masked_ce vs jax")
        _rel_close(res["mce.loss"], one["loss"][rows], "masked_ce")
        for pn, g in one["grads"].items():
            _rel_close(res["mce.g." + pn],
                       jref["grads"][pn.removeprefix("inner.")].numpy(),
                       pn + " vs jax")
            _rel_close(res["mce.g." + pn], g.numpy(), pn)


def test_fit_equals_one_rank_fit(world, refs):
    want = refs["one"]["fit"]
    ranks = world["ranks"]
    for res in ranks:
        _rel_close(res["fit.losses"], want["losses"], "losses")
        assert int(res["fit.eager"]) == STEPS  # gloo: eager steps
        for pn, p in want["params"].items():
            np.testing.assert_allclose(res["fit." + pn], p, atol=PARAM_ATOL,
                                       rtol=0, err_msg=pn)
    # Every parameter bit-equal on every rank, and the overlap changes
    # nothing.
    for pn in want["params"]:
        for res in ranks:
            assert np.array_equal(res["fit." + pn], ranks[0]["fit." + pn]), pn
            assert np.array_equal(res["fit_overlap." + pn],
                                  res["fit." + pn]), pn


def test_evaluate_predict_generate_and_seeds(world, refs):
    want = refs["one"]["fit"]
    ranks = world["ranks"]
    for res in ranks:
        _rel_close(res["eval"], want["eval"], "evaluate")
        _rel_close(res["eval_cached"], want["eval"], "cached evaluate")
        _rel_close(res["predict"], want["predict"], "predict")
        assert res["predict"].shape == want["predict"].shape
        assert np.array_equal(res["generate"], want["generate"])
    seeds = [int(res["seed"]) for res in ranks]
    assert len(set(seeds)) == len(seeds)


def _jax_refusal(attn, packed=False, **kw):
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=4, seq=2))
    model = jtr.TransformerLM(**CFG, **kw, sharding=jtr.ShardingConfig(
        mesh=mesh, attn=attn))
    skw = {"segment_ids": jnp.ones((4, T), jnp.int32)} if packed else {}
    with pytest.raises(ValueError) as e:
        model.init(jax.random.PRNGKey(0), jnp.zeros((4, T), jnp.int32), **skw)
    return str(e.value)


def test_refusals_match_jax(world):
    sinks = dict(window=12, attention_sinks=4)
    want = {"dense": _jax_refusal("dense"),
            "ring_dense_segments": _jax_refusal("ring_dense", True),
            "ring_dense_sinks": _jax_refusal("ring_dense", **sinks)}
    for res in world["ranks"]:
        for key, msg in want.items():
            assert str(res["refuse." + key]) == msg, key
        assert "item 12.5" in str(res["refuse.moe"])
        assert str(res["refuse.cache"]) == (
            "cache='device' supports data-sharded batches only; use the "
            "streamed fit path with batch_specs meshes")


LAYOUT_REFUSALS = ["layout_default"] + [
    f"{key}.{verb}" for key in ("x_none", "x_short", "y_short")
    for verb in ("fit", "evaluate", "predict")
    if not (key == "y_short" and verb == "predict")]


@pytest.mark.parametrize("key", LAYOUT_REFUSALS)
def test_layouts_whole_on_seq_refused_naming_roadmap(world, key):
    """A part left whole on dim 1 of a live seq axis, JAX's default layout
    included, raises naming item 12.4 on every verb, never trains on a
    wrongly laid-out batch."""
    for res in world["ranks"]:
        msg = str(res["refuse." + key])
        assert "item 12.4" in msg and "'seq'" in msg, msg


def test_accumulation_with_batch_specs_refused_as_jax():
    jspec = JP(("data", "fsdp"), "seq", None)
    with pytest.raises(ValueError) as ref:
        hvt.Trainer(jtr.TransformerLM(**CFG), hvt.DistributedOptimizer(
            optax.sgd(0.1), backward_passes_per_step=2),
            batch_specs=(jspec, jspec))
    tspec = tmesh.P(("data", "fsdp"), "seq", None)
    with pytest.raises(ValueError) as port:
        ht.Trainer(ttr.TransformerLM(**CFG, device="cpu"),
                   ht.DistributedOptimizer(ht.adam(1e-3),
                                           backward_passes_per_step=2),
                   batch_specs=(tspec, tspec), device="cpu")
    assert str(port.value) == str(ref.value)


def test_other_batch_layouts_raise_naming_roadmap():
    bad = tmesh.P("data", None, "seq")
    with pytest.raises(NotImplementedError, match="item 12.4"):
        ht.Trainer(ttr.TransformerLM(**CFG, device="cpu"), ht.adam(1e-3),
                   batch_specs=(bad, bad), device="cpu")
