"""The port's `models.pipelined_lm.PipelinedLM` on its sequential path (no
mesh), against the JAX package's ``PipelinedLM(mesh=None)`` on the same
numpy weights — 4 layers, d 32, 4 heads, vocab 32, f32 on both sides:

* logits, and the gradients of a mean cross-entropy for every parameter
  (JAX's ``tests/test_pipeline.py`` tolerances: logits rtol = atol = 2e-4,
  gradients rtol 2e-3 / atol 2e-5), and JAX's causality check (a token
  changed at position 12 leaves the logits before it within 1e-4);
* the converter's round trip, exact, and the port's initialization
  against flax's (the same shapes, unit scales, the embedding's and each
  kernel's spread — lecun-normal with the layer dim in the fan-in);
* `to_interleaved_order` / `to_logical_order` on the port's state dicts
  equal to JAX's on the same arrays;
* MoE, the window and packed rows on the sequential path and on a
  ``data=4,pipe=2`` layout (``mlp="moe"`` with 4 experts in groups of one
  row, ``window`` 5, ``segment_ids`` of two documents): logits, the sown
  load-balance loss and every gradient against JAX's sequential model
  (tolerances as above, the loss 1e-5), and each stage's cut of the
  layout run stage after stage in this process (the handoff by hand)
  against JAX's logits;
* a live ``seq`` axis (``data=2,pipe=2,seq=2`` and ``data=4,seq=2``):
  every rank's model holds JAX's device shards under its
  ``pipelined_lm.param_specs`` on the conftest's 8 virtual devices;
* the sequential path's MoE grouping on ``data=4,seq=2`` and ``data=8``
  (one launch of eight gloo ranks): groups across the sequence shards,
  across the data shards and of one row each — logits, the aux loss, the
  drop rate and every gradient against JAX's sequential model on the
  global batch;
* the pipelined step eager on every backend.
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
import torch.nn.functional as F

from jax.sharding import NamedSharding, PartitionSpec as JP

from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import (
    pipelined_params_from_flax, pipelined_params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.models.transformer import packed_positions
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.training import graphs

VOCAB, ROWS, T = 32, 8, 16
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4, n_micro=4)
LOGITS_TOL, GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-3, 2e-5


def _pair(seed=0):
    jm = jpl.PipelinedLM(**CFG, mesh=None)
    toks = jnp.zeros((2, T), jnp.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed), toks)["params"])
    tm = tpl.PipelinedLM(**CFG, device="cpu")
    tm.load_state_dict(pipelined_params_from_flax(params))
    return jm, params, tm


def _tokens(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, VOCAB, (ROWS, T)).astype(np.int32),
            rng.randint(1, VOCAB, (ROWS, T)).astype(np.int32))


def test_forward_matches_jax_sequential():
    jm, params, tm = _pair()
    x, _ = _tokens(1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def test_backward_matches_jax_sequential():
    jm, params, tm = _pair()
    x, y = _tokens(2)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = jax.grad(loss)(params)
    logits = tm(torch.from_numpy(x))
    F.cross_entropy(logits.reshape(-1, VOCAB),
                    torch.from_numpy(y).reshape(-1).long()).backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_causality():
    _, _, tm = _pair()
    x, _ = _tokens(3)
    x2 = x.copy()
    x2[:, 12] = (x2[:, 12] % (VOCAB - 1)) + 1
    with torch.no_grad():
        a, b = tm(torch.from_numpy(x)), tm(torch.from_numpy(x2))
    np.testing.assert_allclose(a[:, :12].numpy(), b[:, :12].numpy(),
                               atol=1e-4)
    assert not np.allclose(a[:, 12:].numpy(), b[:, 12:].numpy(), atol=1e-4)


def test_converter_round_trip_is_exact():
    _, params, tm = _pair(seed=3)
    back = pipelined_params_to_flax(tm.state_dict())
    assert set(back) == set(params)
    for name, a in params.items():
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    again = pipelined_params_from_flax(back)
    for name, t in tm.state_dict().items():
        assert torch.equal(again[name], t), name


def test_initialization_follows_flax():
    """The same shapes; unit scales; the spreads of flax's initializers
    on both sides within 8 % of theirs in law (N(0, 1) embedding,
    lecun-normal kernels of variance 1/fan-in with the layer dim counted
    in the fan-in; the smallest kernel has 1 024 elements)."""
    _, params, _ = _pair(seed=4)
    tm = tpl.PipelinedLM(**dict(CFG, n_layers=8), device="cpu", seed=4)
    jp = jax.device_get(jpl.PipelinedLM(**dict(CFG, n_layers=8)).init(
        jax.random.PRNGKey(4), jnp.zeros((2, T), jnp.int32))["params"])
    for name, t in tm.state_dict().items():
        a = np.asarray(jp[name])
        assert tuple(t.shape) == a.shape, name
        if name.startswith("ln"):
            assert torch.equal(t, torch.ones_like(t)), name
            continue
        law = 1.0 if name == "embed" else 1 / np.sqrt(np.prod(a.shape[:-1]))
        for side, std in (("port", float(t.std())), ("jax", float(a.std()))):
            assert abs(std - law) <= 0.08 * law, (name, side, std, law)


@pytest.mark.parametrize("S,v", [(2, 2), (4, 2)])
def test_layer_orders_equal_jax(S, v):
    tm = tpl.PipelinedLM(**dict(CFG, n_layers=8), device="cpu", seed=6)
    sd = tm.state_dict()
    tree = pipelined_params_to_flax(sd)
    for ours, theirs in ((tpl.to_interleaved_order, jpl.to_interleaved_order),
                         (tpl.to_logical_order, jpl.to_logical_order)):
        got = ours(sd, 8, S, v)
        want = theirs(tree, 8, S, v)
        for name, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                          err_msg=name)
    back = tpl.to_logical_order(tpl.to_interleaved_order(sd, 8, S, v), 8, S,
                                v)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    assert not torch.equal(tpl.to_interleaved_order(sd, 8, S, v)["qkv"],
                           sd["qkv"])


def _layout(spec, n=8):
    return tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=n,
                            rank=0)


# MoE, the window and packed rows, one configuration each: its model fields
# and whether the rows are packed.
CASES = {"moe": (dict(mlp="moe", n_experts=4, moe_group_size=T), False),
               "window": (dict(window=5), False),
               "segment_ids": ({}, True)}
AUX_TOL = 1e-5


def _jax_case(what, seed=7):
    kw, packed = CASES[what]
    jm = jpl.PipelinedLM(**CFG, **kw, mesh=None)
    x, y = _tokens(seed)
    seg = (np.concatenate([np.ones((ROWS, 6)), 2 * np.ones((ROWS, T - 6))],
                          axis=1).astype(np.int32) if packed else None)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x))["params"])

    def loss(p):
        logits, var = jm.apply(
            {"params": p}, jnp.asarray(x), train=True,
            segment_ids=None if seg is None else jnp.asarray(seg),
            mutable=["losses", "metrics"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return ce + sum(jax.tree.leaves(var.get("losses", {}))), (logits,
                                                                  var)

    grads, (logits, var) = jax.grad(loss, has_aux=True)(params)
    return kw, x, y, seg, params, dict(
        logits=np.asarray(logits), grads=grads,
        aux=sum(float(v) for v in jax.tree.leaves(var.get("losses", {}))))


def _sequential_matches(what):
    kw, x, y, seg, params, want = _jax_case(what)
    tm = tpl.PipelinedLM(**CFG, **kw, device="cpu")
    tm.load_state_dict(pipelined_params_from_flax(params))
    logits = tm(torch.from_numpy(x), train=True, segment_ids=None
                if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    loss = F.cross_entropy(logits.reshape(-1, VOCAB),
                           torch.from_numpy(y).reshape(-1).long())
    sown = list(getattr(tm, "sown", {}).get("losses", {}).values())
    if sown:
        np.testing.assert_allclose(float(sown[0].detach()), want["aux"],
                                   rtol=AUX_TOL, atol=AUX_TOL)
    (loss + sum(sown)).backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(want["grads"][name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def _stages_match(what):
    """Each stage's cut on the ``data=4,pipe=2`` layout (the rank at data
    coordinate 0 of each stage), run stage after stage here with the
    handoff by hand, against JAX's sequential logits; each rank's shard
    is its cut of the whole weights."""
    kw, x, _, seg, params, want = _jax_case(what)
    full = pipelined_params_from_flax(params)
    n = tmesh.MeshSpec.from_string("data=4,pipe=2").resolve(8)
    models = []
    for r in range(8):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=8, rank=r)
        m = tpl.PipelinedLM(**CFG, **kw, mesh=lay, device="cpu")
        m.load_state_dict(shard_state_dict(full, lay, m.cuts))
        assert m.qkv.shape[0] == CFG["n_layers"] // 2
        if lay.data_index == 0:
            models.append(m)
    tokens = torch.from_numpy(x)
    extra = None
    if seg is not None:
        ids = torch.from_numpy(seg)
        extra = (ids, packed_positions(ids))
    with torch.no_grad():
        act = F.embedding(tokens.long(), models[0].embed)
        aux = 0.0
        for m in models:
            act = m._stage([getattr(m, k) for k in m.stacks], act, extra)
            if m.mlp == "moe":
                act, a = act
                aux = aux + a["aux"]
        logits = tpl._layernorm(act, models[-1].ln_f) @ models[-1].lm_head
    np.testing.assert_allclose(logits.numpy(), want["logits"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    if kw.get("mlp") == "moe":
        np.testing.assert_allclose(float(aux) * 1e-2, want["aux"],
                                   rtol=AUX_TOL, atol=AUX_TOL)


@pytest.mark.parametrize("mesh", [None, "data=4,pipe=2"])
@pytest.mark.parametrize("what", list(CASES))
def test_moe_window_packed_match_jax_on_every_mesh(what, mesh):
    if mesh is None:
        _sequential_matches(what)
    else:
        _stages_match(what)


@pytest.mark.parametrize("spec", ["data=2,pipe=2,seq=2", "data=4,seq=2"])
def test_a_live_seq_axis_holds_jax_device_shards(spec):
    jm = jpl.PipelinedLM(**CFG)
    params = jax.device_get(jm.init(jax.random.PRNGKey(8),
                                    jnp.zeros((2, T), jnp.int32))["params"])
    n = tmesh.MeshSpec.from_string(spec).resolve(8)
    jmsh = jmesh.build_mesh(jmesh.MeshSpec(**n), jax.devices("cpu")[:8])
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jmsh, s), jpl.param_specs(params, jmsh),
        is_leaf=lambda s: isinstance(s, JP)))
    full = pipelined_params_from_flax(params)
    devices = list(jmsh.devices.reshape(-1))
    for r in range(8):
        lay = _layout(spec) if r == 0 else tmesh.build_mesh(
            tmesh.MeshSpec(**n), n_ranks=8, rank=r)
        model = tpl.PipelinedLM(**CFG, mesh=lay, device="cpu")
        assert model.sp == 2 and model.reduces_over_ranks
        model.load_state_dict(shard_state_dict(full, lay, model.cuts))
        for name, t in model.state_dict().items():
            theirs = np.asarray(next(
                s.data for s in placed[name].addressable_shards
                if s.device == devices[r]))
            np.testing.assert_array_equal(t.numpy(), theirs,
                                          err_msg=f"{spec} {r} {name}")


# The sequential path's MoE grouping across shards: one launch of eight
# gloo ranks runs each (mesh, group length) below on its rank's block of a
# global batch of one row a data shard.
GROUPING = [("data=4,seq=2", T, "across shards"),
            ("data=8", 4 * T, "across data"),
            ("data=8", T, None)]
GROUPING_CHILD = r"""
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
res = {}
for spec, group, _ in json.loads(os.environ["CASES"]):
    key = f"{spec}.{group}"
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec))
    x = np.load(os.path.join(out, "data.npz"))[spec]
    t = x.shape[1] // mesh.seq_shards
    ci, di = mesh.seq_index, mesh.data_index
    x, y = (torch.from_numpy(np.ascontiguousarray(
        a[di:di + 1, ci * t:(ci + 1) * t])) for a in (x, np.roll(x, -1, 1)))
    model = tpl.PipelinedLM(**cfg, mlp="moe", n_experts=4, moe_group_size=group,
                            mesh=mesh, device="cpu", seed=5)
    logits = model(x, train=True)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1), reduction="sum")
    aux = model.sown["losses"]["moe_load_balance"]
    (ce + aux / mesh.data_shards).backward()
    res[key + ".logits"] = logits.detach().numpy()
    res[key + ".aux"] = float(aux.detach())
    res[key + ".drop"] = float(model.sown["metrics"]["moe_drop_rate"])
    grads = {n: c.all_reduce_sum(p.grad, mesh.grad_group)
             for n, p in model.named_parameters()}
    for n, g in gather_state_dict(grads, mesh, model.cuts).items():
        res[f"{key}.g.{n}"] = g.numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
"""


@pytest.fixture(scope="module")
def grouping_world(tmp_path_factory):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("sequential_moe")
    rng = np.random.RandomState(11)
    data = {spec: rng.randint(0, VOCAB, (
        tmesh.MeshSpec.from_string(spec).resolve(8)["data"], 2 * T
        if "seq" in spec else T)).astype(np.int64) for spec, _, _ in GROUPING}
    np.savez(tmp / "data.npz", **data)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "8", "--", sys.executable, "-c", GROUPING_CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo,
               OUT=str(tmp), CFG=json.dumps(CFG), CASES=json.dumps(GROUPING))
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out:\n{out}")
    assert proc.returncode == 0, out
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)]


@pytest.mark.parametrize("spec,group,refused", GROUPING)
def test_sequential_moe_grouping_across_shards(grouping_world, spec, group,
                                               refused):
    """Without a pipe axis the MoE model groups the global batch as JAX's
    sequential model does under GSPMD — groups across the sequence
    shards, across the data shards, and of one row each — where it used
    to refuse the first two: each rank's logits are its block of JAX's,
    the aux loss and drop rate JAX's, and every gradient (summed over the
    gradient group, each rank's objective its tokens' share of the summed
    cross-entropy and the aux loss over the data shards) JAX's."""
    del refused  # the case's name
    data, ranks = grouping_world
    x = data[spec]
    jm = jpl.PipelinedLM(**CFG, mlp="moe", n_experts=4, moe_group_size=group,
                         mesh=None)
    tm = tpl.PipelinedLM(**CFG, mlp="moe", n_experts=4, moe_group_size=group,
                         device="cpu", seed=5)
    params = pipelined_params_to_flax(tm.state_dict())
    y = np.roll(x, -1, axis=1)

    def loss(p):
        logits, var = jm.apply({"params": p}, jnp.asarray(x), train=True,
                               mutable=["losses", "metrics"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).sum()
        return ce + var["losses"]["moe_load_balance"][0], (logits, var)

    grads, (logits, var) = jax.grad(loss, has_aux=True)(params)
    n = tmesh.MeshSpec.from_string(spec).resolve(8)
    key = f"{spec}.{group}"
    for r, res in enumerate(ranks):
        lay = tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=8, rank=r)
        t = x.shape[1] // lay.seq_shards
        block = np.asarray(logits)[lay.data_index:lay.data_index + 1,
                                   lay.seq_index * t:(lay.seq_index + 1) * t]
        np.testing.assert_allclose(res[key + ".logits"], block,
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        np.testing.assert_allclose(
            res[key + ".aux"], float(var["losses"]["moe_load_balance"][0]),
            rtol=AUX_TOL, atol=AUX_TOL)
        np.testing.assert_allclose(
            res[key + ".drop"], float(var["metrics"]["moe_drop_rate"][0]),
            rtol=AUX_TOL, atol=AUX_TOL)
        for name, g in grads.items():
            np.testing.assert_allclose(res[f"{key}.g.{name}"], np.asarray(g),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{key} {name}")


def test_the_pipelined_step_runs_eagerly():
    assert graphs.runs_eagerly(tpl.PipelinedLM(
        **CFG, mesh=_layout("data=4,pipe=2"), device="cpu"))
    assert not graphs.runs_eagerly(tpl.PipelinedLM(
        **CFG, mesh=_layout("data=4,model=2"), device="cpu"))
    assert not graphs.runs_eagerly(tpl.PipelinedLM(**CFG, device="cpu"))
