"""The port's `MoEMlp` (`horovod_tpu_torch.models.moe`) against flax's
(`horovod_tpu.models.moe`), unsharded, in f32 on the CPU, from the same
flax-initialised parameters and the same inputs (numpy seeds): k = 1 and
k = 2, expert choice, a binding capacity (drops), grouped dispatch
(more tokens than ``group_size``), and at two data shards (a launch of
two gloo ranks) groups that span, match and straddle the shards against
JAX's layer on the global batch. JAX's MoE tests are all ``slow``, so
these are the tier-1 guard of the layer.

Tolerances: outputs 1e-5 abs; the gradients of the input and of every
parameter of ``sum(out²) + aux`` 1e-5 relative to the largest element of
each (f32, the same einsums contracted in other orders); the sown aux loss,
``moe_drop_rate`` and ``moe_uncovered_rate`` 1e-6 abs (the rates are
counts over a power-of-two denominator, exact on both sides).
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

from horovod_tpu.models import moe as jmoe
from horovod_tpu.models.transformer import ShardingConfig as JShard
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models.transformer import ShardingConfig as TShard
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.training import train_state

D, E = 16, 4
OUT_TOL, GRAD_RTOL, METRIC_TOL = 1e-5, 1e-5, 1e-6

CASES = {
    "top2": dict(k=2),
    "top1": dict(k=1),
    "expert_choice": dict(router="expert_choice"),
    "drops": dict(k=2, capacity_factor=0.5),
    "top1_drops": dict(k=1, capacity_factor=0.25),
    "grouped": dict(k=2, group_size=8),
    "grouped_drops": dict(k=2, group_size=8, capacity_factor=0.5),
    "expert_choice_grouped": dict(router="expert_choice", group_size=8,
                                  capacity_factor=0.5),
}


def _pair(b=2, t=16, seed=0, **kw):
    x = np.random.RandomState(seed).randn(b, t, D).astype(np.float32)
    jm = jmoe.MoEMlp(D, n_experts=E, **kw)
    params = jax.device_get(
        jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))
        ["params"])
    tm = tmoe.MoEMlp(D, n_experts=E, **kw)
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(np.asarray(params["router"]["kernel"]).T)))
        tm.moe_up.copy_(torch.from_numpy(np.array(params["moe_up"])))
        tm.moe_down.copy_(torch.from_numpy(np.array(params["moe_down"])))
    return x, jm, params, tm


def _flax_run(jm, params, x):
    def loss_fn(p, xx):
        out, st = jm.apply({"params": p}, xx, train=True,
                           mutable=["losses", "metrics"])
        aux = sum((jnp.sum(v) for v in jax.tree.leaves(st.get("losses", {}))),
                  jnp.zeros((), jnp.float32))
        return (out ** 2).sum() + aux, (out, st)

    (_, (out, st)), (gp, gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    metrics = {k: float(v[0]) for k, v in st["metrics"].items()}
    losses = {k: float(v[0]) for k, v in st.get("losses", {}).items()}
    grads = {"router.weight": np.asarray(gp["router"]["kernel"]).T,
             "moe_up": np.asarray(gp["moe_up"]),
             "moe_down": np.asarray(gp["moe_down"])}
    return np.asarray(out), np.asarray(gx), grads, metrics, losses


def _torch_run(tm, x):
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, train=True)
    losses = {k: float(v.detach())
              for k, v in tm.sown.get("losses", {}).items()}
    aux = sum(tm.sown.get("losses", {}).values())
    ((out ** 2).sum() + aux).backward()
    metrics = {k: float(v) for k, v in tm.sown["metrics"].items()}
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return out.detach().numpy(), xt.grad.numpy(), grads, metrics, losses


def _rel_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= GRAD_RTOL, (what, err)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_flax(case):
    kw = CASES[case]
    x, jm, params, tm = _pair(**kw)
    jo, jgx, jg, jmet, jl = _flax_run(jm, params, x)
    to, tgx, tg, tmet, tl = _torch_run(tm, x)
    np.testing.assert_allclose(to, jo, atol=OUT_TOL, rtol=0)
    _rel_close(tgx, jgx, "input")
    for name in jg:
        _rel_close(tg[name], jg[name], name)
    assert set(tmet) == set(jmet) and set(tl) == set(jl)
    for k in jmet:
        assert tmet[k] == pytest.approx(jmet[k], abs=METRIC_TOL), k
    for k in jl:
        assert tl[k] == pytest.approx(jl[k], abs=METRIC_TOL), k
    if "drops" in case:
        assert tmet["moe_drop_rate"] > 0.1
    if kw.get("router") == "expert_choice":
        assert not tl  # no aux loss: balanced by construction


@pytest.mark.parametrize("case", ["top2", "expert_choice"])
def test_eval_sows_metrics_but_no_loss(case):
    """As flax: the metric in every forward, the loss in training only."""
    x, jm, params, tm = _pair(**CASES[case])
    _, st = jm.apply({"params": params}, jnp.asarray(x),
                     mutable=["losses", "metrics"])
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert not st.get("losses") and not tm.sown.get("losses")
    assert set(tm.sown["metrics"]) == set(st["metrics"])
    assert train_state.sown_losses(tm) == []
    assert set(train_state.sown_metrics(tm)) == set(st["metrics"])


@pytest.mark.parametrize("group_size", [1, 7, 16, 64, 1024])
def test_dispatch_group_count_matches_jax(group_size):
    for g in range(1, 300):
        assert (tmoe.dispatch_group_count(g, group_size)
                == jmoe.dispatch_group_count(g, group_size)), g


def test_capacity_is_jax_python_arithmetic():
    """``max(1, int(k·s/e·cf))`` in Python floats: a binding capacity of
    1 lets exactly one token through (flax's test_capacity_overflow)."""
    d, e, n_tok = 4, 2, 8
    layer = tmoe.MoEMlp(d, n_experts=e, k=1, capacity_factor=1e-9,
                        mlp_ratio=1)
    with torch.no_grad():
        layer.router.weight.zero_()
        layer.router.weight[0] = 50.0  # everyone → expert 0
        layer.moe_up.fill_(1.0)
        layer.moe_down.fill_(1.0)
        out = layer(torch.ones(1, n_tok, d))
    assert int((out.abs().sum(-1) > 1e-6).sum()) == 1
    assert float(layer.sown["metrics"]["moe_drop_rate"]) == 7 / 8


def test_refusals_match_jax():
    """The router name, and experts that the expert axis does not divide
    (JAX raises at init, the port at construction; the same text)."""
    x = jnp.zeros((2, 8, D))
    with pytest.raises(ValueError) as ref:
        jmoe.MoEMlp(D, n_experts=E, router="bogus").init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError) as port:
        tmoe.MoEMlp(D, n_experts=E, router="bogus")
    assert str(port.value) == str(ref.value)
    jm = jmesh.build_mesh(jmesh.MeshSpec(data=2, expert=4),
                          jax.devices("cpu"))
    tm = tmesh.build_mesh(tmesh.MeshSpec(data=2, expert=4), n_ranks=8,
                          rank=0)
    with pytest.raises(ValueError) as ref:
        jmoe.MoEMlp(D, n_experts=6, sharding=JShard(mesh=jm)).init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError) as port:
        tmoe.MoEMlp(D, n_experts=6, sharding=TShard(mesh=tm))
    assert str(port.value) == str(ref.value)


def test_expert_shards_are_slices_of_the_full_draw():
    """On a mesh with expert = 4, rank r's layer holds experts [2r', 2r'+2)
    of the one-rank layer's draw from the same seed (r' its expert
    coordinate), and everything else whole."""
    full = tmoe.MoEMlp(D, n_experts=8, seed=3)
    for r in range(8):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(data=2, expert=4), n_ranks=8,
                                rank=r)
        part = tmoe.MoEMlp(D, n_experts=8, seed=3,
                           sharding=TShard(mesh=mesh))
        e = mesh.coords["expert"]
        assert (part.expert_lo, part.expert_hi) == (2 * e, 2 * e + 2)
        assert part.reduces_over_ranks and part.data_shards == 2
        assert torch.equal(part.moe_up, full.moe_up[2 * e:2 * e + 2])
        assert torch.equal(part.moe_down, full.moe_down[2 * e:2 * e + 2])
        assert torch.equal(part.router.weight, full.router.weight)


# Two data shards (a launch of two gloo ranks, the layer's token shards set
# by hand as the Trainer sets them): the shapes the layer used to refuse or
# accept, by rows and tokens a shard — 32 tokens a shard (JAX groups all
# 64 as one), 1024 and 600 (aligned with JAX's groups) and 1536 (groups of
# 1024, the middle one across the shards).
SHARD_CASES = {"one_group": (2, 16), "aligned_1024": (1, 1024),
               "aligned_600": (2, 300), "straddle_1536": (1, 1536)}
SHARD_CHILD = r"""
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.parallel import collectives as c

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
data = np.load(os.path.join(out, "data.npz"))
res = {}
for name, (b, t) in json.loads(os.environ["CASES"]).items():
    layer = tmoe.MoEMlp(int(os.environ["D"]), n_experts=int(os.environ["E"]),
                        seed=3)
    layer.token_shards = tmoe.TokenShards(data_shards=2, data_index=r)
    x = torch.from_numpy(data[name][r * b:(r + 1) * b]).requires_grad_()
    y = layer(x, train=True)
    aux = layer.sown["losses"]["moe_load_balance"]
    ((y ** 2).sum() + aux / 2).backward()
    res[name + ".out"], res[name + ".gx"] = y.detach().numpy(), x.grad.numpy()
    res[name + ".aux"] = float(aux.detach())
    res[name + ".drop"] = float(layer.sown["metrics"]["moe_drop_rate"])
    for n, p in layer.named_parameters():
        res[f"{name}.g.{n}"] = c.all_reduce_sum(p.grad).numpy()
    with torch.no_grad():  # a decode batch is whole: its groups its own
        res[name + ".decode"] = layer(x[:1], whole_batch=True).numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
"""


@pytest.fixture(scope="module")
def two_shards(tmp_path_factory):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("moe_two_shards")
    rng = np.random.RandomState(12)
    data = {name: rng.randn(2 * b, t, D).astype(np.float32)
            for name, (b, t) in SHARD_CASES.items()}
    np.savez(tmp / "data.npz", **data)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", "2", "--", sys.executable, "-c", SHARD_CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo,
               OUT=str(tmp), CASES=json.dumps(SHARD_CASES), D=str(D),
               E=str(E))
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out:\n{out}")
    assert proc.returncode == 0, out
    return data, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def test_grouping_across_data_shards_is_refused(two_shards):
    """No longer refused: at two data shards the layer groups as JAX's
    layer groups the global batch — one group across both shards, groups
    aligned with the shards, and groups straddling them — so each shard's
    output and input gradient are its rows of JAX's, and the parameters'
    gradients (summed over the shards, each shard's objective its tokens'
    share and the aux loss over the two shards), the aux loss and the
    drop rate are JAX's on every shard. A decode batch (``whole_batch``)
    groups its own tokens, as the one-rank layer does."""
    data, ranks = two_shards
    one = tmoe.MoEMlp(D, n_experts=E, seed=3)
    params = {"router": {"kernel": one.router.weight.detach().numpy().T},
              "moe_up": one.moe_up.detach().numpy(),
              "moe_down": one.moe_down.detach().numpy()}
    jm = jmoe.MoEMlp(D, n_experts=E)
    for name, (b, _) in SHARD_CASES.items():
        jo, jgx, jg, jmet, jl = _flax_run(jm, params, data[name])
        for r, res in enumerate(ranks):
            rows = slice(r * b, (r + 1) * b)
            np.testing.assert_allclose(res[name + ".out"], jo[rows],
                                       atol=OUT_TOL, rtol=0, err_msg=name)
            _rel_close(res[name + ".gx"], jgx[rows], name + " input")
            for n in jg:
                _rel_close(res[f"{name}.g.{n}"], jg[n], f"{name} {n}")
            assert float(res[name + ".aux"]) == pytest.approx(
                jl["moe_load_balance"], abs=METRIC_TOL), name
            assert float(res[name + ".drop"]) == pytest.approx(
                jmet["moe_drop_rate"], abs=METRIC_TOL), name
            with torch.no_grad():
                want = one(torch.from_numpy(data[name][rows][:1]))
            np.testing.assert_allclose(res[name + ".decode"], want.numpy(),
                                       atol=OUT_TOL, rtol=0, err_msg=name)
