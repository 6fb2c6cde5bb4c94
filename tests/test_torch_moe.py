"""The port's `MoEMlp` (`horovod_tpu_torch.models.moe`) against flax's
(`horovod_tpu.models.moe`), unsharded, in f32 on the CPU, from the same
flax-initialised parameters and the same inputs (numpy seeds): k = 1 and
k = 2, expert choice, a binding capacity (drops), grouped dispatch
(more tokens than ``group_size``). JAX's MoE tests are all ``slow``, so
these are the tier-1 guard of the layer.

Tolerances: outputs 1e-5 abs; the gradients of the input and of every
parameter of ``sum(out²) + aux`` 1e-5 relative to the largest element of
each (f32, the same einsums contracted in other orders); the sown aux loss,
``moe_drop_rate`` and ``moe_uncovered_rate`` 1e-6 abs (the rates are
counts over a power-of-two denominator, exact on both sides).
"""

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


def test_grouping_across_data_shards_is_refused():
    """A data shard whose tokens are not a multiple of JAX's global group
    length raises, naming the ROADMAP entry; an aligned one runs."""
    layer = tmoe.MoEMlp(D, n_experts=E)
    layer.data_shards = 2
    with pytest.raises(ValueError, match="item 12.5"):
        layer(torch.zeros(2, 16, D))  # 32 tokens; JAX groups all 64
    layer.check_grouping(1024)  # 2048 global → groups of 1024: aligned
    layer.check_grouping(600)  # 1200 global → groups of 600: aligned
    with pytest.raises(ValueError, match="across data"):
        layer.check_grouping(1536)  # 3072 global → groups of 1024
    layer(torch.zeros(1, 16, D), whole_batch=True)  # a decode batch
