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
* the pipeline's second half refused on every mesh, the sequential path
  included (``mlp="moe"``, ``window``, ``segment_ids``, a live ``seq``
  axis), naming ROADMAP queue A item 12.4's second half; JAX's config
  checks word for word; the pipelined step eager on every backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.models.convert import (
    pipelined_params_from_flax, pipelined_params_to_flax,
)
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


SECOND_HALF = {
    "moe": lambda m: tpl.PipelinedLM(**CFG, mlp="moe", mesh=m, device="cpu"),
    "window": lambda m: tpl.PipelinedLM(**CFG, window=8, mesh=m,
                                        device="cpu"),
    "segment_ids": lambda m: tpl.PipelinedLM(**CFG, mesh=m, device="cpu")(
        torch.zeros((ROWS, T), dtype=torch.int32),
        segment_ids=torch.zeros((ROWS, T), dtype=torch.int32)),
}


@pytest.mark.parametrize("mesh", [None, "data=4,pipe=2"])
@pytest.mark.parametrize("what", list(SECOND_HALF))
def test_second_half_refused_on_every_mesh(what, mesh):
    m = _layout(mesh) if mesh else None
    with pytest.raises(NotImplementedError,
                       match=r"item 12\.4 \(the pipeline's second half\)"):
        SECOND_HALF[what](m)


@pytest.mark.parametrize("spec", ["data=2,pipe=2,seq=2", "data=4,seq=2"])
def test_a_live_seq_axis_refused_naming_the_second_half(spec):
    with pytest.raises(NotImplementedError,
                       match=r"'seq' axis .*item 12\.4 \(the pipeline's "
                             r"second half\)"):
        tpl.PipelinedLM(**CFG, mesh=_layout(spec), device="cpu")


def test_the_pipelined_step_runs_eagerly():
    assert graphs.runs_eagerly(tpl.PipelinedLM(
        **CFG, mesh=_layout("data=4,pipe=2"), device="cpu"))
    assert not graphs.runs_eagerly(tpl.PipelinedLM(
        **CFG, mesh=_layout("data=4,model=2"), device="cpu"))
    assert not graphs.runs_eagerly(tpl.PipelinedLM(**CFG, device="cpu"))
