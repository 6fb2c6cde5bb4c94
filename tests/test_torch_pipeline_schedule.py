"""The port's pipeline schedules (`parallel.pipeline`) against the JAX
package's tick model, in process:

* the ticks: JAX's schedules are scans, and every scan in the program of
  `spmd_pipeline`, `spmd_pipeline_1f1b` and `spmd_pipeline_interleaved`
  (forward and backward, on the conftest's virtual devices) has the
  port's `forward_ticks` — ``T + S − 1``, ``v·T + S − 1`` — as its
  length;
* the passes: which microbatches each JAX stage ran on its valid ticks
  (a one-hot of the microbatch id carried through identity stages, summed
  by the schedules' ``with_aux`` channel) equal the port's
  `tick_table` — n_micro passes a stage a round, each microbatch once;
* the one-stage ring (no process group): all three schedules give the
  stage's own forward and gradients, the interleaved wrap handed back to
  itself;
* `interleaved_layer_order` and `stage_slice_size` equal JAX's, errors
  included, and the JAX model's ``ValueError``\\ s word for word on
  layout-only meshes: the schedule's name, an expert axis without MoE,
  layers over stages, heads and 4·d over ``model``, the batch over
  n_micro × dp, and the interleaved chunks and microbatches.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from horovod_tpu import compat
from horovod_tpu.models import pipelined_lm as jpl
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu_torch.models import pipelined_lm as tpl
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpipe

VOCAB = 32
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4)


def _scan_lengths(jaxpr) -> set:
    out = set()
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "scan":
            out.add(int(eqn.params["length"]))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out |= _scan_lengths(sub)
    return out


def _jax_schedule(kind, S, T, v=1):
    """JAX's schedule ``kind`` over S stages of identity stages on T
    microbatches whose activations hold their ids: the lengths of every
    scan of its forward and backward program, and each stage's count of
    valid passes by microbatch."""
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=8 // S, pipe=S),
                            jax.devices("cpu"))
    x = jnp.broadcast_to(jnp.arange(T, dtype=jnp.float32)[:, None, None],
                         (T, 2, 3))
    params = jnp.ones((S * v, 1), jnp.float32)

    def stage(p, a):
        seen = jax.nn.one_hot(a[0, 0].astype(jnp.int32), T)
        return a * p.sum() / p.size, {"seen": seen}

    def run(p, xm):
        if kind == "gpipe":
            out, aux = jpipe.spmd_pipeline(lambda a: stage(p, a), xm,
                                           with_aux=True)
        elif kind == "1f1b":
            out, aux = jpipe.spmd_pipeline_1f1b(stage, p, xm, with_aux=True)
        else:
            out, aux = jpipe.spmd_pipeline_interleaved(
                stage, p, xm, n_virtual=v, with_aux=True)
        return out, aux["seen"][None]

    f = compat.shard_map(run, mesh=mesh, in_specs=(JP("pipe"), JP()),
                         out_specs=(JP(), JP("pipe")), check_vma=False)
    _, seen = jax.jit(f)(params, x)
    grad = jax.grad(lambda p, xm: f(p, xm)[0].sum(), argnums=(0, 1))
    lengths = _scan_lengths(jax.make_jaxpr(f)(params, x).jaxpr)
    lengths |= _scan_lengths(jax.make_jaxpr(grad)(params, x).jaxpr)
    return lengths, np.asarray(seen)


@pytest.mark.parametrize("kind,S,T,v", [
    ("gpipe", 4, 4, 1), ("gpipe", 4, 8, 1), ("gpipe", 2, 4, 1),
    ("1f1b", 4, 4, 1), ("1f1b", 2, 6, 1),
    ("interleaved", 2, 4, 2), ("interleaved", 4, 4, 2),
    ("interleaved", 4, 8, 2)])
def test_ticks_and_passes_equal_jax_tick_model(kind, S, T, v):
    lengths, seen = _jax_schedule(kind, S, T, v)
    assert lengths == {tpipe.forward_ticks(S, T, v)}
    assert tpipe.forward_ticks(S, T, v) == v * T + S - 1
    for s in range(S):
        table = tpipe.tick_table(s, S, T, v)
        assert len(table) == v * T
        counts = collections.Counter(m for _, m, _ in table)
        np.testing.assert_array_equal(seen[s], [counts[m] for m in range(T)])
        # At tick t stage s works on u = t − s = r·T + m.
        assert all(t - s == r * T + m for t, m, r in table)
    if kind == "1f1b":
        for s in range(S):
            drains = tpipe.drain_table(s, S, T)
            assert [m for _, m in drains] == list(range(T))
            assert drains[0][0] == S - 1 - s  # the last stage drains first


def _stage_fn(params, act):
    w, b = params
    for i in range(w.shape[0]):
        act = torch.tanh(act @ w[i] + b[i])
    return act


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_one_stage_ring_is_the_stage(kind):
    """No process group: the ring of one stage hands its own outputs back
    (the interleaved wrap included), so every schedule computes the
    stage's function and its gradients."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 6, 6, generator=gen).mul_(0.4).requires_grad_()
    b = torch.randn(4, 6, generator=gen).mul_(0.1).requires_grad_()
    x = torch.randn(4, 2, 3, 6, generator=gen).requires_grad_()
    want = _stage_fn([w, b], x)
    want_g = torch.autograd.grad(want.square().sum(), [x, w, b])
    if kind == "interleaved":
        got = tpipe.spmd_pipeline_interleaved(
            _stage_fn, [w.view(2, 2, 6, 6), b.view(2, 2, 6)], x,
            n_virtual=2, group=collectives.SELF)
        assert tpipe.stats["forward"] == tpipe.tick_table(0, 1, 4, 2)
    else:
        fn = (tpipe.spmd_pipeline if kind == "gpipe"
              else tpipe.spmd_pipeline_1f1b)
        got = fn(_stage_fn, [w, b], x, group=collectives.SELF)
    assert tpipe.stats["schedule"] == kind
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got_g = torch.autograd.grad(got.square().sum(), [x, w, b])
    for a, e in zip(got_g, want_g):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # the forward alone, without a graph
        torch.testing.assert_close(
            tpipe.spmd_pipeline(_stage_fn, [w, b], x,
                                group=collectives.SELF), want.detach())


@pytest.mark.parametrize("L,S,v", [(8, 2, 2), (8, 4, 2), (12, 2, 3),
                                   (6, 4, 2), (8, 3, 1)])
def test_layer_order_and_stage_slices_equal_jax(L, S, v):
    for ours, theirs, args in (
            (tpipe.interleaved_layer_order, jpipe.interleaved_layer_order,
             (L, S, v)),
            (tpipe.stage_slice_size, jpipe.stage_slice_size, (L, S))):
        try:
            want = theirs(*args)
        except ValueError as e:
            with pytest.raises(ValueError) as port:
                ours(*args)
            assert str(port.value) == str(e)
        else:
            assert ours(*args) == want


def _layout(spec):
    n = tmesh.MeshSpec.from_string(spec).resolve(8)
    return tmesh.build_mesh(tmesh.MeshSpec(**n), n_ranks=8, rank=0)


# (mesh, model knobs, global batch): each raises one JAX ValueError.
ERRORS = {
    "schedule": ("data=2,pipe=4", dict(schedule="pipedream"), 8),
    "expert": ("data=2,pipe=2,expert=2", {}, 8),
    "layers_over_stages": ("data=2,pipe=4", dict(n_layers=6), 8),
    "heads_over_model": ("data=1,pipe=2,model=4", dict(n_heads=6), 4),
    "batch_over_micro": ("data=2,pipe=4", dict(n_micro=3), 8),
    "interleaved_chunks": ("data=4,pipe=2", dict(
        n_layers=6, schedule="interleaved", n_virtual=4), 4),
    "interleaved_micro": ("data=4,pipe=2", dict(
        n_layers=8, schedule="interleaved", n_micro=4), 4),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_jax_value_errors_word_for_word(name):
    spec, kw, batch = ERRORS[name]
    cfg = dict(CFG, **kw)
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    model = jpl.PipelinedLM(**cfg, mesh=jm)
    with pytest.raises(ValueError) as ref:
        params = model.init(jax.random.PRNGKey(0),
                            jnp.zeros((batch, 16), jnp.int32))
        model.apply(params, jnp.zeros((batch, 16), jnp.int32))
    mesh = _layout(spec)
    with pytest.raises(ValueError) as port:
        tm = tpl.PipelinedLM(**cfg, mesh=mesh, device="cpu")
        tm(torch.zeros((batch // mesh.data_shards, 16), dtype=torch.int32))
    assert str(port.value) == str(ref.value)
