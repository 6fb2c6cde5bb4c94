"""ZeRO-1 and the quantized wires in the port's `Trainer`, at two gloo ranks
(one launch; each rank saves what it got and the tests read those files),
plus the refusals and a one-step comparison with the JAX package's int8
step in this process.

Tolerances:
* ZeRO-1 against the replicated update: bit for bit — parameters, the
  optimizer state gathered back to whole tensors, and the residual rows —
  for the none, bf16 and int8 wires, K ∈ {1, 4}, the overlap on and off
  (the port's int8 ZeRO-1 step runs the replicated step's dense-bucket
  reduction and cuts locally, so the two agree by construction);
* ``bucket_order="forward"`` against ``"reverse"``: bit for bit on exact
  wires (buckets never mix values);
* the int8 losses against the f32 control's: within 2e-3 absolute at every
  epoch (the bound the smoke's phase 15b holds its int8/fp8 runs to);
* the port's replicated quantized reduction against JAX's over three
  steps from a nonzero residual, several buckets (two ranks, int8 and fp8;
  and the int8 SGD step in a world of one): the delivered gradients, the
  parameters and the residual to four f32 ulps of the inputs' largest
  magnitude, except at most `EF_MAX_FLIPS` elements in all, each within
  one step of the wire's grid (a rounding that an ulp flipped; see
  `test_torch_reduction_layout.assert_equal_but_flips`).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as ht
from horovod_tpu.parallel import collectives as jcoll
from horovod_tpu_torch.parallel import collectives as tcoll

from test_torch_collectives import run_ranks
from test_torch_reduction_layout import assert_equal_but_flips

LOSS_ATOL = 2e-3
#: The quantized reduction's comparison with JAX over three steps: its
#: bucket size (several buckets a step) and the elements of all the steps'
#: delivered gradients and residuals (several hundred) that may differ by
#: one rounding flip.
EF_BUCKET_BYTES = 96
EF_MAX_FLIPS = 4
EF_SHAPES = {"b": (10,), "k": (12, 10), "m": (7, 3), "s": ()}

CHILD = r'''
import os, pickle
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks, checkpoint

ht.init(device="cpu")
r, n = ht.rank(), ht.size()
OUT = os.environ["OUT"]


class MLP(torch.nn.Module):
    """Leaves of both families at two ranks: [6, 8] and [5, 6] weights
    shard, the 5-wide bias and the 3-wide projection stay whole."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Linear(8, 6)
        self.b = torch.nn.Linear(6, 5)
        self.c = torch.nn.Parameter(torch.randn(3, generator=g))
        with torch.no_grad():
            for p in (self.a.weight, self.a.bias, self.b.weight, self.b.bias):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)

    def forward(self, x, train=False, dropout_seed=None):
        h = torch.tanh(self.a(x))
        return self.b(h) + self.c.sum() * 0.1


rng = np.random.RandomState(0)
X = rng.randn(256, 8).astype(np.float32)
Y = rng.randint(0, 5, size=256).astype(np.int64)


def run(wire="none", k=1, shard=False, overlap=False, order=None,
        epochs=2, cbs=()):
    tx = ht.DistributedOptimizer(ht.adamw(3e-2), compression=wire,
                                 backward_passes_per_step=k)
    tr = ht.Trainer(MLP(), tx, device="cpu", bucket_bytes=64,
                    shard_update=shard, overlap_reduction=overlap,
                    bucket_order=order)
    hist = tr.fit(x=X, y=Y, batch_size=4, epochs=epochs, steps_per_epoch=3,
                  verbose=0, callbacks=list(cbs))
    return tr, hist


res = {}
for wire in ("none", "bf16", "int8"):
    for k in (1, 4):
        base, hist = run(wire, k)
        res[f"losses_{wire}_{k}"] = [e["loss"] for e in hist]
        res[f"digest_{wire}_{k}_rep"] = checkpoint.state_digest(base.state)
        res[f"params_{wire}_{k}_rep"] = [p.detach().numpy().copy()
                                         for p in base.module.parameters()]
        for ov in (False, True):
            tr, _ = run(wire, k, shard=True, overlap=ov)
            res[f"digest_{wire}_{k}_z{int(ov)}"] = checkpoint.state_digest(
                tr.state)
            if ov and k == 1:
                res[f"bytes_{wire}"] = (base.tx.state_bytes(),
                                        tr.tx.state_bytes())
        if wire != "int8":
            tr, _ = run(wire, k, order="forward")
            res[f"digest_{wire}_{k}_fwd"] = checkpoint.state_digest(tr.state)
        tr, _ = run(wire, k, overlap=True)
        res[f"digest_{wire}_{k}_rep_ov"] = checkpoint.state_digest(tr.state)

# Checkpoints through the twin's rank-0-only ModelCheckpoint (the fit's
# epoch-end snapshot keeps it free of collectives) and a resume on both
# ranks, for a replicated int8 run and a ZeRO-1 one.
for name, shard in (("int8", False), ("z1", True)):
    d = os.path.join(OUT, f"ckpt_{name}")
    cbs = ([callbacks.ModelCheckpoint(os.path.join(d, "checkpoint-{epoch}.pt"))]
           if r == 0 else [])
    tr, _ = run("int8", 1, shard=shard, cbs=cbs)
    want = checkpoint.state_digest(tr.state)
    sd = tr.tx.state_dict()
    res[f"ef_rows_{name}"] = [t.shape[0] for t in sd["ef_residual"]]
    res[f"ef_nonzero_{name}"] = float(sum(t.abs().sum() for t in sd["ef_residual"]))
    tx = ht.DistributedOptimizer(ht.adamw(3e-2), compression="int8")
    fresh = ht.Trainer(MLP(), tx, device="cpu", bucket_bytes=64,
                       shard_update=shard)
    fresh.build()
    state, epoch = checkpoint.restore_latest_and_broadcast(d, fresh.state)
    res[f"resume_{name}"] = (epoch, checkpoint.state_digest(state) == want)
    res[f"residual_{name}"] = [t.numpy().copy() for t in tx.residual]
    res[f"residual_{name}_want"] = [t.numpy().copy() for t in tr.tx.residual]
    # Training on from the resumed state, the root's replicated state
    # broadcast over each rank's own shards and residual.
    fresh.fit(x=X, y=Y, batch_size=4, epochs=3, initial_epoch=epoch,
              steps_per_epoch=3, verbose=0,
              callbacks=[callbacks.BroadcastGlobalVariablesCallback(0)])
    tr.fit(x=X, y=Y, batch_size=4, epochs=3, initial_epoch=2,
           steps_per_epoch=3, verbose=0)
    res[f"continued_{name}"] = (checkpoint.state_digest(fresh.state)
                                == checkpoint.state_digest(tr.state))

# The replicated quantized reduction the trainer runs, three steps from a
# nonzero residual over several buckets: each step's gradients, what it
# delivers into .grad and the residual it keeps.
EF_SHAPES = {"b": (10,), "k": (12, 10), "m": (7, 3), "s": ()}
for wire in ("int8", "fp8"):
    g = torch.Generator().manual_seed(50 + r)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in EF_SHAPES.values()]
    opt = ht.DistributedOptimizer(torch.optim.SGD(params, lr=1.0),
                                  compression=wire)
    opt.bucket_bytes = 96
    res0 = [torch.randn(s, generator=g) * 0.02 for s in EF_SHAPES.values()]
    for dst, v in zip(opt.residual, res0):
        dst.copy_(v)
    steps = []
    for t in range(3):
        grads = [torch.randn(s, generator=g) * (1 + t)
                 for s in EF_SHAPES.values()]
        for p, v in zip(params, grads):
            p.grad = v.clone()
        opt.reduce_gradients()
        steps.append(([v.numpy() for v in grads],
                      [p.grad.numpy().copy() for p in params],
                      [v.numpy().copy() for v in opt.residual]))
    res[f"ef_{wire}"] = ([v.numpy() for v in res0], steps)

with open(os.path.join(OUT, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
ht.shutdown()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    run_ranks(CHILD, 2, tmp)
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_zero1_equals_replicated_bit_for_bit(ranks, wire, k, overlap):
    for r in range(2):
        res = ranks[r]
        assert res[f"digest_{wire}_{k}_z{int(overlap)}"] == \
            res[f"digest_{wire}_{k}_rep"]
    assert ranks[0][f"digest_{wire}_{k}_rep"] == \
        ranks[1][f"digest_{wire}_{k}_rep"]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_overlapped_replicated_equals_serialized(ranks, wire, k):
    """The overlap issues each bucket from the backward's hooks (an exact
    dense bucket asynchronously): the same arithmetic, bit for bit."""
    for r in range(2):
        assert ranks[r][f"digest_{wire}_{k}_rep_ov"] == \
            ranks[r][f"digest_{wire}_{k}_rep"]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("wire", ["none", "bf16"])
def test_forward_bucket_order_equals_reverse_on_exact_wires(ranks, wire, k):
    for r in range(2):
        assert ranks[r][f"digest_{wire}_{k}_fwd"] == \
            ranks[r][f"digest_{wire}_{k}_rep"]


@pytest.mark.parametrize("k", [1, 4])
def test_int8_losses_track_the_f32_control(ranks, k):
    f32 = np.asarray(ranks[0][f"losses_none_{k}"])
    int8 = np.asarray(ranks[0][f"losses_int8_{k}"])
    assert np.all(np.isfinite(int8))
    np.testing.assert_allclose(int8, f32, rtol=0, atol=LOSS_ATOL)
    assert not np.array_equal(int8, f32)  # the wire did quantize


def test_per_rank_optimizer_memory_falls(ranks):
    for wire in ("none", "bf16", "int8"):
        rep, z1 = ranks[0][f"bytes_{wire}"]
        # Adam's two moments: the sharded family (all but 3 + 5 + 1 of 92
        # elements) halves at two ranks.
        assert z1 <= 0.6 * rep, (wire, rep, z1)


@pytest.mark.parametrize("name", ["int8", "z1"])
def test_residual_survives_a_checkpoint_round_trip(ranks, name):
    for r in range(2):
        res = ranks[r]
        assert res[f"ef_rows_{name}"] == [2] * 5  # a row per rank
        assert res[f"ef_nonzero_{name}"] > 0
        epoch, same = res[f"resume_{name}"]
        assert epoch == 2 and same
        assert res[f"continued_{name}"]
        for got, want in zip(res[f"residual_{name}"],
                             res[f"residual_{name}_want"]):
            np.testing.assert_array_equal(got, want)
    # Each rank resumed its own row.
    assert not all(np.array_equal(a, b) for a, b in zip(
        ranks[0]["residual_int8"], ranks[1]["residual_int8"]))


def test_refusals():
    from horovod_tpu_torch.models.transformer import TransformerLM

    tm = TransformerLM(vocab_size=16, d_model=8, n_heads=2, n_layers=1,
                       device="cpu")
    with pytest.raises(ValueError, match="bucket_order"):
        ht.Trainer(tm, ht.adamw(1e-3), device="cpu", bucket_order="sideways")
    os.environ["HVT_DCN_FACTOR"] = "2"
    try:
        with pytest.raises(ValueError, match="HVT_DCN_FACTOR"):
            ht.Trainer(tm, ht.adamw(1e-3), device="cpu")
    finally:
        del os.environ["HVT_DCN_FACTOR"]
    tree = {"w": torch.ones(4, 2), "b": torch.ones(3)}
    with pytest.raises(ValueError, match="quantized wire"):
        tcoll.reduce_gradients(tree, scatter=2,
                               residual={k: torch.zeros_like(v)
                                         for k, v in tree.items()})
    with pytest.raises(ValueError, match="unknown compression"):
        ht.DistributedOptimizer(ht.adamw(1e-3), compression="int4")


def _jax_quantized_steps(wire, res0, grads_by_step, n):
    """JAX's boundary reduction (`reduce_gradients` over ``n`` devices,
    ÷ n, the residual carried) over the given steps: per step the
    delivered gradients and the new residual, stacked by device."""
    from test_torch_quantized_wire import on_mesh

    jw = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[wire]

    def fn(g, res):
        red, new_res = jcoll.reduce_gradients(
            g, data_axis="data", extra_axes=(), wire_dtype=jw,
            bucket_bytes=EF_BUCKET_BYTES, reverse=True, residual=res)
        return jax.tree.map(lambda a: a / n, red), new_res

    res, out = res0, []
    for g in grads_by_step:
        red, res = on_mesh(fn, n, g, res)
        out.append((red, res))
    return out


def _hold_to_jax(wire, res0, grads, delivered, residual, n, err_msg):
    """``delivered`` / ``residual`` (per step, per leaf, stacked by rank)
    against JAX's on the same inputs, to f32 ulps but for counted rounding
    flips (`assert_equal_but_flips`). Returns the flips."""
    want = _jax_quantized_steps(wire, res0, grads, n)
    mag = max(np.abs(np.asarray(g[k])).max() + np.abs(res0[k]).max()
              for g in grads for k in g)
    qstep = {"int8": 1 / 127.0, "fp8": 32 / 448.0}[wire]
    flips = 0
    for t, (red, res) in enumerate(want):
        for k in red:
            for got, ref, what, q in (
                    (delivered[t][k], red[k], "delivered", mag * n * qstep),
                    (residual[t][k], res[k], "residual", mag * n * qstep)):
                flips += assert_equal_but_flips(
                    got, ref, mag * n, q, EF_MAX_FLIPS - flips,
                    f"{err_msg} step {t} {what} {k}")
    return flips


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_replicated_quantized_reduction_tracks_jax_over_steps(ranks, wire):
    """Two ranks, three steps, a nonzero residual at the start, several
    buckets: what the port's `DistributedOptimizer` delivers into ``.grad``
    and the residual it carries, each step, against JAX's
    `reduce_gradients` with its residual carried the same way."""
    names = sorted(EF_SHAPES)
    res0_rows = [ranks[r][f"ef_{wire}"][0] for r in range(2)]
    steps = [ranks[r][f"ef_{wire}"][1] for r in range(2)]

    def stacked(rows):  # rows[r][i] -> {name: [rank, ...]}
        return {k: np.stack([rows[r][i] for r in range(2)])
                for i, k in enumerate(names)}

    res0 = stacked(res0_rows)
    grads = [stacked([steps[r][t][0] for r in range(2)]) for t in range(3)]
    delivered = [stacked([steps[r][t][1] for r in range(2)])
                 for t in range(3)]
    residual = [stacked([steps[r][t][2] for r in range(2)])
                for t in range(3)]
    _hold_to_jax(wire, res0, grads, delivered, residual, 2, wire)
    # The residual is carried, not flushed: it is live at every step.
    assert all(np.abs(v).max() > 0 for st in residual for v in st.values())


def test_replicated_int8_step_matches_jax():
    """Three SGD steps (lr 1, so each update is the delivered gradient) on
    the int8 wire from a nonzero residual, several buckets: the port's
    `DistributedOptimizer` in a world of one against the JAX trainer's
    boundary step (`reduce_gradients` over one device with the residual
    carried, ÷ world size, then optax's SGD)."""
    rng = np.random.RandomState(7)
    names = sorted(EF_SHAPES)  # the port binds in this order, as JAX does
    p0 = {n: np.asarray(rng.randn(*EF_SHAPES[n]), np.float32) for n in names}
    res0 = {n: np.asarray(rng.randn(*EF_SHAPES[n]) * 0.02, np.float32)
            for n in names}
    grads = [{n: np.asarray(rng.randn(*EF_SHAPES[n]) * 0.3 * (1 + t),
                            np.float32) for n in names} for t in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(p0[n].copy()))
              for n in names]
    opt = ht.DistributedOptimizer(torch.optim.SGD(params, lr=1.0),
                                  compression="int8")
    opt.bucket_bytes = EF_BUCKET_BYTES
    for dst, n in zip(opt.residual, names):
        dst.copy_(torch.from_numpy(res0[n]))
    jp, tx = dict(p0), optax.sgd(1.0)
    got_params, got_res = [], []
    for g in grads:
        for p, n in zip(params, names):
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
        got_params.append({n: p.detach().numpy().copy()[None]
                           for n, p in zip(names, params)})
        got_res.append({n: v.numpy().copy()[None]
                        for n, v in zip(names, opt.residual)})
    one = lambda t: {n: v[None] for n, v in t.items()}  # noqa: E731
    want = _jax_quantized_steps("int8", one(res0), [one(g) for g in grads], 1)
    want_params = []
    for red, _ in want:
        upd, _ = tx.update({n: v[0] for n, v in red.items()}, tx.init(jp), jp)
        jp = {n: np.asarray(v) for n, v in
              optax.apply_updates(jp, upd).items()}
        want_params.append(one(jp))
    mag = max(np.abs(g[n]).max() for g in grads for n in names) + 0.1
    mag_p = max(np.abs(v).max() for v in p0.values()) + 3 * mag
    flips = 0
    for t, (got_p, got_r) in enumerate(zip(got_params, got_res)):
        for n in names:
            flips += assert_equal_but_flips(
                got_p[n], want_params[t][n], mag_p, mag / 127.0,
                EF_MAX_FLIPS - flips, f"step {t} parameter {n}")
            flips += assert_equal_but_flips(
                got_r[n], want[t][1][n], mag, mag / 127.0,
                EF_MAX_FLIPS - flips, f"step {t} residual {n}")


def test_misaligned_residual_is_refused():
    tree = {"w": torch.ones(4, 2), "b": torch.ones(3)}
    with pytest.raises(ValueError, match="do not align"):
        tcoll.reduce_gradients(tree, wire_dtype=torch.int8,
                               residual={"w": torch.zeros(4, 2),
                                         "b": torch.zeros(2)})
    half = {k: v.half() for k, v in tree.items()}
    with pytest.raises(ValueError, match="do not align"):
        tcoll.reduce_gradients(half, wire_dtype=torch.int8,
                               residual={k: torch.zeros_like(v)
                                         for k, v in tree.items()})


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_a_packed_step_reduces_again_at_every_replay(wire):
    """Graphs around the eager reduction (gloo) replay one packed step: its
    communicate stage must reduce every bucket again each time, not only
    the first (a world of one, the gradients changed in place as a replay
    of the backward would)."""
    p = torch.nn.Parameter(torch.zeros(6))
    opt = ht.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                  compression=wire)
    p.grad = torch.full((6,), 1.0)
    packed = opt.pack_gradients()
    for g in (1.0, 3.0, -2.0):
        p.grad.fill_(g)
        opt.communicate(packed)
        opt.unpack_gradients(packed)
        assert p.grad.tolist() == [g] * 6
