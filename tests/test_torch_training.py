"""Training in the port against the JAX package: the LM's loss and
gradients with labels (the fused-CE head), segment ids and remat against
flax; the port's AdamW against ``optax.adamw``; and the slice as a whole,
the port's ``Trainer.fit`` against ``horovod_tpu.Trainer.fit`` on the same
batches from the same parameters.

The flax params (from ``init`` with a fixed key, or the JAX trainer's
built state) go through `params_from_flax` into the port; gradients come
back through the same map. T = 128 so that the JAX side runs its Pallas
flash kernels (interpret mode on the CPU) rather than its dense fallback.
Tolerances are stated beside each comparison; all are f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.data import datasets as jdata
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.data import datasets as tdata
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import mesh as tmesh

VOCAB, D_MODEL, HEADS, LAYERS, T = 64, 32, 4, 2, 128
# Loss: a 2-layer f32 model and a 64-way logsumexp, summed in other orders
# on the two sides. Gradients: the same through the backward (abs; their
# magnitudes are ≤ ~0.1 for a mean loss).
LOSS_TOL, GRAD_TOL = 1e-5, 1e-6


def _cfg(**kw):
    return dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                n_layers=LAYERS, dropout=0.0, fused_head_chunks=3, **kw)


def _pair(seed=0, **kw):
    jm = jtr.TransformerLM(**_cfg(**kw))
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 16), jnp.int32))["params"]
    tm = ttr.TransformerLM(**_cfg(**kw), device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _batch(seed, b=2, t=T):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, (b, t)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _segments(b, t):
    """Packed documents: three runs per row at row-dependent cuts."""
    ids = np.zeros((b, t), np.int32)
    for i in range(b):
        ids[i, 40 + 8 * i:] = 1
        ids[i, 90 - 4 * i:] = 2
    return ids


def _flax_loss_and_grads(jm, params, x, y, segment_ids=None):
    kw = {} if segment_ids is None else {"segment_ids": jnp.asarray(segment_ids)}

    def loss_fn(p):
        loss, correct = jm.apply({"params": p}, jnp.asarray(x),
                                 labels=jnp.asarray(y), **kw)
        return loss.mean(), (loss, correct)

    (_, (loss, correct)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    return np.asarray(loss), np.asarray(correct), params_from_flax(
        jax.device_get(grads))


def _torch_loss_and_grads(tm, x, y, segment_ids=None, **kw):
    tm.zero_grad(set_to_none=True)
    seg = None if segment_ids is None else torch.from_numpy(segment_ids)
    loss, correct = tm(torch.from_numpy(x), labels=torch.from_numpy(y),
                       segment_ids=seg, **kw)
    loss.mean().backward()
    return (loss.detach().numpy(), correct.numpy(),
            {n: p.grad for n, p in tm.named_parameters()})


def _assert_grads_close(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("kw", [
    {}, {"n_kv_heads": 2}, {"window": 24, "attention_sinks": 2},
], ids=["mha", "gqa", "window_sinks"])
def test_labels_loss_and_grads_match_flax(kw):
    jm, params, tm = _pair(**kw)
    x, y = _batch(1)
    jl, jc, jg = _flax_loss_and_grads(jm, params, x, y)
    tl, tc, tg = _torch_loss_and_grads(tm, x, y)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    np.testing.assert_array_equal(tc, jc)
    _assert_grads_close(tg, jg)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}], ids=["mha", "gqa"])
def test_segment_ids_loss_and_grads_match_flax(kw):
    """Packed rows: RoPE positions restart per document and attention
    stays within it (the flash kernels' segment masks)."""
    jm, params, tm = _pair(**kw)
    x, y = _batch(2)
    seg = _segments(2, T)
    jl, _, jg = _flax_loss_and_grads(jm, params, x, y, seg)
    tl, _, tg = _torch_loss_and_grads(tm, x, y, seg)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_grads_close(tg, jg)
    # Packing changed the function.
    ul, _, _ = _torch_loss_and_grads(tm, x, y)
    assert np.abs(ul - tl).max() > 1e-3


def test_packed_positions_match_flax():
    seg = np.array([[0, 0, 0, 1, 1, 2, 2, 2], [5, 5, 5, 5, 5, 5, 5, 5],
                    [0, 1, 0, 1, 1, 1, 3, 3]], np.int32)
    want = np.asarray(jtr.packed_positions(jnp.asarray(seg)))
    got = ttr.packed_positions(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_remat_gives_the_same_gradients_and_matches_flax_remat():
    jm, params, tm = _pair(remat=True)
    x, y = _batch(3)
    jl, _, jg = _flax_loss_and_grads(jm, params, x, y)
    tl, _, tg = _torch_loss_and_grads(tm, x, y)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL, rtol=0)
    _assert_grads_close(tg, jg)
    plain = ttr.TransformerLM(**_cfg(), device="cpu")
    plain.load_state_dict(tm.state_dict())
    _, _, pg = _torch_loss_and_grads(plain, x, y)
    for name in pg:
        torch.testing.assert_close(tg[name], pg[name], atol=0, rtol=0)


def test_fused_head_chunks_zero_is_one_chunk():
    _, _, tm = _pair()
    x, y = _batch(4)
    one = ttr.TransformerLM(**{**_cfg(), "fused_head_chunks": 0},
                            device="cpu")
    one.load_state_dict(tm.state_dict())
    a, _, _ = _torch_loss_and_grads(tm, x, y)
    b, _, _ = _torch_loss_and_grads(one, x, y)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with torch.no_grad():
        logits = tm(torch.from_numpy(x))
    dense = torch.nn.functional.cross_entropy(
        logits.reshape(-1, VOCAB), torch.from_numpy(y).reshape(-1).long(),
        reduction="none").view(y.shape)
    np.testing.assert_allclose(b, dense.numpy(), atol=1e-5, rtol=0)


# -- dropout: explicit, seeded randomness -----------------------------------


def _dropout_model(remat=False):
    return ttr.TransformerLM(**{**_cfg(), "dropout": 0.25, "remat": remat},
                             device="cpu", seed=5)


def test_dropout_masks_come_from_the_seed_not_the_global_rng():
    tm = _dropout_model()
    x, y = _batch(5)
    rng_state = torch.get_rng_state()
    a, _, ga = _torch_loss_and_grads(tm, x, y, train=True, dropout_seed=11)
    assert torch.equal(torch.get_rng_state(), rng_state)
    torch.manual_seed(123)  # the global RNG has no say
    b, _, gb = _torch_loss_and_grads(tm, x, y, train=True, dropout_seed=11)
    c, _, _ = _torch_loss_and_grads(tm, x, y, train=True, dropout_seed=12)
    d, _, _ = _torch_loss_and_grads(tm, x, y, train=False)
    np.testing.assert_array_equal(a, b)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], atol=0, rtol=0)
    assert np.abs(a - c).max() > 1e-3 and np.abs(a - d).max() > 1e-3
    x2 = torch.ones(4, 1000)
    m1 = ttr.dropout(x2, 0.25, 7)
    assert torch.equal(m1, ttr.dropout(x2, 0.25, 7))
    assert not torch.equal(m1, ttr.dropout(x2, 0.25, 8))
    keep = float((m1 != 0).float().mean())
    assert abs(keep - 0.75) < 0.03
    torch.testing.assert_close(m1[m1 != 0], torch.full_like(m1[m1 != 0],
                                                            1 / 0.75))


def test_dropout_is_redrawn_identically_under_remat():
    x, y = _batch(6)
    plain, remat = _dropout_model(), _dropout_model(remat=True)
    a, _, ga = _torch_loss_and_grads(plain, x, y, train=True, dropout_seed=3)
    b, _, gb = _torch_loss_and_grads(remat, x, y, train=True, dropout_seed=3)
    np.testing.assert_array_equal(a, b)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], atol=0, rtol=0)


def test_train_with_dropout_needs_a_seed():
    tm = _dropout_model()
    x, y = _batch(7)
    with pytest.raises(ValueError, match="dropout_seed"):
        tm(torch.from_numpy(x), train=True)


# -- optimizer ----------------------------------------------------------------


def test_adamw_matches_optax_over_steps():
    """Five steps of the port's AdamW (optax's defaults, stated) against
    ``optax.adamw`` on the same numpy gradients, with an update scale of
    0.5 on one step (JAX's ``update_scale`` multiplies the update).
    Tolerance 1e-6 abs (f32 elementwise math in another order)."""
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 3), "b": (7,)}
    p0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(5)]
    scales = [1.0, 1.0, 0.5, 1.0, 1.0]
    tx = optax.adamw(3e-2)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    st = tx.init(jp)
    for g, s in zip(grads, scales):
        upd, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * s, upd))
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in p0.items()}
    opt = ht.DistributedOptimizer(ht.adamw(3e-2))
    opt.bind(tp.values())
    for g, s in zip(grads, scales):
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n])
        opt.step(s)
    for n in shapes:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=0, err_msg=n)
    group = opt.optimizer.param_groups[0]
    assert group["lr"] == 3e-2  # the scale does not stick
    assert (group["weight_decay"], group["eps"], group["betas"]) == (
        1e-4, 1e-8, (0.9, 0.999))


def test_distributed_optimizer_contract():
    assert ht.scale_lr(3e-4) == 3e-4  # a world of 1
    assert ht.scale_lr(3e-4, 8) == pytest.approx(2.4e-3)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ht.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                  compression="bf16")
    p.grad = torch.tensor([1.0 + 2**-12, 3.0, -1.0])
    opt.step()
    # the gradient went through the bf16 wire: 1 + 2^-12 rounds to 1
    torch.testing.assert_close(p.detach(), torch.tensor([-1.0, -3.0, 1.0]))
    for kw in ({"compression": "int8"}, {"compression": "fp8"},
               {"compression_ici": "bf16"}, {"compression_ici": "int8"}):
        ht.DistributedOptimizer(ht.adamw(1e-3), **kw)  # accepted
    # A world of one still quantizes on an int8 wire (one f32 scale per
    # bucket, both shots), and error feedback keeps what it rounded away.
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ht.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                  compression="int8")
    g = np.array([1.0, 0.5, -0.3], np.float32)
    p.grad = torch.from_numpy(g.copy())
    opt.step()
    scale = np.float32(1.0) / np.float32(127.0)
    q = np.round(g * (np.float32(1.0) / scale)).astype(np.float32)
    assert q.tolist() == [127.0, 64.0, -38.0]  # 63.5 rounds to even
    np.testing.assert_array_equal(p.detach().numpy(), -(q * scale))
    np.testing.assert_array_equal(opt.residual[0].numpy(), g - q * scale)
    assert opt.state_dict()["ef_residual"][0].shape == (1, 3)
    for kw in ({"compression": "zip"}, {"backward_passes_per_step": 0}):
        with pytest.raises(ValueError):
            ht.DistributedOptimizer(ht.adamw(1e-3), **kw)
    # Accumulated passes: summed by default, averaged on request (a world
    # of 1, no process group: the reduction is local).
    for avg, want in ((False, -4.0), (True, -2.0)):
        q = torch.nn.Parameter(torch.zeros(1))
        acc = ht.DistributedOptimizer(
            torch.optim.SGD([q], lr=1.0), backward_passes_per_step=2,
            average_aggregated_gradients=avg)
        q.grad = torch.tensor([4.0])  # the sum of two passes' gradients
        acc.step()
        assert float(q.detach()) == want


# -- the trainer --------------------------------------------------------------


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy",
                                  "categorical_crossentropy"])
def test_loss_resolution_and_accuracy_match_jax(loss):
    """`_resolve_loss` and `_accuracy` against the JAX train_state's, on
    the same f32 logits (integer labels, or one-hot for the
    categorical loss). Tolerance 1e-6 (one log-softmax per row)."""
    from horovod_tpu.training import train_state as jts
    from horovod_tpu_torch.training import train_state as tts

    rng = np.random.RandomState(11)
    logits = rng.randn(6, 5, 10).astype(np.float32)
    labels = rng.randint(0, 10, (6, 5)).astype(np.int32)
    if loss == "categorical_crossentropy":
        labels = np.eye(10, dtype=np.float32)[labels]
    want = np.asarray(jts._resolve_loss(loss)(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    got = tts._resolve_loss(loss)(torch.from_numpy(logits),
                                  torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    acc_j = float(jts._accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    acc_t = float(tts._accuracy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    assert acc_t == pytest.approx(acc_j, abs=1e-7)
    assert tts._resolve_loss("module") is None
    with pytest.raises(ValueError):
        tts._resolve_loss("hinge")


def test_copy_task_is_byte_identical():
    for args in ((16, 12, 30, 0), (5, 1024, 8192, 3)):
        for a, b in zip(jdata.copy_task(*args), tdata.copy_task(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_trainer_fit_matches_jax_trainer():
    """The slice as a whole: `Trainer(..., DistributedOptimizer(adamw),
    loss="module").fit(dataset=...)` from the JAX trainer's built params,
    on the same three batches of copy_task (global batch 8, divisible by
    the 8 virtual CPU devices), one step per epoch so the histories are
    per step; then evaluate on both.

    Tolerances (f32): per-step loss 1e-5; final params 1e-5 abs — except
    where a gradient element was tiny (below 1e-6 of its tensor's largest)
    at some step: there Adam's normalised step g / (|g| + eps) turns the
    f32 rounding of g into up to ±lr per step, so those elements (at most
    0.1 % of them) are held to 2·lr·steps."""
    lr, steps = 3e-3, 3
    x, y = jdata.copy_task(8 * steps, T, VOCAB, seed=1)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 8 * steps, 8)]
    jm = jtr.TransformerLM(**_cfg())
    jtrainer = hvt.Trainer(jm, hvt.DistributedOptimizer(optax.adamw(lr)),
                           loss="module", seed=0)
    jparams = jax.device_get(jtrainer.build(batches[0][0]).params)
    tm = ttr.TransformerLM(**_cfg(), device="cpu")
    tm.load_state_dict(params_from_flax(jparams))
    ttrainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adamw(lr)),
                          loss="module", seed=0, device="cpu")

    jh = jtrainer.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                      verbose=0)
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in tm.named_parameters()}
    for batch in batches:  # one fit per step, to read each step's grads
        ttrainer.fit(dataset=[batch], steps_per_epoch=1)
        for n, p in tm.named_parameters():
            g = p.grad.abs()
            tiny[n] |= g < 1e-6 * g.max()
    th = ttrainer.history
    np.testing.assert_allclose([e["loss"] for e in th],
                               [e["loss"] for e in jh], atol=1e-5, rtol=0)
    np.testing.assert_allclose([e["accuracy"] for e in th],
                               [e["accuracy"] for e in jh], atol=1e-6)
    assert th[-1]["loss"] < th[0]["loss"]
    assert ttrainer.state.step == steps
    want = params_from_flax(jax.device_get(jtrainer.state.params))
    for name, p in tm.named_parameters():
        assert float(tiny[name].float().mean()) <= 1e-3, name
        tol = torch.where(tiny[name], 2 * lr * steps, 1e-5)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))
    je = jtrainer.evaluate(x, y, batch_size=8)
    te = ttrainer.evaluate(x, y, batch_size=8)
    assert te["loss"] == pytest.approx(je["loss"], abs=1e-5)
    assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-6)


def test_trainer_paths_on_cpu():
    """x=/y= feeding, a Trainer-side loss, predict, and the launch counts:
    on the CPU no kernel is launched."""
    x, y = tdata.copy_task(32, 16, VOCAB, seed=2)
    tm = ttr.TransformerLM(**{**_cfg(), "fused_head_chunks": 0},
                           device="cpu", seed=1)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adamw(1e-2)),
                         device="cpu")
    before = (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    hist = trainer.fit(x=x, y=y, batch_size=8, epochs=2,
                       validation_data=(x[:8], y[:8]))
    assert (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv) == before
    assert len(hist) == 2 and trainer.state.step == 8
    assert hist[1]["loss"] < hist[0]["loss"]
    assert {"val_loss", "val_accuracy", "epoch_time_s"} <= set(hist[0])
    probs = trainer.predict(x[:3], batch_size=2)
    assert probs.shape == (3, 16, VOCAB)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    ev = trainer.evaluate(x, y, batch_size=16)
    assert 0.0 <= ev["accuracy"] <= 1.0 and np.isfinite(ev["loss"])
    with pytest.raises(ValueError, match="x=/y="):
        trainer.fit(x=x, batch_size=8)
    # More steps than the epoch's full batches: the anchored stream draws
    # a second pass within the epoch.
    trainer.fit(x=x, y=y, batch_size=8, steps_per_epoch=5)
    assert trainer.state.step == 13


def _layout_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.build_mesh(tmesh.MeshSpec(**axes), n_ranks=n, rank=0)


@pytest.mark.parametrize("kw,match", [
    (lambda: {"mesh": _layout_mesh(data=1, pipe=2)}, "item 12.4"),
    (lambda: {"mesh": _layout_mesh(data=1, pipe=2, model=2),
              "param_specs": ttr.param_specs}, "item 12.4"),
    (lambda: {"batch_specs": (tmesh.P("data", None, "seq"),)}, "item 12.4"),
], ids=["mesh", "param_specs", "batch_specs"])
def test_trainer_unported_options_raise_naming_roadmap(kw, match):
    """What the port does not carry raises naming its ROADMAP item: a live
    ``pipe`` axis (12.4, the pipeline), with or without placements, and
    batch layouts other than JAX's ``P(('data', 'fsdp'), 'seq', None)``
    (12.4). Meshes, expert placements, the ``seq`` axis and the live
    ``model``/``fsdp`` axes: tests/test_torch_mesh.py,
    tests/test_torch_expert_parallel.py, tests/test_torch_seq_parallel.py,
    tests/test_torch_tensor_parallel.py and tests/test_torch_fsdp.py."""
    tm = ttr.TransformerLM(**_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        ht.Trainer(tm, ht.adamw(1e-3), device="cpu", **kw())


def test_trainer_callbacks_raise_naming_roadmap():
    tm = ttr.TransformerLM(**_cfg(), device="cpu")
    trainer = ht.Trainer(tm, ht.adamw(1e-3), loss="module", device="cpu")
    x, y = _batch(9)
    with pytest.raises(TypeError, match="Callback"):
        trainer.fit(x=x, y=y, batch_size=2, callbacks=[object()])
    with pytest.raises(NotImplementedError, match="item 13"):
        ht.callbacks.ModelCheckpoint("checkpoint-{epoch}.pt", async_save=True)
    with pytest.raises(RuntimeError, match="build"):
        trainer.evaluate(x, y)


def test_params_round_trip_after_training():
    """The trained torch state goes back to a flax tree the JAX model
    applies to the same loss."""
    jm, _, tm = _pair()
    trainer = ht.Trainer(tm, ht.adamw(1e-2), loss="module", device="cpu")
    x, y = _batch(10)
    trainer.fit(dataset=[(x, y)], steps_per_epoch=1)
    back = params_to_flax(tm.state_dict(), n_heads=HEADS)
    jl, _ = jm.apply({"params": back}, jnp.asarray(x), labels=jnp.asarray(y))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_TOL)
