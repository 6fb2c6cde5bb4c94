"""The MoE `TransformerLM` of the port against the JAX package's, on the
CPU in f32 from the same flax parameters: logits, the loss with labels and
every gradient (the load-balancing loss in the objective); three
`Trainer.fit` steps against the JAX `Trainer` (the counterpart of
tests/test_moe.py::test_trainer_adds_aux_to_objective, with
``moe_drop_rate`` in the history); the reserved-name and train-gated-sow
errors; `generate` against JAX's at ``capacity_factor=4.0`` (drop-free, so
decode equals the recompute); and the refusals of expert-choice decode,
speculative decoding and ``int8_compute`` with JAX's texts.

Tolerances: logits and per-token loss 1e-5 abs; gradients 1e-5 relative
to each tensor's largest element; after three AdamW steps parameters 1e-5
abs except where a gradient element was below 1e-5 of its tensor's
largest (and not exactly zero) at some step, held to 2·lr·steps (Adam's
g / (|g| + eps) turns f32 rounding of a near-zero g into up to ±lr), as
tests/test_torch_training.py::test_trainer_fit_matches_jax_trainer does
at 1e-6; at these shapes the routed layers' gradients are sparser, and an
element at 1.3e-6 of its tensor's largest moved 3.4e-5 apart (at most
0.2 % of a tensor is so held; measured ≤ 0.12 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import horovod_tpu as hvt
import horovod_tpu_torch as ht
from horovod_tpu.data import datasets as jdata
from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import speculative as jspec
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import speculative as tspec
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax
from horovod_tpu_torch.training import train_state

VOCAB, D_MODEL, HEADS, LAYERS, T = 64, 32, 4, 2, 32
LOGIT_TOL, GRAD_RTOL = 1e-5, 1e-5
# Adam-amplified elements (module docstring): a gradient below this share
# of its tensor's largest at some step, at most TINY_SHARE of a tensor.
TINY_GRAD, TINY_SHARE = 1e-5, 2e-3
MARGIN = 1e-3


def _cfg(**kw):
    base = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                n_layers=LAYERS, dropout=0.0, moe_every=2, n_experts=4,
                fused_head_chunks=2)
    return {**base, **kw}


def _pair(seed=0, **kw):
    jm = jtr.TransformerLM(**_cfg(**kw))
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, 16), jnp.int32))["params"])
    tm = ttr.TransformerLM(**_cfg(**kw), device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _batch(seed, b=4, t=T):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, (b, t)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _rel_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= GRAD_RTOL, (what, err)


@pytest.mark.parametrize("kw", [{}, {"moe_k": 1, "capacity_factor": 0.5},
                                {"moe_router": "expert_choice"},
                                {"n_kv_heads": 2, "moe_every": 1}],
                         ids=["top2", "top1_drops", "expert_choice",
                              "gqa_every_block"])
def test_loss_logits_and_grads_match_flax(kw):
    jm, params, tm = _pair(**kw)
    x, y = _batch(1)
    # Logits in eval mode.
    jlog = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        tlog = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tlog, jlog, atol=LOGIT_TOL, rtol=0)

    # The training objective: mean per-token loss + the sown aux losses.
    def loss_fn(p):
        (loss, correct), st = jm.apply(
            {"params": p}, jnp.asarray(x), labels=jnp.asarray(y), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["losses", "metrics"])
        aux = sum((jnp.sum(v) for v in jax.tree.leaves(st.get("losses", {}))),
                  jnp.zeros((), jnp.float32))
        return loss.mean() + aux, (loss, st)

    (jobj, (jloss, st)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    loss, _ = tm(torch.from_numpy(x), labels=torch.from_numpy(y), train=True,
                 dropout_seed=0)
    aux = tm.sown_losses()
    obj = loss.mean() + (sum(aux) if aux else 0.0)
    obj.backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               atol=LOGIT_TOL, rtol=0)
    assert float(obj.detach()) == pytest.approx(float(jobj), abs=LOGIT_TOL)
    assert len(aux) == len(jax.tree.leaves(st.get("losses", {})))
    sown = tm.sown_metrics()
    jmet = hvt.training.train_state._aggregate_sown_metrics(st["metrics"])
    assert set(sown) == set(jmet)
    for k in jmet:
        assert float(sown[k]) == pytest.approx(float(jmet[k]), abs=1e-6)
    want = params_from_flax(jax.device_get(jg))
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        _rel_close(got[name], want[name].numpy(), name)


def test_params_round_trip_through_flax_layout():
    _, params, tm = _pair()
    back = params_to_flax(tm.state_dict(), n_heads=HEADS)
    assert (jax.tree.structure(back) == jax.tree.structure(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_trainer_fit_matches_jax_trainer():
    """Three steps of ``Trainer(..., adamw, loss="module").fit(dataset=)``
    from the JAX trainer's built params, one step an epoch: losses (the
    objective with the aux loss), accuracies, ``moe_drop_rate`` and the
    final parameters; then evaluate on both."""
    lr, steps = 3e-3, 3
    x, y = jdata.copy_task(8 * steps, T, VOCAB, seed=1)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 8 * steps, 8)]
    kw = _cfg(capacity_factor=1.0)
    jm = jtr.TransformerLM(**kw)
    jtrainer = hvt.Trainer(jm, hvt.DistributedOptimizer(optax.adamw(lr)),
                           loss="module", seed=0)
    jparams = jax.device_get(jtrainer.build(batches[0][0]).params)
    tm = ttr.TransformerLM(**kw, device="cpu")
    tm.load_state_dict(params_from_flax(jparams))
    ttrainer = ht.Trainer(tm, ht.DistributedOptimizer(ht.adamw(lr)),
                          loss="module", seed=0, device="cpu")
    jh = jtrainer.fit(dataset=list(batches), epochs=steps, steps_per_epoch=1,
                      verbose=0)
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in tm.named_parameters()}
    for batch in batches:  # one fit per step, to read each step's grads
        ttrainer.fit(dataset=[batch], steps_per_epoch=1, verbose=0)
        for n, p in tm.named_parameters():
            g = p.grad.abs()
            # Embedding rows of tokens absent from the batch (and experts
            # no token reached) have exact zero gradients on both sides:
            # held to 1e-5 with the rest.
            tiny[n] |= (g < TINY_GRAD * g.max()) & (g > 0)
    th = ttrainer.history
    assert ttrainer.metric_names == tuple(jtrainer.metric_names) == (
        "loss", "accuracy", "moe_drop_rate")
    for key, tol in (("loss", 1e-5), ("accuracy", 1e-6),
                     ("moe_drop_rate", 1e-6)):
        np.testing.assert_allclose([e[key] for e in th],
                                   [e[key] for e in jh], atol=tol, rtol=0,
                                   err_msg=key)
    assert all(0.0 <= e["moe_drop_rate"] < 1.0 for e in th)
    assert any(e["moe_drop_rate"] > 0.0 for e in th)
    want = params_from_flax(jax.device_get(jtrainer.state.params))
    for name, p in tm.named_parameters():
        assert float(tiny[name].float().mean()) <= TINY_SHARE, name
        tol = torch.where(tiny[name], 2 * lr * steps, 1e-5)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))
    # JAX evaluates batch_size rows per device of its 8, the MoE layers
    # routing the global batch as one; 3 × 8 is all 24 rows, unpadded,
    # which the port at one rank evaluates as one batch.
    je = jtrainer.evaluate(x, y, batch_size=3)
    te = ttrainer.evaluate(x, y, batch_size=24)
    assert te["loss"] == pytest.approx(je["loss"], abs=1e-5)
    assert te["accuracy"] == pytest.approx(je["accuracy"], abs=1e-6)


def test_trainer_adds_aux_to_objective():
    """The same model with aux_loss_coef 0 and 100 reports training losses
    apart (tests/test_moe.py's check, on the port)."""
    def run(coef):
        tm = ttr.TransformerLM(**_cfg(moe_aux_coef=coef), device="cpu")
        trainer = ht.Trainer(tm, ht.DistributedOptimizer(
            lambda p: torch.optim.SGD(p, lr=0.0)), loss="module",
            device="cpu")
        x, y = _batch(2, b=8)
        return trainer.fit(dataset=[(x, y)], steps_per_epoch=1,
                           verbose=0)[0]["loss"]

    assert run(100.0) > run(0.0) + 1.0


class _Sowing(nn.Module):
    """A one-layer torch module sowing a metric, the port's counterpart of
    tests/test_moe.py's flax ``Gated``/``BadName`` modules."""

    def __init__(self, name: str, gated: bool):
        super().__init__()
        self.dense = nn.Linear(4, 4)
        self.sown = {}
        self.metric, self.gated = name, gated

    def forward(self, x, train=False, dropout_seed=None):
        y = self.dense(x.reshape(x.shape[0], -1).float())
        if train or not self.gated:
            train_state.sow(self, "metrics", self.metric, y.mean())
        return y


def _flax_sowing(name, gated):
    import flax.linen as fnn

    class Sowing(fnn.Module):
        @fnn.compact
        def __call__(self, x, *, train=False):
            y = fnn.Dense(4)(x.reshape((x.shape[0], -1)))
            if train or not gated:
                self.sow("metrics", name, jnp.mean(y))
            return y

    return Sowing()


def test_train_gated_metric_sow_is_loud():
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    y = np.zeros(16, np.int64)
    jt = hvt.Trainer(_flax_sowing("gated", True),
                     hvt.DistributedOptimizer(optax.sgd(0.1)))
    with pytest.raises(ValueError) as ref:
        jt.fit(x=x, y=y, batch_size=2, epochs=1, steps_per_epoch=1,
               verbose=0)
    tt = ht.Trainer(_Sowing("gated", True), ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=0.1)), device="cpu")
    with pytest.raises(ValueError) as port:
        tt.fit(x=x, y=y, batch_size=2, epochs=1, steps_per_epoch=1,
               verbose=0)
    assert str(port.value) == str(ref.value)
    assert "unconditional" in str(port.value)


def test_reserved_metric_name_is_loud():
    jt = hvt.Trainer(_flax_sowing("loss", False),
                     hvt.DistributedOptimizer(optax.sgd(0.1)))
    with pytest.raises(ValueError) as ref:
        jt.build(np.zeros((8, 4), np.float32))
    tt = ht.Trainer(_Sowing("loss", False), ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=0.1)), device="cpu")
    with pytest.raises(ValueError) as port:
        tt.build(np.zeros((8, 4), np.float32))
    assert str(port.value) == str(ref.value)
    assert "rename the sow" in str(port.value)


def test_generate_matches_jax_at_ample_capacity():
    """Greedy MoE generation at capacity_factor 4 (no drops, so decode
    equals the recompute) against JAX's generate and against the port's
    own no-cache recompute; a JAX/port difference is allowed only at a
    near-tie of JAX's logits."""
    jm, params, tm = _pair(capacity_factor=4.0)
    prompt = np.random.RandomState(4).randint(0, VOCAB, (3, 7)).astype(
        np.int32)
    new = 8
    jt = np.asarray(jdec.generate(jm, params, jnp.asarray(prompt), new))
    tt = tdec.generate(tm, torch.from_numpy(prompt), new).numpy()
    assert tt.shape == jt.shape == (3, 7 + new)
    for i in range(len(prompt)):
        diff = np.nonzero(jt[i] != tt[i])[0]
        if len(diff):
            seq = jt[i:i + 1, :diff[0]]
            logits = np.asarray(jm.apply({"params": params},
                                         jnp.asarray(seq)))
            top2 = np.sort(logits[0, -1])[-2:]
            assert top2[1] - top2[0] <= MARGIN, (i, diff[0])
    tokens = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(new):
            nxt = tm(tokens)[:, -1].argmax(-1).to(tokens.dtype)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(tt, tokens.numpy())


def test_refusals_match_jax():
    """Expert-choice decode, speculative decoding of an MoE model and
    ``int8_compute`` with MoE raise JAX's errors, with its texts."""
    jm, params, tm = _pair(moe_router="expert_choice")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError) as ref:
        jdec.generate(jm, params, jnp.asarray(prompt), 2)
    with pytest.raises(ValueError) as port:
        tdec.generate(tm, torch.from_numpy(prompt), 2)
    assert str(port.value) == str(ref.value)

    jm, params, tm = _pair()
    with pytest.raises(ValueError) as ref:
        jspec.make_speculative_fn(jm, max_new_tokens=4)
    with pytest.raises(ValueError) as port:
        tspec.make_speculative_fn(tm, max_new_tokens=4)
    assert str(port.value) == str(ref.value)

    with pytest.raises(ValueError) as ref:
        jm.clone(int8_compute=True).apply({"params": params},
                                          jnp.asarray(prompt))
    with pytest.raises(ValueError) as port:
        ttr.TransformerLM(**_cfg(int8_compute=True), device="cpu")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as port:
        tm.clone(int8_compute=True)
    assert str(port.value) == str(ref.value)


def test_quantized_expert_weights_match_jax():
    """Weight-only int8 of an MoE model: the expert weights reduced over
    flax's axis 0 as JAX's `quantize_params` reduces them, values and
    scales equal; the dequantized tree feeds the model's decode."""
    from horovod_tpu.models import quant as jquant
    from horovod_tpu_torch.models import quant as tquant

    _, params, tm = _pair(n_experts=4)
    jq = jax.device_get(jquant.quantize_params(params))
    tq = tquant.quantize_params(tm, min_size=4096)
    for leaf in ("moe_up", "moe_down"):
        got, want = tq[f"blocks.1.moe.{leaf}"], jq["Block_1"]["moe"][leaf]
        np.testing.assert_array_equal(got["int8_q"].numpy(),
                                      np.asarray(want["int8_q"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
    deq = tquant.dequantize_params(tq, torch.float32)
    for leaf in ("moe_up", "moe_down"):
        name = f"blocks.1.moe.{leaf}"
        w = dict(tm.named_parameters())[name].detach()
        step = tq[name]["scale"]
        assert float((deq[name] - w).abs().max()) <= float(step.max()) / 2 + 1e-7
