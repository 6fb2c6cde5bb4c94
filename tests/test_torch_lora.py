"""LoRA in the port (`models/lora.py`) against the JAX package's
`horovod_tpu.models.lora`, at ``tests/test_lora.py``'s sizes (the LM at
vocab 64, d 32, 4 heads, 2 layers; x [16, 12]):

* zero-init is the identity, and the adapters are few;
* the wrapped forward equals JAX's, with JAX's adapters converted
  (`lora_params_from_flax`, B made nonzero): the adapter geometry is the
  flax kernel's (``qkv`` [d, H, 3·D], ``attn_out`` [H, D, d]);
* `merge_params` equals the converter of JAX's ``merge_params`` for every
  adapted kernel (``qkv``, ``attn_out``, ``mlp_*``, ``lm_head``), at the
  model's own alpha (16 and 8);
* five ``freeze_base(adamw)`` steps against JAX's: the base bit-equal to
  its start, the losses and the adapters;
* the optimizer's state covers the adapters alone; the fused CE head
  composes; the MoE aux channels pass through (``moe_drop_rate``); a
  module's buffers update through the wrapper;
* `param_specs`: JAX's four ``TestLoRAWithTP`` cases;
* an int8 or fp8 wire (and ZeRO-1) with ``freeze_base`` refused naming
  ROADMAP queue A item 17.

Tolerances: f32 on both sides. Logits within 1e-5 of their largest
element; merged weights within 1e-6 absolute (a rank-4 product added to
the base); per-step losses within 1e-5. After five AdamW steps the
adapters within 1e-5 absolute, except where a gradient element was tiny
but not zero at some step (below 1e-4 of its tensor's largest): Adam's
g / (|g| + eps) turns its f32 rounding into up to ±lr a step, so those
elements are held to 2·lr·steps (they are counted, and at most 2 % of an
adapter).
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
from horovod_tpu.models import lora as jlora
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import lora
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    lm_kernels, lora_params_from_flax, params_from_flax,
)
from horovod_tpu_torch.parallel import mesh as tmesh

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
LR, STEPS, TINY = 1e-2, 5, 1e-4


def _data(seed=0, n=16, t=12):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 64, size=(n, t)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _tlm(**kw):
    return ttr.TransformerLM(**CFG, **kw, device="cpu")


def _close(got, want, what, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err)


def _jax_pair(rank=4, alpha=16.0, bump=0.01, **kw):
    """JAX's LoRAModel params (every leaf + ``bump``: B nonzero), and the
    port's model holding them."""
    jm = jlora.LoRAModel(inner=jtr.TransformerLM(**CFG, **kw), rank=rank,
                         alpha=alpha)
    x, _ = _data()
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree.map(lambda p: p + bump, params)
    tm = lora.LoRAModel(_tlm(**kw), rank=rank, alpha=alpha)
    tm.load_state_dict(lora_params_from_flax(jax.device_get(params), tm))
    return jm, params, tm


def test_zero_init_is_identity_and_adapters_are_few():
    inner = _tlm()
    model = lora.LoRAModel(inner, rank=4)
    x = torch.from_numpy(_data()[0])
    with torch.no_grad():
        assert torch.equal(model(x), inner(x))
    small = lora.LoRAModel(_tlm(), rank=2)
    n_base = sum(p.numel() for p in small.base.parameters())
    n_lora = sum(p.numel() for p in small.lora.parameters())
    assert n_lora < n_base / 5, (n_lora, n_base)
    # Every default target of the LM, and nothing else.
    assert sorted({n.split(".")[-2] for n in small.adapted}) == [
        "attn_out", "lm_head", "mlp_down", "mlp_up", "qkv"]


def test_wrapped_forward_and_merge_match_jax():
    jm, params, tm = _jax_pair()
    x, _ = _data()
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want, "wrapped logits")
    merged = lora.merge_params(tm)
    jmerged = params_from_flax(jax.device_get(
        jlora.merge_params(params, alpha=16.0)))
    assert set(merged) == set(jmerged)
    for name in merged:
        err = float((merged[name] - jmerged[name]).abs().max())
        assert err <= 1e-6, (name, err)
    # The merged weights in the plain model give the wrapped forward.
    plain = _tlm()
    plain.load_state_dict(merged)
    with torch.no_grad():
        _close(plain(torch.from_numpy(x)).numpy(), got, "merged logits")


def test_merge_params_takes_the_models_alpha():
    # alpha 8 at rank 4: the fold must use the model's scale (2), not the
    # default alpha's (4).
    jm, params, tm = _jax_pair(alpha=8.0)
    x, _ = _data()
    merged = lora.merge_params(tm)
    jmerged = params_from_flax(jax.device_get(
        jlora.merge_params(params, alpha=8.0)))
    for name in merged:
        err = float((merged[name] - jmerged[name]).abs().max())
        assert err <= 1e-6, (name, err)
    plain = _tlm()
    plain.load_state_dict(merged)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
        _close(plain(torch.from_numpy(x)).numpy(), want, "merged logits")
    # An explicit scale still overrides it.
    name = tm.adapted[0]
    twice = lora.merge_params(tm, scale=2 * tm.scale)[name]
    base = tm.base.get_parameter(name).detach()
    torch.testing.assert_close(twice - base, 2 * (merged[name] - base),
                               rtol=1e-5, atol=1e-6)


def _jax_fit(steps, **kw):
    jm = jlora.LoRAModel(inner=jtr.TransformerLM(**CFG, **kw), rank=4,
                         alpha=8.0)
    loss = "module" if kw.get("fused_head_chunks") else \
        "sparse_categorical_crossentropy"
    trainer = hvt.Trainer(
        jm, hvt.DistributedOptimizer(jlora.freeze_base(optax.adamw(LR))),
        loss=loss)
    x, y = _data()
    state = trainer.build(x)
    p0 = jax.device_get(state.params)
    zero = trainer.zero_metrics()
    losses = []
    for _ in range(steps):
        state, metrics, _ = trainer._train_step(
            state, trainer._shard((x, y)), np.float32(1.0), zero)
        losses.append(float(metrics["loss"]))
    return p0, jax.device_get(state.params), losses


def _port_fit(p0, steps, **kw):
    tm = lora.LoRAModel(_tlm(**kw), rank=4, alpha=8.0)
    tm.load_state_dict(lora_params_from_flax(p0, tm))
    loss = "module" if kw.get("fused_head_chunks") else \
        "sparse_categorical_crossentropy"
    trainer = ht.Trainer(
        tm, ht.DistributedOptimizer(lora.freeze_base(ht.adamw(LR))),
        loss=loss, device="cpu")
    x, y = _data()
    base0 = {k: v.clone() for k, v in tm.base.state_dict().items()}
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool)
            for n, p in tm.lora.named_parameters()}
    losses = []
    for _ in range(steps):
        losses.append(float(trainer.train_step(x, y)["loss"]))
        for n, p in tm.lora.named_parameters():
            g = p.grad.abs()
            tiny[n] |= (g < TINY * g.max()) & (g > 0)
    return tm, trainer, base0, losses, tiny


def test_freeze_base_adamw_steps_match_jax():
    p0, p1, jlosses = _jax_fit(STEPS)
    tm, trainer, base0, losses, tiny = _port_fit(p0, STEPS)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    assert losses[-1] < losses[0]
    for k, v in tm.base.state_dict().items():
        assert torch.equal(v, base0[k]), k
    assert all(not p.requires_grad for p in tm.base.parameters())
    want = lora_params_from_flax(p1, tm)
    moved = 0
    for n, p in tm.lora.named_parameters():
        w = want["lora." + n]
        assert float(tiny[n].float().mean()) <= 0.02, n
        tol = torch.where(tiny[n], 2 * LR * STEPS, 1e-5)
        err = (p.detach() - w).abs()
        assert bool((err <= tol).all()), (n, float(err.max()))
        moved += int(n.endswith(".b") and float(p.abs().max()) > 0)
    assert moved == len(tm.adapted)
    # JAX's base is frozen too (the same start).
    np.testing.assert_array_equal(
        p1["base"]["Block_0"]["qkv"]["kernel"],
        p0["base"]["Block_0"]["qkv"]["kernel"])
    # The optimizer's state: Adam's two moments for the adapters alone.
    sized = sum(v.numel() for st in trainer.tx.optimizer.state.values()
                for v in st.values() if torch.is_tensor(v) and v.numel() > 1)
    n_lora = sum(p.numel() for p in tm.lora.parameters())
    n_total = sum(p.numel() for p in tm.parameters())
    assert sized == 2 * n_lora and sized < 2 * (n_total - n_lora)
    assert trainer.tx.state_bytes() < 2 * 4 * n_lora + 4 * 64


def test_composes_with_fused_ce_head():
    p0, _, jlosses = _jax_fit(3, fused_head_chunks=4)
    tm, _, base0, losses, _ = _port_fit(p0, 3, fused_head_chunks=4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    for k, v in tm.base.state_dict().items():
        assert torch.equal(v, base0[k]), k


def test_moe_aux_channels_pass_through():
    jm, params, tm = _jax_pair(moe_every=2, n_experts=4)
    x, y = _data()
    # The wrapped forward sows what JAX's wrapper re-sows.
    _, sown = jm.apply({"params": params}, x, train=True,
                       mutable=["losses", "metrics"])
    with torch.no_grad():
        tm(torch.from_numpy(x), train=True, dropout_seed=0)
    jaux = sum(float(v) for v in jax.tree.leaves(sown["losses"]))
    assert float(sum(tm.base.sown_losses())) == pytest.approx(jaux, rel=1e-5)
    trainer = ht.Trainer(
        tm, ht.DistributedOptimizer(lora.freeze_base(ht.adamw(LR))),
        device="cpu")
    trainer.build(x, y)
    assert "moe_drop_rate" in trainer.metric_names
    m = trainer.train_step(x, y)
    assert np.isfinite(float(m["moe_drop_rate"]))


class _Counter(nn.Module):
    """A module whose train-mode forward advances a buffer in place."""

    def __init__(self):
        super().__init__()
        self.mlp_up = nn.Parameter(torch.randn(4, 8) * 0.02)
        self.register_buffer("steps", torch.zeros((), dtype=torch.int64))

    def forward(self, x, train: bool = False, dropout_seed=None):
        if train:
            self.steps.add_(1)
        return (x @ self.mlp_up) @ self.mlp_up.T


def test_buffers_update_through_the_wrapper():
    inner = _Counter()
    model = lora.LoRAModel(inner, rank=2)
    # The generic layout: the parameter is its own kernel.
    assert model.adapted == ("mlp_up",)
    trainer = ht.Trainer(
        model, ht.DistributedOptimizer(lora.freeze_base(ht.adamw(LR))),
        device="cpu")
    x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    y = (np.arange(16) % 4).astype(np.int64)
    for _ in range(3):
        trainer.train_step(x, y)
    assert int(inner.steps) == 3
    assert int(model.state_dict()["base.steps"]) == 3


def _axes(spec):
    return {ax for ax in spec.values()}


def test_param_specs_the_four_jax_cases():
    tm_ = tmesh.build_mesh(tmesh.MeshSpec(data=4, model=2), n_ranks=8, rank=0)
    # 1. Adapters skip the TP rule (rank 3 does not divide model 2); the
    #    base kernels keep theirs — as JAX places each.
    jm = jlora.LoRAModel(inner=jtr.TransformerLM(**CFG), rank=3)
    x, _ = _data()
    jparams = jm.init(jax.random.PRNGKey(0), x)["params"]
    jspecs = jtr.param_specs(jparams, jmesh.build_mesh(
        jmesh.MeshSpec(data=4, model=2)))
    model = lora.LoRAModel(_tlm(), rank=3)
    specs = ttr.param_specs(model, tm_)
    kernels = lm_kernels(model.base)
    for name, spec in specs.items():
        part, rest = name.split(".", 1)
        if part == "lora":
            inner, leaf = rest.rsplit(".", 1)
            path = ("lora",) + kernels[inner].path + (leaf,)
        else:
            path = ("base",) + kernels[rest].path
        js = jspecs
        for key in path:
            js = js[key]
        js = tuple(js)
        want = ({1 if js.index("model") == 0 else 0: "model"}
                if "model" in js else {})
        assert spec == want, (name, spec, js)
    assert any(n.startswith("lora.") for n in specs)
    assert any("model" in _axes(s) for n, s in specs.items()
               if n.startswith("base."))

    # 2. A LoRAModel nested under a wrapper keeps the exemption.
    class Wrap(nn.Module):
        def __init__(self):
            super().__init__()
            self.peft = lora.LoRAModel(_tlm(), rank=3)

    for name, spec in ttr.param_specs(Wrap(), tm_).items():
        if name.split(".")[-1] in ("a", "b"):
            assert "model" not in _axes(spec), (name, spec)

    # 3. A submodule merely named 'lora' keeps its TP placement.
    class Sub(nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp_up = nn.Parameter(torch.zeros(128, 32))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.lora = Sub()

    assert ttr.param_specs(Net(), tm_)["lora.mlp_up"] == {0: "model"}
    jnet_spec = jtr.param_specs(
        {"lora": {"mlp_up": np.zeros((32, 128), np.float32)}},
        jmesh.build_mesh(jmesh.MeshSpec(data=4, model=2)))["lora"]["mlp_up"]
    assert "model" in tuple(jnet_spec)

    # 4. Adapters of expert weights do not meet the expert rule.
    em = tmesh.build_mesh(tmesh.MeshSpec(data=2, expert=2, model=2),
                          n_ranks=8, rank=0)
    moe = lora.LoRAModel(_tlm(moe_every=2, n_experts=4), rank=2,
                         targets=("moe_up", "moe_down", "qkv"))
    specs = ttr.param_specs(moe, em)
    adapters = {n: s for n, s in specs.items() if n.startswith("lora.")}
    assert any(".moe_up." in n for n in adapters)
    assert all(s == {} for s in adapters.values()), adapters
    assert specs["base.blocks.1.moe.moe_up"] == {0: "expert", 2: "model"}


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_wire_with_freeze_base_is_refused(wire):
    model = lora.LoRAModel(_tlm(), rank=2)
    trainer = ht.Trainer(model, ht.DistributedOptimizer(
        lora.freeze_base(ht.adamw(LR)), compression=wire), device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 17"):
        trainer.build()
    with pytest.raises(NotImplementedError, match="ZeRO-1.*item 17"):
        lora.freeze_base(ht.adamw(LR)).check_reduction(False, True)
