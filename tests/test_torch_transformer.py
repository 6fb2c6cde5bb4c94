"""horovod_tpu_torch.models.transformer against the flax `TransformerLM`.

The same flax params (from ``init`` with a fixed key) go through
`params_from_flax` into the port; the same numpy tokens go through both.
Tolerances: logits 1e-4 abs in f32 (8 matmul layers summed in different
orders); caches 1e-5. The JAX side's attention runs its Pallas kernel in
interpret mode, as the JAX package's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, params_to_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 32, 4, 2
LOGITS_ATOL = 1e-4


def _pair(seed=0, **kw):
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32)
    )["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _tokens(seed, b=2, t=32):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(
        np.int32
    )


@pytest.mark.parametrize("kw", [
    {}, {"n_kv_heads": 2}, {"window": 8}, {"window": 8, "attention_sinks": 2},
], ids=["mha", "gqa", "window", "window_sinks"])
def test_logits_match_flax(kw):
    jm, params, tm = _pair(**kw)
    toks = _tokens(1)
    jl = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks)).numpy()
    assert tl.dtype == np.float32 and tl.shape == (2, 32, VOCAB)
    np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_params_round_trip_is_exact(kv):
    _, params, tm = _pair(n_kv_heads=kv)
    host = jax.device_get(params)
    back = params_to_flax(params_from_flax(host), n_heads=HEADS)
    flat_a = jax.tree_util.tree_leaves_with_path(host)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(np.asarray(a), b)
    # and from the torch side
    again = params_from_flax(params_to_flax(tm.state_dict(), n_heads=HEADS))
    for name, t in tm.state_dict().items():
        assert torch.equal(again[name], t), name


def test_qkv_split_is_per_head():
    """flax qkv [d, H, 3D]: q/k/v are [..., :D], [..., D:2D], [..., 2D:] of
    EACH head — the converted projection must reproduce flax's q/k/v."""
    _, params, tm = _pair()
    kern = np.asarray(params["Block_0"]["qkv"]["kernel"])  # [d, H, 3D]
    x = np.random.RandomState(2).randn(3, D_MODEL).astype(np.float32)
    fused = np.einsum("nd,dhe->nhe", x, kern)
    hd = D_MODEL // HEADS
    with torch.no_grad():
        q, k, v = tm.blocks[0]._qkv(torch.from_numpy(x)[None])
    for got, want in zip((q, k, v), np.split(fused, 3, axis=-1)):
        np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5)
        assert got.shape[-1] == hd


def test_rope_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    pos = rng.randint(0, 1000, (2, 5)).astype(np.int32)
    want = np.asarray(jtr._rope(jnp.asarray(x), jnp.asarray(pos)))
    got = ttr.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(dtype):
    import flax.linen as nn

    rng = np.random.RandomState(4)
    x = (3 + 2 * rng.randn(4, 16)).astype(np.float32)
    scale = rng.rand(16).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = nn.LayerNorm(dtype=jdt, use_bias=False).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, jdt)
    )
    ln = ttr.LayerNorm(16, getattr(torch, dtype))
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        got = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _jax_decode(jm, params, length):
    return jm.clone(decode=True, max_decode_len=length)


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2},
                                {"window": 6, "attention_sinks": 2}],
                         ids=["mha", "gqa", "window_sinks"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_decode_matches_flax_cache(kw, per_row):
    """Prefill + teacher-forced steps, scalar and per-row [B] index, with
    steps running PAST the cache end (scalar: writes clamp to L−1; per-row:
    writes are dropped)."""
    jm, params, tm = _pair(**kw)
    length, t0, steps = 12, 8, 6
    toks = _tokens(5, b=3, t=t0 + steps)
    dm = _jax_decode(jm, params, length)
    jl, jv = dm.apply({"params": params}, jnp.asarray(toks[:, :t0]),
                      mutable=["cache"])
    jcache = jv["cache"]
    with torch.no_grad():
        tl, tcache = tm.decode(torch.from_numpy(toks[:, :t0]),
                               max_decode_len=length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL)
    if per_row:
        lengths = np.array([t0, 3, 11], np.int32)
        jcache = {**jcache, "index": jnp.asarray(lengths)}
        tcache = {**tcache, "index": torch.from_numpy(lengths)}
    for s in range(steps):
        col = toks[:, t0 + s: t0 + s + 1]
        jl, jv = dm.apply({"params": params, "cache": jcache},
                          jnp.asarray(col), mutable=["cache"])
        jcache = jv["cache"]
        with torch.no_grad():
            tl, tcache = tm.decode(torch.from_numpy(col), tcache)
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, err_msg=f"step {s}"
        )
    np.testing.assert_array_equal(tcache["index"].numpy(),
                                  np.asarray(jcache["index"]))
    for i in range(LAYERS):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                tcache[f"Block_{i}"][n].numpy(),
                np.asarray(jcache[f"Block_{i}"][n]), atol=1e-5,
            )


def test_chunk_extension_matches_flax():
    """T > 1 on a warm cache (chunk extension) attends over the cache."""
    jm, params, tm = _pair()
    toks = _tokens(6, b=2, t=12)
    dm = _jax_decode(jm, params, 16)
    _, jv = dm.apply({"params": params}, jnp.asarray(toks[:, :8]),
                     mutable=["cache"])
    jl, _ = dm.apply({"params": params, "cache": jv["cache"]},
                     jnp.asarray(toks[:, 8:]), mutable=["cache"])
    with torch.no_grad():
        _, cache = tm.decode(torch.from_numpy(toks[:, :8]), max_decode_len=16)
        tl, _ = tm.decode(torch.from_numpy(toks[:, 8:]), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL)


def test_bf16_compute_keeps_f32_params_and_logits():
    tm = ttr.TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                           n_layers=LAYERS, compute_dtype="bfloat16",
                           device="cpu")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        logits, cache = tm.decode(torch.from_numpy(_tokens(7)),
                                  max_decode_len=40)
    assert logits.dtype == torch.float32
    assert cache["Block_0"]["k"].dtype == torch.bfloat16
    assert tm.config()["compute_dtype"] == "bfloat16"


def test_seeded_init_is_reproducible_and_flax_scaled():
    a = ttr.TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                          n_layers=LAYERS, device="cpu", seed=3)
    b = ttr.TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                          n_layers=LAYERS, device="cpu", seed=3)
    for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.blocks[0].mlp_up.weight.detach()
    assert abs(float(w.std()) - D_MODEL ** -0.5) < 0.05
    assert float(w.abs().max()) <= 2 * D_MODEL ** -0.5 / 0.8796 + 1e-6


@pytest.mark.parametrize("name", ["moe_every", "int8_compute",
                                  "quantized_cache", "sliding_cache"])
def test_unported_options_raise_naming_roadmap(name):
    """Options once refused, ported since, construct and round-trip through
    ``config()``: the decode knobs (their behaviour: tests/test_torch_quant.py
    and tests/test_torch_kv_caches.py) and ``moe_every`` (its behaviour:
    tests/test_torch_moe_lm.py)."""
    kw = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS, n_layers=1,
              device="cpu")
    if name == "moe_every":
        m = ttr.TransformerLM(**kw, moe_every=1, n_experts=4)
        assert m.config()["moe_every"] == 1 and m.blocks[0].use_moe
        back = ttr.TransformerLM(**m.config(), device="cpu")
        assert back.config() == m.config()
        assert sorted(back.state_dict()) == sorted(m.state_dict())
        return
    m = ttr.TransformerLM(**kw, **{name: True})
    assert m.config()[name] is True
    assert ttr.TransformerLM(**m.config(), device="cpu").config() == m.config()


@pytest.mark.parametrize("kw", [{}, {"window": 6, "attention_sinks": 2}],
                         ids=["mha", "window_sinks"])
def test_segment_ids_logits_match_flax(kw):
    """Packed sequences: RoPE positions restart per document and attention
    keeps equal-id pairs (loss and gradients: test_torch_training.py)."""
    jm, params, tm = _pair(**kw)
    toks = _tokens(8)
    seg = np.zeros(toks.shape, np.int32)
    seg[:, 11:] = 1
    seg[1, 25:] = 2
    jl = np.asarray(jm.apply({"params": params}, jnp.asarray(toks),
                             segment_ids=jnp.asarray(seg)))
    with torch.no_grad():
        tl = tm(torch.from_numpy(toks),
                segment_ids=torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)


def test_training_options_in_config():
    tm = ttr.TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                           n_layers=1, device="cpu", remat=True,
                           fused_head_chunks=4)
    cfg = tm.config()
    assert cfg["remat"] is True and cfg["fused_head_chunks"] == 4
    again = ttr.TransformerLM(**cfg, device="cpu")
    assert again.config() == cfg
