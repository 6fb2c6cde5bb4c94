"""The int8 and ring-buffer KV caches of `horovod_tpu_torch.models.transformer`
against the JAX model's (``quantized_cache``, ``sliding_cache``).

Prefill and teacher-forced decode steps run on both sides from the same
weights (`params_from_flax`); every step's logits are held to
``LOGITS_ATOL`` (f32; the sums run in other orders), the int8 cache's
scales to ``SCALE_RTOL`` and its values within one step (at most
``INT8_FLIP_SHARE`` of them), and the ring's slot positions exactly. The ring is also held against the
port's own full-history cache under the same window + sinks mask while
every token still fits in the ring (``RING_ATOL``), and JAX's refusals are
errors here too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 32, 4, 2
LOGITS_ATOL = 2e-5
RING_ATOL = 2e-5
SCALE_RTOL = 2e-6
INT8_FLIP_SHARE = 0.01


def _pair(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _tokens(seed, b, t):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(
        np.int32)


def _run_both(jm, params, tm, toks, t0, length, lengths=None):
    """Prefill on ``toks[:, :t0]`` then one teacher-forced step per
    remaining column, on both sides; yields (step, port logits, JAX
    logits, port cache, JAX cache)."""
    dm = jm.clone(decode=True, max_decode_len=length)
    apply = jax.jit(functools.partial(dm.apply, mutable=["cache"]))
    jl, jv = apply({"params": params}, jnp.asarray(toks[:, :t0]))
    jcache = jv["cache"]
    with torch.no_grad():
        tl, tcache = tm.decode(torch.from_numpy(toks[:, :t0]),
                               max_decode_len=length)
    yield -1, tl, jl, tcache, jcache
    if lengths is not None:
        jcache = {**jcache, "index": jnp.asarray(lengths)}
        tcache = {**tcache, "index": torch.from_numpy(lengths)}
    for s in range(toks.shape[1] - t0):
        col = toks[:, t0 + s: t0 + s + 1]
        jl, jv = apply({"params": params, "cache": jcache},
                       jnp.asarray(col))
        jcache = jv["cache"]
        with torch.no_grad():
            tl, tcache = tm.decode(torch.from_numpy(col), tcache)
        yield s, tl, jl, tcache, jcache


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2},
                                {"window": 5, "attention_sinks": 2}],
                         ids=["mha", "gqa", "window_sinks"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_int8_cache_steps_match_jax(kw, per_row):
    jm, params, tm = _pair(quantized_cache=True, **kw)
    t0, length = 8, 16
    toks = _tokens(1, 3, t0 + 7)
    lengths = np.array([t0, 3, 6], np.int32) if per_row else None
    for s, tl, jl, tc, jc in _run_both(jm, params, tm, toks, t0, length,
                                       lengths):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, err_msg=f"step {s}")
    blk = tc["Block_0"]
    assert blk["k"].dtype == torch.int8 and blk["v"].dtype == torch.int8
    assert blk["k_scale"].shape == (3, length, (kw.get("n_kv_heads")
                                                or HEADS))
    # The first layer's fresh K/V agree with JAX's to a few f32 ulps (LN,
    # projection and RoPE sum in other orders), so its scales agree to
    # SCALE_RTOL and an int8 value may sit one step away where x / scale
    # lies on a rounding boundary.
    jb = jc["Block_0"]
    for n in ("k", "v"):
        diff = np.abs(blk[n].numpy().astype(np.int32)
                      - np.asarray(jb[n]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= INT8_FLIP_SHARE, n
        np.testing.assert_allclose(blk[f"{n}_scale"].numpy(),
                                   np.asarray(jb[f"{n}_scale"]),
                                   rtol=SCALE_RTOL, atol=0)


def test_int8_cache_chunk_extension_per_row_matches_jax():
    """The speculative verify pass on an int8 cache: a chunk of 3 tokens
    at per-row positions, one row running past the cache end (dropped)."""
    jm, params, tm = _pair(quantized_cache=True)
    toks = _tokens(2, 3, 11)
    dm = jm.clone(decode=True, max_decode_len=12)
    _, jv = dm.apply({"params": params}, jnp.asarray(toks[:, :8]),
                     mutable=["cache"])
    with torch.no_grad():
        _, tcache = tm.decode(torch.from_numpy(toks[:, :8]),
                              max_decode_len=12)
    lengths = np.array([8, 2, 10], np.int32)
    jcache = {**jv["cache"], "index": jnp.asarray(lengths)}
    tcache = {**tcache, "index": torch.from_numpy(lengths)}
    jl, _ = dm.apply({"params": params, "cache": jcache},
                     jnp.asarray(toks[:, 8:]), mutable=["cache"])
    with torch.no_grad():
        tl, tcache = tm.decode(torch.from_numpy(toks[:, 8:]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL)
    np.testing.assert_array_equal(tcache["index"].numpy(), lengths + 3)


@pytest.mark.parametrize("sinks,window,t0", [(0, 4, 6), (2, 4, 6),
                                             (3, 5, 2), (2, 8, 12)])
def test_ring_cache_steps_match_jax(sinks, window, t0):
    """Prefill, then steps well past the window: per-step logits and the
    ring's slot positions against JAX's."""
    jm, params, tm = _pair(window=window, attention_sinks=sinks,
                           sliding_cache=True)
    length = t0 + 14
    toks = _tokens(3, 2, length)
    for s, tl, jl, tc, jc in _run_both(jm, params, tm, toks, t0, length):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, err_msg=f"step {s}")
        for i in range(LAYERS):
            np.testing.assert_array_equal(
                tc[f"Block_{i}"]["pos"].numpy(),
                np.asarray(jc[f"Block_{i}"]["pos"]), err_msg=f"step {s}")
    slots = sinks + window
    assert tc["Block_0"]["k"].shape == (2, slots, HEADS, D_MODEL // HEADS)
    assert int(tc["index"]) == length


def test_ring_equals_full_cache_with_the_same_mask():
    """While every position still fits the ring's slots, the ring and the
    full-history cache under the same window + sinks mask give the same
    logits; past the window the ring's bytes stay constant."""
    _, _, tm = _pair(window=6, attention_sinks=2)
    ring = tm.clone(sliding_cache=True)
    toks = torch.from_numpy(_tokens(4, 2, 24))
    with torch.no_grad():
        fl, fc = tm.decode(toks[:, :5], max_decode_len=24)
        rl, rc = ring.decode(toks[:, :5], max_decode_len=24)
        np.testing.assert_allclose(rl.numpy(), fl.numpy(), atol=RING_ATOL)
        nbytes = sum(t.numel() * t.element_size()
                     for k, v in rc.items() if k != "index" for t in v.values())
        for j in range(5, 24):
            fl, fc = tm.decode(toks[:, j:j + 1], fc)
            rl, rc = ring.decode(toks[:, j:j + 1], rc)
            np.testing.assert_allclose(rl.numpy(), fl.numpy(),
                                       atol=RING_ATOL, err_msg=f"pos {j}")
        assert sum(t.numel() * t.element_size() for k, v in rc.items()
                   if k != "index" for t in v.values()) == nbytes


def test_refusals_match_jax():
    _, _, tm = _pair(window=4)
    toks = torch.zeros((2, 6), dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="set window too"):
            tm.clone(window=None, sliding_cache=True).decode(
                toks, max_decode_len=8)
        with pytest.raises(ValueError, match="does not compose"):
            tm.clone(sliding_cache=True, quantized_cache=True).decode(
                toks, max_decode_len=8)
        ring = tm.clone(sliding_cache=True)
        _, cache = ring.decode(toks, max_decode_len=12)
        with pytest.raises(ValueError, match="chunk extension"):
            ring.decode(toks[:, :2], cache)
        per_row = {**cache, "index": torch.tensor([6, 5], dtype=torch.int32)}
        with pytest.raises(ValueError, match="per-row decode indices"):
            ring.decode(toks[:, :1], per_row)
    with pytest.raises(ValueError, match="clone cannot change"):
        tm.clone(d_model=64)
    with pytest.raises(ValueError, match="needs window"):
        tm.clone(window=None, attention_sinks=2)


def test_clone_shares_parameters():
    _, _, tm = _pair()
    c = tm.clone(window=4, attention_sinks=1, quantized_cache=True)
    for (n, a), (_, b) in zip(tm.named_parameters(), c.named_parameters()):
        assert a is b, n
    assert c.blocks[0].window == 4 and tm.blocks[0].window is None
    assert c.config()["quantized_cache"] and not tm.quantized_cache
