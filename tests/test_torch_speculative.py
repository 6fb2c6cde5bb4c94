"""horovod_tpu_torch.models.speculative against `horovod_tpu.models.speculative`.

Greedy speculative decoding is exact: its tokens must equal the JAX
speculative decoder's and the port's own plain greedy decode token for
token, and its ``rounds`` and ``tokens`` must equal JAX's — with the
prompt-lookup draft (full and ragged prompts, the int8 weight tree) and
with a draft model. Sampled speculative decoding draws from other bits
than JAX's, so its law is held against the port's sampled `generate`: the
marginal of each generated position over ``N_SAMPLES`` independent rows of
one prompt, on an 8-token vocabulary, by a chi-square test of homogeneity
at ``ALPHA`` per position (Bonferroni over the positions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from horovod_tpu.models import quant as jquant
from horovod_tpu.models import speculative as jspec
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import quant as tquant
from horovod_tpu_torch.models import speculative as tspec
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 32, 4, 2
N_SAMPLES, ALPHA = 4000, 1e-3


def _pair(seed=0, vocab=VOCAB, **kw):
    cfg = dict(vocab_size=vocab, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _prompt(seed=0, b=3):
    """Self-repeating prompts, where prompt lookup drafts well."""
    base = np.random.RandomState(seed).randint(0, VOCAB, (b, 5))
    return np.concatenate([base, base, base[:, :2]], 1).astype(np.int32)


@pytest.mark.parametrize("gamma", [2, 4, 8])
def test_greedy_equals_jax_and_plain_greedy(gamma):
    jm, params, tm = _pair()
    prompt = _prompt()
    new = 14
    jfn = jspec.make_speculative_fn(jm, max_new_tokens=new, gamma=gamma,
                                    return_stats=True)
    jout, jstats = jfn(params, jnp.asarray(prompt))
    tfn = tspec.make_speculative_fn(tm, max_new_tokens=new, gamma=gamma,
                                    return_stats=True)
    tout, tstats = tfn(prompt)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert int(tstats["rounds"]) == int(jstats["rounds"])
    assert int(tstats["tokens"]) == int(jstats["tokens"]) == 3 * new
    plain = tdec.make_generate_fn(tm, max_new_tokens=new)(prompt)
    np.testing.assert_array_equal(tout.numpy(), plain.numpy())


def test_ragged_prompts_match_jax():
    jm, params, tm = _pair()
    prompt = _prompt(1, b=4)
    lengths = np.array([12, 4, 9, 1], np.int32)
    kw = dict(max_new_tokens=10, gamma=4, include_prompt=False,
              return_stats=True)
    jout, jstats = jspec.make_speculative_fn(jm, **kw)(
        params, jnp.asarray(prompt), None, jnp.asarray(lengths))
    tout, tstats = tspec.make_speculative_fn(tm, **kw)(prompt, None, lengths)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert int(tstats["rounds"]) == int(jstats["rounds"])
    plain = tdec.make_generate_fn(tm, max_new_tokens=10,
                                  include_prompt=False)(prompt, None, lengths)
    np.testing.assert_array_equal(tout.numpy(), plain.numpy())


def test_quantized_weights_match_jax():
    """Both sides verify with the same int8 weights (converted from the
    JAX tree); speculative equals the quantized plain greedy."""
    jm, params, tm = _pair()
    jq = jquant.quantize_params(params, min_size=16)
    tq = tquant.quantize_params(tm, min_size=16)
    prompt = _prompt(2)
    kw = dict(max_new_tokens=10, gamma=4, quantized=True)
    # Op by op: under jit, XLA's CPU backend skips the bf16 rounding of the
    # dequantized weights; eager JAX keeps it, as the port does.
    with jax.disable_jit():
        jout = jspec.make_speculative_fn(jm, **kw)(jq, jnp.asarray(prompt))
    tout = tspec.make_speculative_fn(tm, **kw)(prompt, params=tq)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    plain = tdec.make_generate_fn(tm, max_new_tokens=10, quantized=True)(
        prompt, params=tq)
    np.testing.assert_array_equal(tout.numpy(), plain.numpy())


def test_int8_cache_verify_equals_plain_int8_greedy():
    """The verify pass on the int8 cache (per-row chunk writes with their
    scales) against the plain decode on the same cache type."""
    _, _, tm = _pair()
    qm = tm.clone(quantized_cache=True)
    prompt = _prompt(3)
    tout = tspec.make_speculative_fn(qm, max_new_tokens=10, gamma=4)(prompt)
    plain = tdec.make_generate_fn(tm, max_new_tokens=10,
                                  quantized_cache=True)(prompt)
    np.testing.assert_array_equal(tout.numpy(), plain.numpy())


def test_draft_model_matches_jax():
    jm, params, tm = _pair()
    jd, dparams, td = _pair(seed=1)
    prompt = _prompt(4)
    jout, jstats = jspec.make_speculative_fn(
        jm, max_new_tokens=10, gamma=4, draft_model=jd, draft_params=dparams,
        return_stats=True)(params, jnp.asarray(prompt))
    tout, tstats = tspec.make_speculative_fn(
        tm, max_new_tokens=10, gamma=4, draft_model=td,
        return_stats=True)(prompt)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert int(tstats["rounds"]) == int(jstats["rounds"])
    # The target as its own draft accepts every proposal: γ tokens a round.
    _, self_stats = tspec.make_speculative_fn(
        tm, max_new_tokens=12, gamma=4, draft_model=tm,
        return_stats=True)(prompt)
    assert int(self_stats["rounds"]) == 3


def test_ngram_draft_matches_jax():
    buf = np.array([[1, 2, 3, 4, 1, 2, 3, 0, 0, 0],
                    [5, 5, 5, 5, 5, 5, 0, 0, 0, 0],
                    [7, 8, 9, 1, 2, 3, 0, 0, 0, 0]], np.int32)
    cur = np.array([7, 6, 6], np.int32)
    want = jspec.ngram_draft_fn(ngram=3)(jnp.asarray(buf), jnp.asarray(cur), 3)
    got = tspec.ngram_draft_fn(ngram=3)(torch.from_numpy(buf),
                                        torch.from_numpy(cur), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refusals_match_jax():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="gamma"):
        tspec.make_speculative_fn(tm, max_new_tokens=4, gamma=1)
    with pytest.raises(ValueError, match="not both"):
        tspec.make_speculative_fn(tm, max_new_tokens=4, draft_model=tm,
                                  draft_fn=tspec.ngram_draft_fn())
    fn = tspec.make_speculative_fn(tm, max_new_tokens=4, temperature=0.7)
    with pytest.raises(ValueError, match="needs an rng"):
        fn(_prompt())
    fn = tspec.make_speculative_fn(tm, max_new_tokens=4, draft_model=tm)
    with pytest.raises(ValueError, match="ragged"):
        fn(_prompt(), None, np.array([3, 4, 5], np.int32))


def test_sampled_law_equals_sampled_generate():
    """Rejection sampling commits exactly the target's filtered law at
    every position: chi-square homogeneity of each position's marginal
    between the speculative and the plain sampled decoders."""
    _, _, tm = _pair(seed=2, vocab=8)
    base = np.array([[1, 2, 3, 4, 1, 2, 3]], np.int32)
    prompt = np.repeat(base, N_SAMPLES, axis=0)
    new = 5
    knobs = dict(temperature=1.0, top_p=0.95)
    spec = tspec.make_speculative_fn(tm, max_new_tokens=new, gamma=3,
                                     include_prompt=False, **knobs)
    a = spec(prompt, tdec.make_rng(11, "cpu")).numpy()
    plain = tdec.make_generate_fn(tm, max_new_tokens=new,
                                  include_prompt=False, **knobs)
    b = plain(prompt, tdec.make_rng(12, "cpu")).numpy()
    for j in range(new):
        table = np.stack([np.bincount(a[:, j], minlength=8),
                          np.bincount(b[:, j], minlength=8)])
        table = table[:, table.sum(0) > 0]
        p = stats.chi2_contingency(table)[1]
        assert p > ALPHA / new, (j, table)
    # Another seed draws other tokens (the draws are keyed by the seed).
    c = spec(prompt[:64], tdec.make_rng(13, "cpu")).numpy()
    assert not np.array_equal(c, a[:64])


def test_sampled_is_a_function_of_the_rng_state():
    """The same rng state gives the same tokens: every draw is keyed by the
    seed drawn from it and the (position, token, row) it decides."""
    _, _, tm = _pair(seed=2, vocab=8)
    spec = tspec.make_speculative_fn(tm, max_new_tokens=6, gamma=3,
                                     temperature=0.8)
    prompt = np.repeat(np.array([[1, 2, 3, 1, 2]], np.int32), 4, axis=0)
    x = spec(prompt, tdec.make_rng(5, "cpu")).numpy()
    y = spec(prompt, tdec.make_rng(5, "cpu")).numpy()
    np.testing.assert_array_equal(x, y)
