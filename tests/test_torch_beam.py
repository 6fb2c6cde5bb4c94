"""horovod_tpu_torch.models.beam against `horovod_tpu.models.beam`.

The same weights (`params_from_flax`) searched on both sides: the best
beam's tokens must be equal and its score (f32 accumulated
log-probabilities, GNMT length penalty) within ``SCORE_ATOL`` — with and
without eos, with a length penalty, over the int8 cache and the int8
weight tree (converted from the JAX tree), and over the ring cache (whose
slot positions are reordered with the beams).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.models import beam as jbeam
from horovod_tpu.models import quant as jquant
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import beam as tbeam
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, qparams_from_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 32, 4, 2
SCORE_ATOL = 1e-5


def _pair(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _prompt(seed=0, b=2, t0=7):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t0)).astype(
        np.int32)


@pytest.mark.parametrize("beam,penalty,eos", [
    (1, 0.0, None), (3, 0.0, None), (4, 0.6, None), (3, 0.6, 5), (4, 1.0, 9),
], ids=["w1", "w3", "w4-lp", "w3-lp-eos", "w4-lp1-eos"])
def test_tokens_and_scores_match_jax(beam, penalty, eos):
    jm, params, tm = _pair()
    prompt = _prompt()
    kw = dict(max_new_tokens=7, beam_size=beam, length_penalty=penalty,
              eos_id=eos, return_scores=True)
    jt, js = jbeam.make_beam_search_fn(jm, **kw)(params, jnp.asarray(prompt))
    tt, ts = tbeam.make_beam_search_fn(tm, **kw)(prompt)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL)


def test_width_one_is_greedy():
    _, _, tm = _pair()
    prompt = _prompt(1)
    b = tbeam.make_beam_search_fn(tm, max_new_tokens=8, beam_size=1)(prompt)
    g = tdec.make_generate_fn(tm, max_new_tokens=8)(prompt)
    np.testing.assert_array_equal(b.numpy(), g.numpy())


def test_quantized_weights_match_jax():
    jm, params, tm = _pair()
    jq = jquant.quantize_params(params, min_size=16)
    kw = dict(max_new_tokens=6, beam_size=3, length_penalty=0.6,
              return_scores=True, quantized=True)
    prompt = _prompt(2)
    # Op by op: under jit, XLA's CPU backend skips the bf16 rounding of the
    # dequantized weights (0.013 on these logits); eager JAX keeps it, as
    # the port does.
    with jax.disable_jit():
        jt, js = jbeam.make_beam_search_fn(jm, **kw)(jq, jnp.asarray(prompt))
    tt, ts = tbeam.make_beam_search_fn(tm, **kw)(
        prompt, params=qparams_from_flax(jax.device_get(jq)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL)


@pytest.mark.parametrize("knobs", [
    {"quantized_cache": True},
    {"window": 4, "attention_sinks": 2, "sliding_cache": True},
], ids=["int8_cache", "ring"])
def test_reordered_caches_match_jax(knobs):
    """Every cache tensor follows its beam: the int8 cache's scales and
    the ring's slot positions included."""
    jm, params, tm = _pair(**knobs)
    prompt = _prompt(3)
    kw = dict(max_new_tokens=9, beam_size=3, length_penalty=0.6,
              return_scores=True)
    jt, js = jbeam.make_beam_search_fn(jm, **kw)(params, jnp.asarray(prompt))
    tt, ts = tbeam.make_beam_search_fn(tm, **kw)(prompt)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL)


def test_bad_arguments():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="beam_size"):
        tbeam.make_beam_search_fn(tm, max_new_tokens=4, beam_size=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tbeam.make_beam_search_fn(tm, max_new_tokens=0, beam_size=2)
