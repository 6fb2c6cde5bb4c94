"""horovod_tpu_torch.models.decoding against `horovod_tpu.models.decoding`.

Greedy generation with ragged prompt lengths is held token for token
against the JAX generator (same flax params through `params_from_flax`).
Where the two first differ, the JAX logits at that step must be a near-tie
(top-1/top-2 margin ≤ 1e-3): the two sum the same f32 products in other
orders, which can flip an argmax only there. Sampled runs cannot match
JAX's (torch.Generator and jax.random draw different numbers), so they are
held for shape, eos fill and determinism under one seed; `filter_logits`
is held on identical logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import decoding as tdec
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 32, 4, 2
MARGIN = 1e-3


def _pair(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _ragged(seed, b=4, t0=12):
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, VOCAB, (b, t0)).astype(np.int32)
    lengths = np.array([t0, 1, 7, 3][:b], np.int32)
    return prompt, lengths


@pytest.mark.parametrize("kw", [{}, {"n_kv_heads": 2}, {"window": 5}],
                         ids=["mha", "gqa", "window"])
def test_greedy_ragged_matches_jax(kw):
    jm, params, tm = _pair(**kw)
    prompt, lengths = _ragged(1)
    new = 10
    jfn = jdec.make_generate_fn(jm, max_new_tokens=new, include_prompt=False)
    jt = np.asarray(jfn(params, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        jnp.asarray(lengths)))
    tfn = tdec.make_generate_fn(tm, max_new_tokens=new, include_prompt=False)
    tt = tfn(prompt, None, lengths).numpy()
    assert tt.shape == (4, new) and tt.dtype == np.int32
    for i in range(len(prompt)):
        diff = np.nonzero(jt[i] != tt[i])[0]
        if not len(diff):
            continue
        j = diff[0]
        seq = np.concatenate([prompt[i, : lengths[i]], jt[i, :j]])[None]
        logits = np.asarray(jm.apply({"params": params}, jnp.asarray(seq)))
        top2 = np.sort(logits[0, -1])[-2:]
        assert top2[1] - top2[0] <= MARGIN, (
            f"row {i} differs at step {j} without a near-tie"
        )


def test_each_ragged_row_generates_as_if_alone():
    _, _, tm = _pair()
    prompt, lengths = _ragged(2)
    fn = tdec.make_generate_fn(tm, max_new_tokens=8, include_prompt=False)
    batch = fn(prompt, None, lengths)
    for i, n in enumerate(lengths):
        alone = fn(prompt[i: i + 1, :n])
        assert torch.equal(batch[i], alone[0]), i


@pytest.mark.parametrize("sampling", [
    dict(), dict(temperature=0.9, top_k=8), dict(temperature=1.1, top_p=0.8),
    dict(temperature=2.0, eos_id=3),
], ids=["greedy", "top_k", "top_p", "eos"])
def test_chunked_equals_one_shot(sampling):
    _, _, tm = _pair()
    prompt, lengths = _ragged(3)
    new, chunk = 12, 4
    one = tdec.make_generate_fn(tm, max_new_tokens=new, include_prompt=False,
                                **sampling)
    want = one(prompt, tdec.make_rng(5, "cpu"), lengths)
    start, cont = tdec.make_chunked_generate_fns(
        tm, max_new_tokens=new, chunk=chunk, **sampling
    )
    toks, state = start(prompt, tdec.make_rng(5, "cpu"), lengths)
    parts = [toks]
    for _ in range(new // chunk - 1):
        toks, state = cont(state)
        parts.append(toks)
    got = torch.cat(parts, dim=1)
    assert torch.equal(got, want)
    cache, last, rng, done = state
    assert torch.equal(last, got[:, -1])
    assert cache["index"].shape == (4,) and done.shape == (4,)
    assert isinstance(rng, torch.Generator)


@pytest.mark.parametrize("knobs", [(1.0, 5, 0.0), (0.7, 0, 0.9),
                                   (1.3, 8, 0.5), (0.5, 4, 0.95)])
def test_filter_logits_matches_jax(knobs):
    logits = np.random.RandomState(4).randn(3, VOCAB).astype(np.float32) * 3
    want = np.asarray(jdec.filter_logits(jnp.asarray(logits), *knobs))
    got = tdec.filter_logits(torch.from_numpy(logits), *knobs).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sampled_generation_shape_eos_fill_and_determinism():
    _, _, tm = _pair()
    prompt, lengths = _ragged(5)
    eos = 7
    fn = tdec.make_generate_fn(tm, max_new_tokens=24, temperature=3.0,
                               eos_id=eos, include_prompt=False)
    saw_eos = False
    for seed in range(8):
        a = fn(prompt, tdec.make_rng(seed, "cpu"), lengths)
        assert torch.equal(a, fn(prompt, tdec.make_rng(seed, "cpu"), lengths))
        assert a.shape == (4, 24)
        assert ((a >= 0) & (a < VOCAB)).all()
        for row in a.tolist():
            if eos in row:
                saw_eos = True
                assert all(t == eos for t in row[row.index(eos):])
    assert saw_eos, "no draw reached eos: the fill went unchecked"


def test_generate_includes_prompt_by_default():
    _, _, tm = _pair()
    prompt = torch.from_numpy(_ragged(6)[0])
    out = tdec.generate(tm, prompt, 5)
    assert out.shape == (4, 12 + 5)
    assert torch.equal(out[:, :12], prompt)


@pytest.mark.parametrize("bad", [dict(temperature=-1.0), dict(top_p=1.5),
                                 dict(top_p=-0.1)])
def test_sampling_ranges_rejected(bad):
    with pytest.raises(ValueError):
        tdec.check_sampling_params(bad.get("temperature", 0.0),
                                   bad.get("top_p", 0.0))


def test_bad_generator_arguments_rejected():
    _, _, tm = _pair()
    with pytest.raises(ValueError):
        tdec.make_generate_fn(tm, max_new_tokens=0)
    with pytest.raises(ValueError):
        tdec.make_chunked_generate_fns(tm, max_new_tokens=10, chunk=4)
    with pytest.raises(ValueError):
        tdec.filter_logits(torch.zeros(2, 4), 0.0, 0, 0.0)
    # quantized=True (ported since) decodes from an int8 tree it is given.
    fn = tdec.make_generate_fn(tm, max_new_tokens=4, quantized=True)
    with pytest.raises(ValueError, match="quantize_params"):
        fn(np.zeros((1, 3), np.int32))


@pytest.mark.parametrize("knobs", [{"quantized": True},
                                   {"int8_compute": True},
                                   {"quantized_cache": True}],
                         ids=["quantized", "int8_compute", "quantized_cache"])
def test_int8_knobs_match_jax(knobs):
    """The decode knobs of `make_generate_fn` against JAX's on the same
    weights (the int8 tree converted from the JAX one), ragged, greedy:
    tokens equal (JAX op by op for ``quantized``: under jit its CPU backend
    skips the bf16 rounding of the dequantized weights)."""
    from horovod_tpu.models import quant as jquant
    from horovod_tpu_torch.models.convert import qparams_from_flax

    jm, params, tm = _pair()
    prompt, lengths = _ragged(3)
    jparams, tparams = params, None
    if knobs.get("quantized"):
        jparams = jquant.quantize_params(params, min_size=16)
        tparams = qparams_from_flax(jax.device_get(jparams))
    jfn = jdec.make_generate_fn(jm, max_new_tokens=8, include_prompt=False,
                                **knobs)
    with jax.disable_jit(bool(knobs.get("quantized"))):
        jt = np.asarray(jfn(jparams, jnp.asarray(prompt),
                            jax.random.PRNGKey(0), jnp.asarray(lengths)))
    tfn = tdec.make_generate_fn(tm, max_new_tokens=8, include_prompt=False,
                                **knobs)
    tt = tfn(prompt, None, lengths, params=tparams).numpy()
    np.testing.assert_array_equal(tt, jt)


def test_chunked_int8_cache_equals_one_shot():
    _, _, tm = _pair()
    prompt, lengths = _ragged(4)
    one = tdec.make_generate_fn(tm, max_new_tokens=8, include_prompt=False,
                                quantized_cache=True)(prompt, None, lengths)
    start, cont = tdec.make_chunked_generate_fns(
        tm, max_new_tokens=8, chunk=4, quantized_cache=True)
    a, state = start(prompt, tdec.make_rng(0, "cpu"), lengths)
    assert state[0]["Block_0"]["k"].dtype == torch.int8
    b, _ = cont(state)
    np.testing.assert_array_equal(torch.cat([a, b], 1).numpy(), one.numpy())


def test_steps_run_eagerly_on_the_cpu():
    """On the CPU the step function runs eagerly, counted, no graph."""
    _, _, tm = _pair()
    fn = tdec.make_generate_fn(tm, max_new_tokens=5)
    fn(np.ones((2, 3), np.int32))
    assert not fn.steps.graphs
    assert fn.steps.counts() == {"eager_steps": 4, "captures": 0,
                                 "replays": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured on "
                    "CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "top_p": 0.9}],
                         ids=["greedy", "sampled"])
def test_graph_replays_equal_eager_steps(cuda, sampling):
    """On the card: the captured step replayed equals the same steps run
    eagerly, bit for bit, on the same generator state."""
    tm = ttr.TransformerLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
                           n_layers=LAYERS, dropout=0.0, device=cuda)
    prompt, lengths = _ragged(5)
    fn = tdec.make_generate_fn(tm, max_new_tokens=12, **sampling)
    fn.steps.graphs = False
    eager = fn(prompt, tdec.make_rng(3, cuda), lengths)
    fn.steps.graphs = True
    first = fn(prompt, tdec.make_rng(3, cuda), lengths)
    again = fn(prompt, tdec.make_rng(3, cuda), lengths)
    assert torch.equal(first, eager) and torch.equal(again, eager)
    assert fn.steps.captures == 1 and fn.steps.replays == 10 + 11
