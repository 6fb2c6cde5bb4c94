"""horovod_tpu_torch.models.quant against `horovod_tpu.models.quant`.

The same seed-made weights (flax params through `params_from_flax`) are
quantized on both sides: the int8 values must be identical and the scales
within one f32 ulp (both divide an exact amax by 127 and round half to
even). `int8_dot_general` takes an exact int32 product on both sides, so
its f32 rescale is held to one f32 ulp; the int8-compute model's logits
to ``INT8_LOGITS_ATOL`` (the f32 sums around the int8 products run in
other orders). The card's `torch._int_mm` route is a `cuda` case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import quant as jquant
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models import quant as tquant
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax, qparams_from_flax

VOCAB, D_MODEL, HEADS, LAYERS = 64, 64, 4, 2
INT8_LOGITS_ATOL = 1e-5


def _pair(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=HEADS,
               n_layers=LAYERS, dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


@pytest.mark.parametrize("shape,axis", [((7, 33), 0), ((7, 33), 1),
                                        ((3, 5, 16), -1), ((4, 6, 8), (0, 1))])
def test_lattice_matches_jax(shape, axis):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3
    x[0] = 0.0  # an all-zero group takes the 1e-12 floor
    jq, js = jquant._quantize_sym(jnp.asarray(x), axis)
    tq, ts = tquant._quantize_sym(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


def test_round_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = tquant._quantize_sym(x, 1)
    assert float(s) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


@pytest.mark.parametrize("min_size", [4096, 16])
def test_quantize_params_matches_jax(min_size):
    _, params, tm = _pair(n_kv_heads=2)
    jq = jax.device_get(jquant.quantize_params(params, min_size=min_size))
    want = qparams_from_flax(jq)
    got = tquant.quantize_params(tm, min_size=min_size)
    assert set(got) == set(want)
    n_q = 0
    for name, leaf in got.items():
        w = want[name]
        assert tquant.is_qleaf(leaf) == tquant.is_qleaf(w), name
        if not tquant.is_qleaf(leaf):
            assert torch.equal(leaf, w), name
            continue
        n_q += 1
        assert leaf["int8_q"].dtype == torch.int8
        np.testing.assert_array_equal(leaf["int8_q"].numpy(),
                                      w["int8_q"].numpy(), err_msg=name)
        assert leaf["scale"].shape == w["scale"].shape, name
        np.testing.assert_array_max_ulp(leaf["scale"].numpy(),
                                        w["scale"].numpy(), maxulp=1)
    assert n_q >= (5 * LAYERS + 2 if min_size == 16 else 3 * LAYERS + 2)
    # The stored bytes, int8 + scales + passthrough, as the JAX package
    # counts them.
    assert tquant.quantized_bytes(got) == jquant.quantized_bytes(jq)


def test_dequantize_matches_jax():
    _, params, tm = _pair()
    jq = jquant.quantize_params(params, min_size=16)
    want = params_from_flax(jax.device_get(
        jax.tree.map(lambda a: a.astype(jnp.float32),
                     jquant.dequantize_params(jq))))
    got = tquant.dequantize_params(tquant.quantize_params(tm, min_size=16))
    for name, t in got.items():
        np.testing.assert_array_equal(t.float().numpy(), want[name].numpy(),
                                      err_msg=name)
    assert tquant.make_unpack(False)(got) is got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_dot_general_matches_jax(dtype, lead):
    rng = np.random.RandomState(2)
    x = rng.randn(*lead, 48).astype(np.float32)
    w = rng.randn(40, 48).astype(np.float32)  # [N, K]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jquant.int8_dot_general(
        jnp.asarray(x, jd), jnp.asarray(w.T, jd),
        (((len(lead),), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    got = tquant.int8_dot_general(torch.from_numpy(x).to(td),
                                  torch.from_numpy(w).to(td),
                                  out_dtype=torch.float32)
    assert got.shape == (*lead, 40) and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def test_int32_product_is_exact_at_wide_contractions():
    """K = 2048: products reach 2048 · 127² ≈ 3.3e7, past f32's 2^24 — the
    plain version sums in int32, exactly."""
    xq = torch.full((3, 2048), 127, dtype=torch.int8)
    wq = torch.full((8, 2048), -127, dtype=torch.int8)
    wq[0, 0] = -126
    out = tquant._int32_product(xq, wq)
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == -(2048 * 127 * 127) + 127
    assert int(out[0, 1]) == -(2048 * 127 * 127)


def test_int8_compute_logits_match_jax():
    jm, params, tm = _pair(int8_compute=True)
    toks = np.random.RandomState(3).randint(0, VOCAB, (2, 16)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_LOGITS_ATOL)
    with torch.no_grad():
        plain = tm.clone(int8_compute=False)(torch.from_numpy(toks)).numpy()
    assert np.abs(plain - got).max() > 0  # it did take the int8 route


def test_int8_compute_refuses_training():
    _, _, tm = _pair(int8_compute=True)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="inference-only"):
        tm(toks, train=True)
    with pytest.raises(ValueError, match="inference-only"):
        tm(toks, labels=toks)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch._int_mm runs on CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 64])
def test_int_mm_equals_the_exact_product(cuda, m):
    g = torch.Generator().manual_seed(m)
    xq = torch.randint(-127, 128, (m, 512), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (64, 512), generator=g, dtype=torch.int8)
    got = tquant._int32_product(xq.to(cuda), wq.to(cuda)).cpu()
    assert torch.equal(got, tquant._int32_product(xq, wq))


@pytest.mark.cuda
def test_int_mm_refuses_unaligned_widths(cuda):
    xq = torch.zeros((32, 20), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tquant._int32_product(xq, torch.zeros((8, 20), dtype=torch.int8,
                                              device=cuda))
