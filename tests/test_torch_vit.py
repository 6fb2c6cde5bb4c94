"""The port's `ViT` (2 layers, d 64, 4 heads, patch 4 on 32×32 images)
against the flax `ViT` through `vit_from_flax`: eval-mode logits and the
gradients of a mean cross-entropy at both pools (``mean`` and ``cls``),
f32 and bf16, uint8 input; the converter's round trip; and the two flax
defaults torch does not share, each shown to matter: LayerNorm's ε = 1e-6
(on rows of small variance) and the tanh-approximated gelu.

Tolerances, as a share of each tensor's largest magnitude: f32 logits
1e-5 and gradients 5e-5 (the same f32 products summed in other orders
through two blocks, measured ≤ 1.3e-5); bf16 logits within two bf16 ulps
(2 × 2^-8) of flax's bf16 logits, as in `tests/test_torch_cnn.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.vit import ViT as FlaxViT
from horovod_tpu_torch.models import transformer, vit
from horovod_tpu_torch.models.convert import vit_from_flax, vit_to_flax
from horovod_tpu_torch.models.vit import ViT

B = 8
CFG = dict(patch_size=4, d_model=64, n_heads=4, n_layers=2)
ULP2 = 2 * 2**-8


def _params(pool, seed=0):
    fm = FlaxViT(pool=pool, **CFG)
    p = jax.device_get(fm.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 32, 32, 3)))["params"])
    # LayerNorm scales and biases away from 1 and 0, so their gradients
    # and the ε/bias paths are exercised.
    rng = np.random.RandomState(seed + 3)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if "LayerNorm" in jax.tree_util.keystr(path) else a, p)


def _inputs(kind="float32", seed=1):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    x = u8 if kind == "uint8" else u8.astype(np.float32) / 255.0
    return x, rng.randint(0, 10, B).astype(np.int32)


def _flax(pool, params, x, y, dtype=jnp.float32):
    fm = FlaxViT(pool=pool, compute_dtype=dtype, **CFG)

    def loss_fn(p):
        logits = fm.apply({"params": p}, jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (_, logits), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return np.asarray(logits), vit_from_flax(jax.device_get(g))


def _port(pool, params, dtype=torch.float32):
    tm = ViT(pool=pool, compute_dtype=dtype, device="cpu", **CFG)
    tm.load_state_dict(vit_from_flax(params))
    return tm


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} × {scale}"


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_forward_and_gradients_match_flax_f32(pool):
    params = _params(pool)
    x, y = _inputs()
    want_logits, want_grads = _flax(pool, params, x, y)
    tm = _port(pool, params)
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (B, 10)
    _close(logits.detach().numpy(), want_logits, 1e-5, "logits")
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    names = {n for n, _ in tm.named_parameters()}
    assert names == set(want_grads)
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), want_grads[n].numpy(), 5e-5, n)


@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_bf16_logits_and_uint8_input(pool):
    params = _params(pool, seed=2)
    x8, _ = _inputs("uint8", seed=4)
    fm = FlaxViT(pool=pool, compute_dtype=jnp.bfloat16, **CFG)
    want = np.asarray(jax.jit(lambda p, x: fm.apply({"params": p}, x))(
        params, jnp.asarray(x8)))
    tm = _port(pool, params, torch.bfloat16)
    got = tm(torch.from_numpy(x8))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), want, ULP2, "bf16 logits")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    xf = torch.from_numpy(x8.astype(np.float32) / 255.0)
    assert torch.equal(got, tm(xf))


def test_converter_round_trip_and_layouts():
    for pool in ("mean", "cls"):
        params = _params(pool)
        back = vit_to_flax(vit_from_flax(params), n_heads=CFG["n_heads"])
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            assert a.shape == b.shape and np.array_equal(a, b)
    sd = vit_from_flax(_params("cls"))
    assert sd["blocks.0.qkv.weight"].shape == (3 * 64, 64)
    assert sd["blocks.0.attn_out.weight"].shape == (64, 64)
    assert sd["pos_embed"].shape == (1, 65, 64)
    assert sd["cls"].shape == (1, 1, 64)
    assert "cls" not in vit_from_flax(_params("mean"))
    tm = ViT(pool="cls", device="cpu", **CFG)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}


def test_layernorm_epsilon_is_flax_not_torch():
    """flax's ε = 1e-6 matters on rows of small variance (here std 1e-3,
    variance 1e-6): the port's LayerNorm matches ``nn.LayerNorm()``;
    torch's default ε = 1e-5 does not."""
    import flax.linen as fnn

    rng = np.random.RandomState(7)
    x = (1e-3 * rng.randn(4, 16, 64)).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(64)).astype(np.float32)
    bias = (0.2 * rng.randn(64)).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x)))
    ln = transformer.LayerNorm(64, torch.float32, use_bias=True)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    got = ln(torch.from_numpy(x)).detach().numpy()
    torch_default = F.layer_norm(torch.from_numpy(x), (64,),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(bias)).numpy()
    tol = 1e-5 * float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol
    assert np.abs(torch_default - want).max() > 1000 * tol


def test_gelu_is_the_tanh_approximation():
    """flax's ``nn.gelu`` is the tanh approximation: with torch's exact
    (erf) gelu the logits leave the f32 tolerance."""
    params = _params("mean", seed=5)
    x, y = _inputs(seed=6)
    want, _ = _flax("mean", params, x, y)
    tm = _port("mean", params)
    tol = 1e-5 * float(np.abs(want).max())
    base = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(base - want).max() <= tol
    real_gelu = F.gelu
    vit.F.gelu = lambda h, approximate="none": real_gelu(h)
    try:
        erf = tm(torch.from_numpy(x)).detach().numpy()
    finally:
        vit.F.gelu = real_gelu
    assert np.abs(erf - want).max() > 10 * tol


def test_init_is_seeded_and_flax_shaped():
    a = ViT(device="cpu", seed=3, **CFG).state_dict()
    b = ViT(device="cpu", seed=3, **CFG).state_dict()
    c = ViT(device="cpu", seed=4, **CFG).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.1.mlp_up.weight"],
                           c["blocks.1.mlp_up.weight"])
    for k, t in a.items():
        if k.endswith("bias"):
            assert float(t.abs().max()) == 0.0, k
        elif k.endswith("scale"):
            assert torch.equal(t, torch.ones_like(t)), k
    assert abs(float(a["pos_embed"].std()) - 0.02) < 0.002
    w = a["blocks.0.mlp_down.weight"]  # lecun-normal over fan-in 256
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    with pytest.raises(ValueError, match="pool"):
        ViT(pool="max", device="cpu", **CFG)
