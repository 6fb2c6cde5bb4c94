"""The port's `MnistCNN` against the flax `MnistCNN` through
`cnn_params_from_flax`: the eval-mode forward and the gradients of a mean
cross-entropy, with f32 and bf16 compute, uint8 and f32 input; the
converter's round trip; and dropout drawn from the seed it is given.

Tolerances: f32 logits within 1e-5 of their largest magnitude, f32
gradients within 2e-5 of each tensor's largest (two convolutions and two
dense layers summed in other orders). bf16: logits and weight gradients
within two bf16 ulps (2 × 2^-8) of the largest. A bias gradient in bf16 is
a sum of bf16 terms over the batch and the image (up to 5408 of them),
which the two sides round in another order: there each side is held to
the f32 gradient of the same parameters, and the port may be no further
from it than flax's own bf16 gradient is, plus two ulps of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.cnn import MnistCNN as FlaxCNN
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.models.convert import (cnn_params_from_flax,
                                              cnn_params_to_flax)

B = 8
TOL = {"float32": (1e-5, 2e-5), "bfloat16": (2 * 2**-8, 2 * 2**-8)}


def _pair(dtype_name, seed=0):
    jdt = getattr(jnp, dtype_name)
    fm = FlaxCNN(compute_dtype=jdt)
    params = fm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 28, 28, 1), jnp.float32))["params"]
    tm = MnistCNN(compute_dtype=getattr(torch, dtype_name), device="cpu")
    tm.load_state_dict(cnn_params_from_flax(jax.device_get(params)))
    return fm, params, tm


def _inputs(kind, seed=1):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (B, 28, 28, 1)).astype(np.uint8)
    x = u8 if kind == "uint8" else (u8.astype(np.float32) / 255.0)
    return x, rng.randint(0, 10, B).astype(np.int32)


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} × {scale}"


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_forward_and_gradients_match_flax(dtype_name, kind):
    fm, params, tm = _pair(dtype_name)
    x, y = _inputs(kind)
    logit_tol, grad_tol = TOL[dtype_name]

    def loss_fn(p):
        logits = fm.apply({"params": p}, jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jl, jlogits), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    logits = tm(torch.from_numpy(x), train=False)
    assert logits.dtype == torch.float32 and logits.shape == (B, 10)
    _close(logits.detach().numpy(), np.asarray(jlogits), logit_tol, "logits")
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(y).long())
    loss.backward()
    want = cnn_params_from_flax(jax.device_get(jg))
    f32 = MnistCNN(device="cpu")
    f32.load_state_dict(tm.state_dict())
    torch.nn.functional.cross_entropy(
        f32(torch.from_numpy(x)), torch.from_numpy(y).long()).backward()
    exact = dict(f32.named_parameters())
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32  # params stay f32
        got, ref = p.grad.numpy(), want[name].numpy()
        if dtype_name == "bfloat16" and name.endswith("bias"):
            f = exact[name].grad.numpy()
            scale = float(np.abs(f).max())
            assert (np.abs(got - f).max()
                    <= np.abs(ref - f).max() + grad_tol * scale), name
        else:
            _close(got, ref, grad_tol, name)


def test_converter_round_trip_and_layouts():
    fm, params, tm = _pair("float32")
    flax_np = jax.device_get(params)
    back = cnn_params_to_flax(tm.state_dict())
    assert set(back) == set(flax_np) == {"Conv_0", "Conv_1", "Dense_0",
                                         "Dense_1"}
    for layer in back:
        for leaf in ("kernel", "bias"):
            assert np.array_equal(back[layer][leaf], flax_np[layer][leaf])
    sd = tm.state_dict()
    assert sd["conv1.weight"].shape == (32, 1, 3, 3)      # OIHW
    assert sd["dense1.weight"].shape == (128, 12 * 12 * 64)
    # The flax model applies the round-tripped params to the same logits.
    x, _ = _inputs("float32", seed=2)
    np.testing.assert_array_equal(
        np.asarray(fm.apply({"params": back}, jnp.asarray(x))),
        np.asarray(fm.apply({"params": params}, jnp.asarray(x))))


def test_init_is_seeded_and_flax_shaped():
    a = MnistCNN(device="cpu", seed=3).state_dict()
    b = MnistCNN(device="cpu", seed=3).state_dict()
    c = MnistCNN(device="cpu", seed=4).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["conv2.weight"], c["conv2.weight"])
    assert float(a["dense1.bias"].abs().max()) == 0.0
    # lecun-normal: std 1/sqrt(fan_in)
    std = float(a["dense1.weight"].std())
    assert abs(std - (12 * 12 * 64) ** -0.5) < 0.1 * (12 * 12 * 64) ** -0.5


def test_dropout_masks_come_from_the_seed_not_the_global_rng():
    tm = MnistCNN(device="cpu", seed=1)
    x, _ = _inputs("uint8", seed=3)
    x = torch.from_numpy(x)
    rng_state = torch.get_rng_state()
    a = tm(x, train=True, dropout_seed=5)
    assert torch.equal(torch.get_rng_state(), rng_state)
    torch.manual_seed(99)  # the global RNG has no say
    b = tm(x, train=True, dropout_seed=5)
    c = tm(x, train=True, dropout_seed=6)
    d = tm(x, train=False)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    with pytest.raises(ValueError, match="dropout_seed"):
        tm(x, train=True)
