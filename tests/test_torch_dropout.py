"""The port's dropout (`horovod_tpu_torch.ops.dropout`): the plain version
against an independent 32-bit restatement of the CUDA kernel's arithmetic
(numpy ``uint32`` words, wrapping multiplies, as ``csrc/dropout.cu`` does
them), against flax's ``nn.Dropout`` in what the two share (the kept
share and the kept values), and the kernel itself against the plain
version on the card (the `cuda` test, bit for bit)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import dropout as tdo


def _mix32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x45D9F3B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0x2C1B3C6D)
    return h ^ (h >> np.uint32(16))


def _kernel_keep(n, rate, seed, site):
    """The keep mask as the kernel computes it, in uint32 words."""
    u = np.uint32
    with np.errstate(over="ignore"):
        s = seed & (2**64 - 1)
        kk = _mix32(u(site & 0xFFFFFFFF) ^ u(0x3C6EF372))
        lo = _mix32(u(s & 0xFFFFFFFF) ^ kk)
        hi = _mix32(u((s >> 32) & 0x7FFFFFFF) ^ lo ^ u(0x1B873593)) \
            & u(0x7FFFFFFF)
        a = _mix32(lo ^ u(0x243F6A88))
        b = _mix32(hi ^ a)
        idx = np.arange(n, dtype=np.uint64).astype(np.uint32)
        h = _mix32(_mix32(idx ^ a) ^ b)
    return (h >> u(8)) >= u(int(round(rate * 2**24)))


@pytest.mark.parametrize("rate,seed,site", [
    (0.25, 7, 0), (0.5, 2**62 + 12345, 1), (0.1, 0, 5), (0.75, 2**40 + 3, 17),
])
def test_plain_version_is_the_kernels_32_bit_arithmetic(rate, seed, site):
    n = 4099
    x = torch.ones(n)
    got = tdo.dropout_reference(x, rate, seed, site) != 0
    want = _kernel_keep(n, rate, seed, site)
    np.testing.assert_array_equal(got.numpy(), want)
    # A 0-d int64 tensor seed draws the same mask as the int.
    t = tdo.dropout_reference(x, rate, torch.tensor(seed), site) != 0
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_values_and_share_match_flax_dropout(dtype):
    """flax keeps 1 − rate of the elements, each ``x / (1 − rate)``; the
    port the same share (both within 4 binomial sigmas) and ``x · f32(1 /
    (1 − rate))`` rounded to the dtype, within two ulps of flax's value
    (two roundings against one)."""
    rate, n = 0.25, 20000
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    jy = np.asarray(fnn.Dropout(rate).apply(
        {}, jx, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}
    ).astype(jnp.float32))
    ty = tdo.dropout(torch.from_numpy(x).to(dtype), rate, 3).float().numpy()
    sigma = np.sqrt(n * rate * (1 - rate))
    for y in (jy, ty):
        assert abs((y != 0).sum() - n * (1 - rate)) < 4 * sigma
    tk, jk = ty != 0, jy != 0
    both = tk & jk
    assert both.sum() > n / 2
    ulp = 2.0 ** (-7 if dtype == torch.bfloat16 else -23)
    np.testing.assert_allclose(ty[both], jy[both], rtol=2 * ulp, atol=0)


def test_sites_and_seeds_draw_other_masks_and_the_backward_is_the_mask():
    x = torch.randn(8, 300, dtype=torch.float32, requires_grad=True)
    a = tdo.dropout(x, 0.5, 11, 0)
    assert not torch.equal(a != 0, tdo.dropout(x, 0.5, 11, 1) != 0)
    assert not torch.equal(a != 0, tdo.dropout(x, 0.5, 12, 0) != 0)
    g = torch.randn(8, 300)
    a.backward(g)
    torch.testing.assert_close(x.grad, tdo.dropout(g, 0.5, 11, 0),
                               atol=0, rtol=0)
    assert tdo.dropout(x, 0.0, 1) is x
    assert torch.equal(tdo.dropout(x, 1.0, 1), torch.zeros_like(x))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs on CUDA tensors")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_matches_the_plain_version_bit_for_bit(cuda, dtype):
    x = torch.randn(128, 64, 12, 12, device=cuda).to(dtype)
    x.requires_grad_()
    seed = torch.tensor(2**61 + 99, device=cuda)
    before = tdo.launches
    y = tdo.dropout(x, 0.25, seed, 3)
    y.float().sum().backward()
    assert tdo.launches - before == 2
    want = tdo.dropout_reference(x.detach(), 0.25, seed, 3)
    assert torch.equal(y, want)
    assert torch.equal(tdo.dropout(x.detach(), 0.25, 2**61 + 99, 3), want)
    assert torch.equal(x.grad, tdo.dropout_reference(
        torch.ones_like(x.detach()), 0.25, seed, 3))
