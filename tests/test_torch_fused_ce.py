"""horovod_tpu_torch.ops.fused_ce against `horovod_tpu.ops.fused_ce`.

The same numpy h, w (flax's ``[D, V]`` kernel; the port takes its
transpose, ``LMHead.weight [V, D]``), labels and loss cotangent go through
both; loss, correct, dh and dw are compared.

Tolerances: f32 — 1e-5 on the loss and 1e-6 on dh/dw (one f32 head
product summed in another order). bf16 h — both sides multiply the same
bf16-rounded operands exactly in f32 (the port upcasts them, JAX asks for
f32 output), so the loss agrees to 1e-5; dh is bf16 on both sides and may
differ by one bf16 ulp (rtol 1e-2), and the backward's ``d`` is rounded to
bf16 before the products on both sides, so dw agrees to 1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import fused_ce as jce
from horovod_tpu_torch.ops import fused_ce as tce

B, T, D, V = 2, 24, 16, 37


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, D).astype(np.float32),
            (rng.randn(D, V) / np.sqrt(D)).astype(np.float32),
            rng.randint(0, V, size=(B, T)).astype(np.int32),
            rng.rand(B, T).astype(np.float32))


def _jax(h, w, labels, g, n_chunks, dtype):
    hj = jnp.asarray(h, dtype)
    (loss, correct), vjp = jax.vjp(
        lambda h, w: jce.fused_linear_cross_entropy(
            h, w, jnp.asarray(labels), n_chunks),
        hj, jnp.asarray(w),
    )
    dh, dw = vjp((jnp.asarray(g), jnp.zeros_like(correct)))
    return [np.asarray(x, np.float32) for x in (loss, correct, dh, dw)]


def _torch(h, w, labels, g, n_chunks, dtype):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    loss, correct = tce.fused_linear_cross_entropy(
        ht, wt, torch.from_numpy(labels), n_chunks)
    loss.backward(torch.from_numpy(g))
    assert ht.grad.dtype == dtype and wt.grad.dtype == torch.float32
    return [x.detach().float().numpy()
            for x in (loss, correct, ht.grad, wt.grad.T)]


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_fused_ce(n_chunks, dtype):
    """48 rows in 1, 3 (of 16) and 8 (of 6) chunks; chunk counts that
    leave JAX a padded last chunk are the next test."""
    h, w, labels, g = _data()
    jl, jc, jdh, jdw = _jax(h, w, labels, g, n_chunks, getattr(jnp, dtype))
    tl, tc, tdh, tdw = _torch(h, w, labels, g, n_chunks,
                              getattr(torch, dtype))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tc, jc)
    if dtype == "float32":
        np.testing.assert_allclose(tdh, jdh, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tdw, jdw, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(tdh, jdh, atol=1e-6, rtol=1e-2)
        np.testing.assert_allclose(tdw, jdw, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_chunks", [5, 7])
def test_padded_last_chunk_matches_jax(n_chunks):
    """48 rows in 5 (7) chunks: JAX pads the last chunk with zero rows and
    g = 0; the port leaves them out. Same loss and gradients."""
    h, w, labels, g = _data(1)
    want = _jax(h, w, labels, g, n_chunks, jnp.float32)
    got = _torch(h, w, labels, g, n_chunks, torch.float32)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-6)


def test_chunking_does_not_change_the_result():
    h, w, labels, g = _data(2)
    one = _torch(h, w, labels, g, 1, torch.float32)
    many = _torch(h, w, labels, g, 6, torch.float32)
    for x, y in zip(one, many):
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)


def test_correct_cotangent_is_discarded():
    h, w, labels, _ = _data(3)
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    loss, correct = tce.fused_linear_cross_entropy(
        ht, wt, torch.from_numpy(labels), 2)
    assert not correct.requires_grad
    (a,) = torch.autograd.grad(loss.mean() + 7.0 * correct.sum(), (ht,))
    (b,) = torch.autograd.grad(
        tce.fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels),
                                       2)[0].mean(), (ht,))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_rejects_bad_arguments():
    h, w, labels, _ = _data(4)
    ht, wt = torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T))
    with pytest.raises(ValueError):
        tce.fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels), 0)
    with pytest.raises(ValueError):
        tce.fused_linear_cross_entropy(ht, wt.T, torch.from_numpy(labels))
