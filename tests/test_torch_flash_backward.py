"""The port's flash-attention backward (B2 `_bwd_dq_kernel`, B3
`_bwd_dkv_kernel`) against the JAX package's Pallas kernels.

The same numpy q, k, v and cotangents go through ``jax.vjp`` of
`horovod_tpu.ops.flash_attention.flash_attention[_with_lse]` (the Pallas
kernels in interpret mode, as the JAX package's own tests run them) and
through the port's autograd Function on CPU tensors — that is, its plain
backward, `flash_attention_bwd_reference`. Every case asserts that the JAX
side takes its kernel, not its dense fallback. Under GQA the JAX side
repeats K/V heads inside the differentiated function, as its model does.

Tolerance: 1e-5 abs on dq/dk/dv in f32 (gradients of magnitude ≤ ~10,
the same f32 products summed in different orders). The CUDA kernels are
held against the plain version on the card (`cuda`-marked tests in
test_torch_flash_attention.py, and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

B, T, H, D = 2, 128, 2, 32
ATOL = 1e-5


def _arrays(seed, b=B, tq=T, tk=T, h=H, hkv=H, d=D):
    rng = np.random.RandomState(seed)
    return {
        "q": rng.randn(b, tq, h, d).astype(np.float32),
        "k": rng.randn(b, tk, hkv, d).astype(np.float32),
        "v": rng.randn(b, tk, hkv, d).astype(np.float32),
        "g": rng.randn(b, tq, h, d).astype(np.float32),
        "g_lse": rng.randn(b, tq, h).astype(np.float32),
    }


def _packed(rng, b, t, docs=4):
    ids = np.zeros((b, t), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, t), docs - 1, replace=False))
        ids[i] = np.searchsorted(cuts, np.arange(t), side="right")
    return ids


def _case(name):
    """(arrays, block_q, block_k, kwargs, with lse cotangent)."""
    rng = np.random.RandomState(7)
    seg = _packed(rng, B, T)
    q_seg = seg.copy()
    q_seg[:, -8:] = 9  # an id no key carries: fully masked rows
    gqa = _arrays(8, h=4, hkv=2)
    return {
        "causal": (_arrays(0), 32, 32, {"causal": True}, False),
        "noncausal": (_arrays(1), 32, 32, {"causal": False}, False),
        "window": (_arrays(2), 32, 32, {"causal": True, "window": 40}, False),
        "segments": (_arrays(3), 32, 128, {
            "causal": True, "q_segment_ids": seg, "kv_segment_ids": seg},
            False),
        "segments_empty_rows": (_arrays(4), 32, 128, {
            "causal": False, "q_segment_ids": q_seg, "kv_segment_ids": seg},
            False),
        "cross_q_offset": (_arrays(5, tq=64), 32, 32, {
            "causal": True, "q_offset": 40}, False),
        "empty_rows_q_offset": (_arrays(6), 32, 32, {
            "causal": True, "q_offset": -24, "window": 64}, False),
        "gqa": (gqa, 32, 32, {"causal": True}, False),
        "lse_cotangent": (_arrays(9), 32, 32, {"causal": True}, True),
        "lse_cotangent_window_gqa": (_arrays(10, h=4, hkv=2), 32, 32, {
            "causal": True, "window": 48}, True),
        "lse_cotangent_empty_rows": (_arrays(11), 32, 128, {
            "causal": False, "q_segment_ids": q_seg, "kv_segment_ids": seg},
            True),
    }[name]


def _assert_kernel_path(q, k, bq, bk, kw):
    segmented = kw.get("q_segment_ids") is not None
    assert jfa.supported(
        q.shape, *jfa.pick_blocks(
            q.shape[1], q.shape[-1], jnp.float32, bq, bk, t_k=k.shape[1],
            segmented=segmented, windowed=kw.get("window") is not None,
        ), k_shape=k.shape, segmented=segmented,
    ), "the JAX side must run its kernel, not its dense fallback"


def _jax_grads(a, bq, bk, kw, with_lse, sinks=0):
    """(dq, dk, dv) of the JAX kernels by jax.vjp; K/V heads repeated
    inside the differentiated function under GQA."""
    q, k, v = (jnp.asarray(a[n]) for n in ("q", "k", "v"))
    rep = q.shape[2] // k.shape[2]
    kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
          for n, x in kw.items()}

    def f(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        if sinks:
            return jfa.flash_attention(q, k, v, block_q=bq, block_k=bk,
                                       sinks=sinks, **kw)
        return jfa.flash_attention_with_lse(q, k, v, block_q=bq,
                                            block_k=bk, **kw)

    _, vjp = jax.vjp(f, q, k, v)
    g = jnp.asarray(a["g"])
    if sinks:
        ct = g
    else:
        g_lse = a["g_lse"] if with_lse else np.zeros_like(a["g_lse"])
        ct = (g, jnp.asarray(g_lse))
    return [np.asarray(x) for x in vjp(ct)]


def _torch_grads(a, kw, with_lse, dtype=torch.float32, sinks=0):
    q, k, v = (torch.from_numpy(a[n]).to(dtype).requires_grad_()
               for n in ("q", "k", "v"))
    kw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
          for n, x in kw.items()}
    out, lse = tfa.flash_attention_with_lse(q, k, v, sinks=sinks, **kw)
    obj = (out * torch.from_numpy(a["g"]).to(dtype)).sum()
    if with_lse:
        obj = obj + (lse * torch.from_numpy(a["g_lse"])).sum()
    obj.backward()
    return [x.grad.numpy() for x in (q, k, v)], lse.detach().numpy()


@pytest.mark.parametrize("name", [
    "causal", "noncausal", "window", "segments", "segments_empty_rows",
    "cross_q_offset", "empty_rows_q_offset", "gqa", "lse_cotangent",
    "lse_cotangent_window_gqa", "lse_cotangent_empty_rows",
])
def test_grads_match_jax_kernels(name):
    a, bq, bk, kw, with_lse = _case(name)
    _assert_kernel_path(a["q"], a["k"], bq, bk, kw)
    want = _jax_grads(a, bq, bk, kw, with_lse)
    got, lse = _torch_grads(a, kw, with_lse)
    for n, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape, n
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=0, err_msg=n)
    if "empty" in name:
        empty = lse <= -1e29
        assert empty.any()
        assert (got[0][empty] == 0).all()  # no visible key: zero dq


def test_window_sinks_grads_match_jax_kernels():
    """Sinks ride the JAX kernels' pinned sink tile and the separate
    sink-only dK/dV pass; the port computes the same pairs once."""
    a = _arrays(12)
    kw = {"causal": True, "window": 40}
    _assert_kernel_path(a["q"], a["k"], 32, 32, kw)
    want = _jax_grads(a, 32, 32, kw, False, sinks=4)
    got, _ = _torch_grads(a, kw, False, sinks=4)
    for n, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=0, err_msg=n)
    # The band alone is a different function: the sinks took part.
    no_sinks, _ = _torch_grads(a, kw, False)
    assert np.abs(no_sinks[1] - got[1]).max() > 1e-3


@pytest.mark.parametrize("kw", [
    {"causal": True},
    {"causal": False},
    {"causal": True, "window": 3, "sinks": 1},
    {"causal": True, "q_offset": -2},
    "segments",
], ids=["causal", "noncausal", "window_sinks", "empty_rows", "segments"])
def test_gradcheck_float64(kw):
    """The Function's backward (the plain backward on the CPU) against
    finite differences of its forward, through out and lse, with GQA."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 6, 2, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 6, 1, 4, generator=g, dtype=torch.float64)
    v = torch.randn(1, 6, 1, 4, generator=g, dtype=torch.float64)
    if kw == "segments":
        ids = torch.tensor([[0, 0, 1, 1, 1, 2]])
        kw = {"q_segment_ids": ids.clone(), "kv_segment_ids": ids}
        kw["q_segment_ids"][0, -1] = 5  # a fully masked row

    def f(q, k, v):
        out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
        # a fully masked row's lse is the constant -1e30: keep it out of
        # the finite differences' scale
        return out, torch.where(lse > -1e29, lse, torch.zeros_like(lse))

    inputs = tuple(x.requires_grad_() for x in (q, k, v))
    assert torch.autograd.gradcheck(f, inputs)


def test_backward_reference_matches_autograd_of_plain_forward():
    """`flash_attention_bwd_reference` equals autograd through the plain
    forward's materialised softmax (a third derivation of the same
    gradients), bf16 inputs included."""
    a = _arrays(13, h=4, hkv=2)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.from_numpy(a[n]).to(dtype).requires_grad_()
                   for n in ("q", "k", "v"))
        g = torch.from_numpy(a["g"]).to(dtype)
        g_lse = torch.from_numpy(a["g_lse"])
        out, lse = tfa.flash_attention_reference(q, k, v, window=30)
        want = torch.autograd.grad(
            (out.float() * g.float()).sum() + (lse * g_lse).sum(), (q, k, v))
        got = tfa.flash_attention_bwd_reference(
            q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(),
            g, g_lse, window=30)
        for x, y in zip(got, want):
            assert x.dtype == dtype
            torch.testing.assert_close(x.float(), y.float(), atol=atol,
                                       rtol=1e-2)


def test_cpu_backward_launches_no_kernel():
    a = _arrays(14)
    before = (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    _torch_grads(a, {"causal": True}, True)
    assert (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv) == before


def test_only_out_or_only_lse_used():
    """Either output alone carries a gradient (the other's cotangent is
    absent, not materialised)."""
    a = _arrays(15)
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in "qkv")
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    (gq_lse,) = torch.autograd.grad(lse.sum(), (q,), retain_graph=True)
    (gq_out,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(gq_lse).all() and gq_lse.abs().max() > 0
    assert torch.isfinite(gq_out).all() and gq_out.abs().max() > 0
