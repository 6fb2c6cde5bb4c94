"""horovod_tpu_torch.ops.flash_attention against the JAX package's flash
attention (B1, `_fwd_kernel`, run in the Pallas interpreter on the CPU).

The same numpy inputs go through the JAX kernel and the port's plain
version (what a CPU tensor runs). Shapes are chosen so that the JAX side
really takes the kernel: ``supported(q.shape, *pick_blocks(...))`` holds
for every case (asserted). Tolerance: 1e-5 abs on O and lse in f32 — the
two sides sum the same f32 products in different orders.

The CUDA kernel itself is held against the plain version on the card
(`cuda`-marked tests here, and every mask case of ``chip_smoke.py``).

The port's side runs on one torch thread (`_one_torch_thread`, restored
after each test). In parallel runs of the test suite (processes each
running a JAX-package test file and then this file, six at a time on
eight cores), the causal case failed in 1 of 180 processes with torch's
default thread count and in none of 180 with one thread: 633 elements of
O up to 5.6e-5 apart (an earlier capture: rows 64-127 of one (batch,
head), every other block within 4.2e-7 of a float64 reference). The failure did not
persist: the same call, repeated at once in the failing process at eight
threads and at one, came within 4.1e-7 of the float64 reference. Its cause
is not known. The plain path at the default thread count stays under test
in `test_torch_flash_backward.py` and `test_torch_flash_fallback.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import attention as tatt
from horovod_tpu_torch.ops import flash_attention as tfa

B, T, H, D = 2, 128, 2, 32
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(seed, b=B, tq=T, tk=T, h=H, hkv=H, d=D):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(b, tq, h, d).astype(np.float32),
        rng.randn(b, tk, hkv, d).astype(np.float32),
        rng.randn(b, tk, hkv, d).astype(np.float32),
    )


def _packed(rng, b, t, docs=4):
    ids = np.zeros((b, t), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, t), docs - 1, replace=False))
        ids[i] = np.searchsorted(cuts, np.arange(t), side="right")
    return ids


def _jax_lse(q, k, v, bq, bk, **kw):
    segmented = kw.get("q_segment_ids") is not None
    assert jfa.supported(
        q.shape, *jfa.pick_blocks(
            q.shape[1], q.shape[-1], jnp.float32, bq, bk, t_k=k.shape[1],
            segmented=segmented, windowed=kw.get("window") is not None,
        ), k_shape=k.shape, segmented=segmented,
    ), "the JAX side must run its kernel, not its dense fallback"
    kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
          for n, x in kw.items()}
    out, lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=bq, block_k=bk, **kw,
    )
    return np.asarray(out), np.asarray(lse)


def _torch_lse(q, k, v, **kw):
    kw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
          for n, x in kw.items()}
    out, lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
    )
    return out.numpy(), lse.numpy()


def _case(name):
    rng = np.random.RandomState(7)
    seg = _packed(rng, B, T)
    q_seg = seg.copy()
    q_seg[:, -8:] = 9  # an id no key carries: fully masked rows
    return {
        "causal": (_inputs(0), 32, 32, {"causal": True}),
        "noncausal": (_inputs(1), 32, 32, {"causal": False}),
        "window": (_inputs(2), 32, 32, {"causal": True, "window": 40}),
        "segments": (_inputs(3), 32, 128, {
            "causal": True, "q_segment_ids": seg, "kv_segment_ids": seg}),
        "segments_empty_rows": (_inputs(4), 32, 128, {
            "causal": False, "q_segment_ids": q_seg, "kv_segment_ids": seg}),
        "cross_q_offset": (_inputs(5, tq=64), 32, 32, {
            "causal": True, "q_offset": 40}),
        "empty_rows_q_offset": (_inputs(6), 32, 32, {
            "causal": True, "q_offset": -24, "window": 64}),
    }[name]


@pytest.mark.parametrize("name", [
    "causal", "noncausal", "window", "segments", "segments_empty_rows",
    "cross_q_offset", "empty_rows_q_offset",
])
def test_with_lse_matches_jax_kernel(name):
    (q, k, v), bq, bk, kw = _case(name)
    jo, jl = _jax_lse(q, k, v, bq, bk, **kw)
    to, tl = _torch_lse(q, k, v, **kw)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    if "empty" in name:
        empty = tl <= -1e29
        assert empty.any()
        assert (to[empty] == 0).all()
        assert (tl[empty] == -1e30).all()


def test_window_sinks_matches_jax_kernel():
    """Sinks ride the JAX kernel's pinned sink tile (flash_attention only
    takes them): O against the kernel, lse against `_dense_with_lse`."""
    q, k, v = _inputs(8)
    kw = {"causal": True, "window": 40, "sinks": 4}
    jo = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
        block_k=32, **kw,
    )
    _, jl = jfa._dense_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw
    )
    to, tl = _torch_lse(q, k, v, **kw)
    np.testing.assert_allclose(to, np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=ATOL, rtol=0)
    # The band alone is a different function: sinks really took part.
    no_sinks, _ = _torch_lse(q, k, v, causal=True, window=40)
    assert np.abs(no_sinks - to).max() > 1e-3


def test_gqa_reads_kv_head_h_over_rep():
    """K/V with fewer heads equal the JAX kernel on jnp.repeat'ed heads —
    the model's GQA prefill calls the port without repeating."""
    q, k, v = _inputs(9, h=4, hkv=2)
    jo, jl = _jax_lse(
        q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2), 32, 32,
        causal=True,
    )
    to, tl = _torch_lse(q, k, v, causal=True)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 40])
def test_dense_attention_matches_jax(window):
    from horovod_tpu.ops.attention import dense_attention as jdense

    q, k, v = _inputs(10)
    jo = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=True, window=window)
    to = tatt.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)


def test_flash_attention_returns_out_of_with_lse():
    q, k, v = (torch.from_numpy(x) for x in _inputs(11))
    out = tfa.flash_attention(q, k, v, causal=True, window=30)
    ref, _ = tfa.flash_attention_reference(q, k, v, causal=True, window=30)
    assert torch.equal(out, ref)


def test_cpu_tensor_takes_plain_version_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _inputs(12))
    before = tfa.launches
    tfa.flash_attention(q, k, v)
    assert tfa.launches == before


def test_cpu_path_is_differentiable():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(13))
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_bf16_cpu_matches_jax_dense_reference():
    """bf16 inputs: P is rounded to bf16 before P·V on both sides."""
    q, k, v = _inputs(14)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jo, jl = jfa._dense_with_lse(jq, jk, jv, causal=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    to, tl = tfa.flash_attention_with_lse(tq, tk, tv)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(
        to.float().numpy(), np.asarray(jo, np.float32), atol=1e-2, rtol=1e-2
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["segments_alone", "window_noncausal",
                                 "window_zero", "negative_sinks"])
def test_rejects_bad_arguments(bad):
    q, k, v = (torch.from_numpy(x) for x in _inputs(15))
    seg = torch.zeros((B, T), dtype=torch.int32)
    kw = {
        "segments_alone": {"q_segment_ids": seg},
        "window_noncausal": {"causal": False, "window": 8},
        "window_zero": {"window": 0},
        "negative_sinks": {"window": 8, "sinks": -1},
    }[bad]
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, **kw)


# -- the CUDA kernel (skips without a card) --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernel has no "
                    "CPU mode; chip_smoke.py covers it on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", ["causal", "window", "segments_empty_rows",
                                  "cross_q_offset", "empty_rows_q_offset"])
def test_kernel_matches_plain_version(cuda, name, dtype, atol):
    (q, k, v), _, _, kw = _case(name)
    kw = {n: (torch.from_numpy(x).to(cuda) if isinstance(x, np.ndarray)
              else x) for n, x in kw.items()}
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    before = tfa.launches
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ro, rl = tfa.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ro.float(), atol=atol, rtol=1e-2)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_kernel_refuses_grad_and_bad_layouts(cuda):
    """Inputs that require grad get gradients from the backward kernels
    (B2 and B3 launch once each); bad layouts raise."""
    q, k, v = (torch.randn(1, 64, 2, 32, device=cuda).requires_grad_()
               for _ in range(3))
    before = (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv)
    tfa.flash_attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    q = q.detach()
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        wide = torch.randn(1, 8, 2, 512, device=cuda)
        tfa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError):
        t = torch.randn(1, 64, 32, 2, device=cuda).transpose(2, 3)
        tfa.flash_attention(t, t, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", ["causal", "window", "segments_empty_rows",
                                  "cross_q_offset", "empty_rows_q_offset"])
def test_backward_kernels_match_plain_version(cuda, name, dtype, atol):
    """B2/B3 through autograd on the card against the plain backward on
    the same inputs, with an lse cotangent."""
    (q, k, v), _, _, kw = _case(name)
    kw = {n: (torch.from_numpy(x).to(cuda) if isinstance(x, np.ndarray)
              else x) for n, x in kw.items()}
    q, k, v = (torch.from_numpy(x).to(cuda, dtype).requires_grad_()
               for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.randn_like(out)
    g_lse = torch.randn_like(lse)
    torch.autograd.backward((out, lse), (g, g_lse))
    want = tfa.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g,
        g_lse, **kw)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad.float(), w.float(), atol=atol,
                                   rtol=1e-2)
