"""The dense fallback of the port's `flash_attention` on CUDA (a repair):
where the reference's tiling does not hold for any block choice — a head
dim past 256 (`horovod_tpu.ops.flash_attention.supported`) — it runs dense
attention (``_dense_with_lse``); the port sends the same calls to its
plain path, `flash_attention_reference`, which returns ``(out, lse)`` as
``_dense_with_lse`` does. fp16 and a head dim whose stride is not 1 stay
on the kernels, as they do in the reference (its kernel takes any 2-byte
dtype; its arrays have no strides): fp16 on the CUDA-core route, a
strided operand made contiguous first. The routing predicate reads the
shape only (checked here on meta tensors, which have nothing else); the
CUDA calls themselves run in the `cuda` tests and in ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa


def _meta(b, t, h, d, dtype=torch.bfloat16):
    return torch.empty(b, t, h, d, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,dense", [
    ("bf16_d64", False), ("f32_d256", False), ("bf16_d40", False),
    ("qkv_views", False), ("d320", True), ("fp16", False),
    ("strided_head", False), ("f64", False),
])
def test_routing_predicate(case, dense):
    q = k = v = None
    if case == "bf16_d64":
        q = k = v = _meta(2, 16, 4, 64)
    elif case == "f32_d256":
        q = k = v = _meta(2, 16, 4, 256, torch.float32)
    elif case == "bf16_d40":
        q = k = v = _meta(2, 16, 4, 40)
    elif case == "qkv_views":  # TransformerLM's strided views, unit stride
        fused = torch.empty(2, 16, 3 * 4 * 64, dtype=torch.bfloat16,
                            device="meta")
        q, k, v = (x.view(2, 16, 4, 64) for x in fused.split(256, -1))
    elif case == "d320":
        q = k = v = _meta(1, 8, 2, 320)
    elif case == "fp16":
        q = k = v = _meta(1, 8, 2, 64, torch.float16)
    elif case == "strided_head":
        q = _meta(1, 8, 2, 64)
        k = v = _meta(1, 8, 2, 128)[..., ::2]
    elif case == "f64":
        q = k = v = _meta(1, 8, 2, 64, torch.float64)
    assert tfa._takes_dense(q, k, v) is dense


@pytest.mark.parametrize("d,causal,window", [(320, True, None),
                                             (288, False, None),
                                             (320, True, 5)])
def test_dense_path_matches_the_reference_dense_fallback(d, causal, window):
    """At D > 256 the JAX function itself falls back to ``_dense_with_lse``:
    the port's plain path gives its ``(out, lse)`` within 1e-5 (f32)."""
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(2, 24, 2, d).astype(np.float32) for _ in range(3))
    jo, jl = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the routing acts on CUDA tensors")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_calls_take_the_dense_path(cuda):
    """D > 256 on the card: no kernel launch, one dense call, the plain
    path's output, autograd's gradients."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 32, 4, 320, generator=g, device=cuda)
               .bfloat16() for _ in range(3))
    q.requires_grad_()
    before = (tfa.launches, tfa.launches_dense)
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    want_o, want_l = tfa.flash_attention_reference(q, k, v)
    assert (tfa.launches, tfa.launches_dense) == (before[0], before[1] + 1)
    assert torch.equal(out, want_o) and torch.equal(lse, want_l)
    out.float().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


@pytest.mark.cuda
def test_cuda_fp16_and_strided_calls_launch_the_kernels(cuda):
    """fp16 and a head-dim stride of 2 launch B1 (and B2/B3 in the
    backward) on the CUDA-core route, never the dense path; O within two
    fp16 ulps of the plain version (f32 math on the same inputs)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    wide = torch.randn(2, 32, 4, 128, generator=g, device=cuda).bfloat16()
    cases = {
        "fp16": [torch.randn(2, 32, 4, 64, generator=g, device=cuda).half()
                 for _ in range(3)],
        "strided": [wide[..., ::2]] * 3,  # head-dim stride 2
    }
    for name, (q, k, v) in cases.items():
        q = q.clone().requires_grad_()
        before = (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv,
                  tfa.launches_dense)
        out, lse = tfa.flash_attention_with_lse(q, k, v)
        out.float().sum().backward()
        after = (tfa.launches, tfa.launches_bwd_dq, tfa.launches_bwd_dkv,
                 tfa.launches_dense)
        assert tuple(b - a for a, b in zip(before, after)) == (1, 1, 1, 0), \
            name
        want_o, want_l = tfa.flash_attention_reference(
            q.detach(), k.contiguous(), v.contiguous())
        torch.testing.assert_close(out.float(), want_o.float(),
                                   atol=2.5e-3 if name == "fp16" else 2e-2,
                                   rtol=1.25e-3 if name == "fp16" else 1e-2)
        torch.testing.assert_close(lse, want_l, atol=1e-3, rtol=0)
        assert torch.isfinite(q.grad.float()).all(), name
