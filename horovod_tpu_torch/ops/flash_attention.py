"""Flash attention forward — the wrapper around the hand-written CUDA kernel
(``csrc/flash_fwd.cu``, the port of `horovod_tpu.ops.flash_attention`'s
TPU kernel ``_fwd_kernel``) and its plain PyTorch version.

Device policy: a CPU tensor takes the plain version
(`flash_attention_reference`); a CUDA tensor launches the kernel or raises.
There is no fallback on CUDA — the kernel takes every shape the model
gives it (any Tq/Tk, D ≤ 256, GQA heads read in place).

``launches`` counts kernel launches (a plain module integer), so a run can
show that its main path went through the kernel.

Backward (the TPU kernels ``_bwd_dq_kernel``/``_bwd_dkv_kernel``, ROADMAP
queue B items B2/B3) is not ported yet: a CUDA call whose inputs require
grad raises instead of returning a gradient-less result.
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops.attention import check_window, dense_with_lse

# Accepted for signature compatibility with the JAX package; the CUDA
# kernel picks its own tiles.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _check_segment_shapes(q, k, q_segment_ids, kv_segment_ids):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "pass q_segment_ids and kv_segment_ids together (for packed "
            "self-attention they are the same array)"
        )
    if q_segment_ids is None:
        return
    if tuple(q_segment_ids.shape) != (q.shape[0], q.shape[1]):
        raise ValueError(
            f"q_segment_ids must be [B, Tq] = {(q.shape[0], q.shape[1])}, "
            f"got {tuple(q_segment_ids.shape)}"
        )
    if tuple(kv_segment_ids.shape) != (k.shape[0], k.shape[1]):
        raise ValueError(
            f"kv_segment_ids must be [B, Tk] = {(k.shape[0], k.shape[1])}, "
            f"got {tuple(kv_segment_ids.shape)}"
        )


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              q_segment_ids=None, kv_segment_ids=None,
                              window: int | None = None, sinks: int = 0,
                              q_offset: int | None = None):
    """The kernel's function in plain PyTorch: ``(out [B,Tq,H,D],
    lse [B,Tq,H])``. K/V with fewer heads than q (GQA) are repeated
    head-wise (kv head h // rep serves q head h), as the kernel reads
    them."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return dense_with_lse(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, window=window, q_offset=q_offset,
        sinks=sinks,
    )


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("flash_fwd").hvt_flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _launch(q, k, v, q_seg, kv_seg, *, causal, window, sinks, q_offset):
    global launches
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q/k/v on different devices: {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"flash kernel takes one dtype of {sorted(map(str, _DTYPE_CODES))}"
            f" for q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q [B,Tq,H,D] and k/v [B,Tk,Hkv,D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B and D, H a multiple of Hkv)"
        )
    if d > 256:
        raise ValueError(f"flash kernel takes head_dim <= 256, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous last (head) dim")
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if q_seg is not None:
        q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
        kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
    off = tk - tq if q_offset is None else int(q_offset)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            kv_seg.data_ptr() if kv_seg is not None else None,
            out.data_ptr(), lse.data_ptr(),
            b, tq, tk, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window or 0), int(sinks), off,
            d ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def _attention(q, k, v, *, causal, q_segment_ids, kv_segment_ids, window,
               sinks, q_offset):
    _check_segment_shapes(q, k, q_segment_ids, kv_segment_ids)
    check_window(window, causal)
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if window is None:
        sinks = 0  # full causal attention already sees every sink
    kw = dict(causal=causal, window=window, sinks=sinks, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, **kw,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward on CUDA is not ported yet (ROADMAP "
            "queue B, kernels B2/B3) — run under torch.inference_mode() or "
            "torch.no_grad()"
        )
    return _launch(q, k, v, q_segment_ids, kv_segment_ids, **kw)


def flash_attention_with_lse(
    q, k, v, *,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    q_segment_ids=None,
    kv_segment_ids=None,
    window: int | None = None,
    sinks: int = 0,
    q_offset: int | None = None,
):
    """``[B,Tq,H,D]`` attention returning ``(out, lse)`` with ``lse``
    ``[B,Tq,H]`` f32. Masks as in `flash_attention`."""
    del block_q, block_k
    return _attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, window=window, sinks=sinks,
        q_offset=q_offset,
    )


def flash_attention(
    q, k, v, *,
    causal: bool = True,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    q_segment_ids=None,
    kv_segment_ids=None,
    window: int | None = None,
    sinks: int = 0,
    q_offset: int | None = None,
):
    """``[B,Tq,H,D]`` attention (``k``/``v`` ``[B,Tk,Hkv,D]``, Hkv dividing
    H). Causal masking aligns the sequence ENDS (query i sees keys
    j ≤ i + Tk − Tq, or i + ``q_offset``); ``window`` keeps each query's
    ``window`` most recent keys (requires causal); ``sinks`` re-admits the
    first ``sinks`` keys beyond the band (requires window);
    ``q_segment_ids``/``kv_segment_ids`` ([B,Tq]/[B,Tk] ints) keep only
    equal-id pairs. A fully masked row gives zero output."""
    del block_q, block_k
    out, _ = _attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, window=window, sinks=sinks,
        q_offset=q_offset,
    )
    return out
