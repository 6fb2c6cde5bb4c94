"""Flash attention — the wrappers around the hand-written CUDA kernels and
their plain PyTorch versions.

* forward (B1, the port of `horovod_tpu.ops.flash_attention`'s TPU kernel
  ``_fwd_kernel``): ``csrc/flash_fwd_sm90.cu`` on the tensor-core route,
  ``csrc/flash_fwd.cu`` on the CUDA-core route;
* backward, behind a `torch.autograd.Function` around B1: B2
  (``_bwd_dq_kernel``) is ``csrc/flash_bwd_dq_sm90.cu`` on the tensor-core
  route and ``csrc/flash_bwd.cu``'s ``hvt_flash_bwd_dq`` on the CUDA-core
  route; B3 (``_bwd_dkv_kernel``) is ``csrc/flash_bwd_dkv_sm90.cu`` on the
  tensor-core route and ``flash_bwd.cu``'s ``hvt_flash_bwd_dkv`` on the
  CUDA-core route. Gradients flow through ``out`` and ``lse`` (the lse
  cotangent folds into delta = rowsum(dO·O) − dlse, as `_flash_bwd_core`
  does).

Routes (`_route`, by dtype and head dim only, never by failure): bf16 with
D a multiple of 8 up to 128 takes the tensor-core kernels (wgmma, TMA);
f32, fp16, or any other D up to 256, the CUDA-core kernels (bf16 tensor
cores would round f32 operands; the dK/dV accumulators of D > 128 do not
fit one warpgroup's registers).

Device policy: a CPU tensor takes the plain versions
(`flash_attention_reference`, `flash_attention_bwd_reference`). A CUDA
call with a head dim past 256 (`_takes_dense`, the one case the
reference's ``supported`` rejects) goes to the dense plain path, whose
gradients autograd gives — the reference's fallback to dense attention.
Every other CUDA call launches the kernel of its route or raises: a kernel
that fails to build or launch is never replaced, and a dtype other than
f32, bf16 and fp16 raises. q, k or v whose head dim has a stride other
than 1 is made contiguous first (the reference's arrays have no strides).
The kernels take every other shape the model gives them (any Tq/Tk, GQA
heads read in place; the tensor-core route reads strided views through
TMA and raises on a base or stride that is not a multiple of 16 bytes).

``launches``, ``launches_bwd_dq`` and ``launches_bwd_dkv`` count kernel
launches on either route, ``launches_tc``, ``launches_bwd_dq_tc`` and
``launches_bwd_dkv_tc`` the tensor-core route's, ``launches_dense`` the
CUDA calls that took the dense path (plain module integers), so a run can
show that its main path went through the kernels, and which.
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops.attention import (
    _keep_mask, acc, check_window, dense_with_lse,
)

# Accepted for signature compatibility with the JAX package; the CUDA
# kernels pick their own tiles.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024

launches = 0
launches_bwd_dq = 0
launches_bwd_dkv = 0
launches_tc = 0
launches_bwd_dq_tc = 0
launches_bwd_dkv_tc = 0
launches_dense = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns: dict = {}
# Rows of one tensor-core tile (the TMA box's T extent, wgmma's M) and the
# columns of one 128-byte-swizzled chunk (its D extent).
_TC_ROWS, _TC_COLS = 64, 64


def _route(dtype, head_dim: int) -> str:
    """``"tc"`` (tensor-core kernels) for bf16 with D a multiple of 8 up to
    128, else ``"simt"`` (CUDA-core kernels: f32, fp16, other D)."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0 and head_dim <= 128:
        return "tc"
    return "simt"


def _takes_dense(q, k, v) -> bool:
    """Whether a call on the card takes the dense plain path instead of the
    tiled kernels: a head dim past 256, where the reference's
    ``supported`` fails for every block choice. The shape decides, never
    a failed build or launch."""
    del k, v
    return q.shape[-1] > 256


def _tma_desc(t, name: str = "tensor") -> tuple:
    """The tensor-map description of a bf16 ``[B, T, H, D]`` view for the
    tensor-core kernels: ``(pointer, dims D, H, T, B, byte strides of H, T,
    B, box D, H, T, B)``. Dims are ordered so that a contiguous tensor and
    the fused-qkv views of `TransformerLM` have rising strides. TMA needs
    the base and every stride on 16 bytes: anything else raises."""
    b, tlen, h, d = t.shape
    item = t.element_size()
    sb, st, sh, sd = t.stride()
    strides = (sh * item, st * item, sb * item)
    if sd != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if t.data_ptr() % 16 or any(s % 16 for s in strides):
        raise ValueError(
            f"{name}: the tensor-core kernels read through TMA, which needs "
            f"a 16-byte aligned base and strides; got base {t.data_ptr()} "
            f"and byte strides (H, T, B) {strides}"
        )
    return (t.data_ptr(), d, h, tlen, b, *strides, _TC_COLS, 1, _TC_ROWS, 1)


def _desc_arg(t, name):
    return (ctypes.c_longlong * 12)(*_tma_desc(t, name))


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
    """The forward kernel's function in plain PyTorch: ``(out [B,Tq,H,D],
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


def _delta(out, dout, dlse):
    """``rowsum(dO·O) − dlse`` ``[B,Tq,H]`` in the accumulation dtype."""
    delta = (acc(dout) * acc(out)).sum(-1)
    return delta if dlse is None else delta - acc(dlse)


def _probs(q, k, v, dout, lse, delta, *, causal=True, q_segment_ids=None,
           kv_segment_ids=None, window=None, sinks=0, q_offset=None):
    """What both backward kernels recompute, materialised: ``(qf, kf, dof,
    P, dS)`` with K/V repeated to q's heads, P = exp(S − lse) on kept pairs
    (0 elsewhere) and dS = P·(dO·Vᵀ − delta), all f32."""
    tq, h = q.shape[1], q.shape[2]
    tk, rep = k.shape[1], h // k.shape[2]
    qf, kf, vf, dof = acc(q), acc(k), acc(v), acc(dout)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * q.shape[-1] ** -0.5
    keep = _keep_mask(
        tq, tk, causal=causal, offset=tk - tq if q_offset is None else q_offset,
        window=window, sinks=sinks, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, device=q.device,
    )
    p = torch.exp(s - acc(lse).transpose(1, 2)[..., None])
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - acc(delta).transpose(1, 2)[..., None])
    return qf, kf, dof, p, ds


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, **masks):
    """B2's function in plain PyTorch: dQ = dS·K·scale in q's dtype."""
    _, kf, _, _, ds = _probs(q, k, v, dout, lse, delta, **masks)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, **masks):
    """B3's function in plain PyTorch: ``(dK = dSᵀ·Q·scale, dV = Pᵀ·dO)``
    in k's and v's dtypes, summed over each GQA group of q heads."""
    qf, _, dof, p, ds = _probs(q, k, v, dout, lse, delta, **masks)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * q.shape[-1] ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    b, tk, hkv, d = k.shape
    rep = q.shape[2] // hkv
    if rep > 1:
        dk = dk.view(b, tk, hkv, rep, d).sum(3)
        dv = dv.view(b, tk, hkv, rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, dlse=None, *,
                                  causal: bool = True, q_segment_ids=None,
                                  kv_segment_ids=None,
                                  window: int | None = None, sinks: int = 0,
                                  q_offset: int | None = None):
    """The backward kernels' function in plain PyTorch, with P
    materialised: ``(dq, dk, dv)`` in q's, k's and v's dtypes.

    The math of the TPU kernels: delta = rowsum(dO·O) − dlse, P = exp(S −
    lse) on kept pairs (0 elsewhere, so a fully masked row gets zero
    gradient), dS = P·(dO·Vᵀ − delta), dQ = dS·K·scale, dK = dSᵀ·Q·scale,
    dV = Pᵀ·dO, everything in f32 (P is not rounded to the input dtype).
    Under GQA the repeated K/V heads' gradients are summed over each
    group."""
    masks = dict(causal=causal, q_segment_ids=q_segment_ids,
                 kv_segment_ids=kv_segment_ids, window=window, sinks=sinks,
                 q_offset=q_offset)
    delta = _delta(out, dout, dlse)
    return (flash_bwd_dq_reference(q, k, v, dout, lse, delta, **masks),
            *flash_bwd_dkv_reference(q, k, v, dout, lse, delta, **masks))


def _kernel(name):
    """The C entry ``hvt_<name>`` of its library, argtypes declared."""
    if name not in _fns:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        desc = ctypes.POINTER(ctypes.c_longlong)
        if name == "flash_fwd":
            fn = _build.library("flash_fwd").hvt_flash_fwd
            fn.argtypes = ([ptr] * 7 + [i32] * 6 + [i64] * 9 + [i32] * 4
                           + [ctypes.c_float, i32, ptr])
        elif name == "flash_fwd_sm90":
            fn = _build.library(name).hvt_flash_fwd_sm90
            fn.argtypes = ([desc] * 3 + [ptr] * 4 + [i32] * 10
                           + [ctypes.c_float, ptr])
        elif name == "flash_bwd_dq_sm90":
            fn = _build.library(name).hvt_flash_bwd_dq_sm90
            fn.argtypes = ([desc] * 4 + [ptr] * 5 + [i32] * 10
                           + [ctypes.c_float, ptr])
        elif name == "flash_bwd_dkv_sm90":
            fn = _build.library(name).hvt_flash_bwd_dkv_sm90
            fn.argtypes = ([desc] * 4 + [ptr] * 5 + [i32] * 11
                           + [ctypes.c_float, ptr])
        else:
            fn = getattr(_build.library("flash_bwd"), f"hvt_{name}")
            n_out = 1 if name == "flash_bwd_dq" else 2
            fn.argtypes = ([ptr] * (8 + n_out) + [i32] * 6 + [i64] * 12
                           + [i32] * 4 + [ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_inputs(q, k, v):
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
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B and D, H a multiple of Hkv)"
        )
    if d > 256:
        raise ValueError(f"flash kernel takes head_dim <= 256, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous last (head) dim")


def _segs(q, q_seg, kv_seg):
    if q_seg is None:
        return None, None
    return (q_seg.to(device=q.device, dtype=torch.int32).contiguous(),
            kv_seg.to(device=q.device, dtype=torch.int32).contiguous())


def _mask_args(q, k, causal, window, sinks, q_offset):
    off = k.shape[1] - q.shape[1] if q_offset is None else int(q_offset)
    return (int(causal), int(window or 0), int(sinks), off,
            q.shape[-1] ** -0.5, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(q, k, v, q_seg, kv_seg, *, causal, window, sinks, q_offset,
            route=None):
    """B1 on a CUDA tensor: the kernel of ``route`` (default `_route`)."""
    global launches, launches_tc
    _check_inputs(q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    tc = (route or _route(q.dtype, d)) == "tc"
    q_seg, kv_seg = _segs(q, q_seg, kv_seg)
    mask = _mask_args(q, k, causal, window, sinks, q_offset)
    with torch.cuda.device(q.device):
        if tc:  # the mask arguments without the dtype code: bf16 only
            name = "flash_fwd_sm90"
            err = _kernel(name)(
                _desc_arg(q, "q"), _desc_arg(k, "k"), _desc_arg(v, "v"),
                _ptr(q_seg), _ptr(kv_seg), out.data_ptr(), lse.data_ptr(),
                b, tq, tk, h, hkv, d, *mask[:5], mask[6],
            )
        else:
            name = "flash_fwd"
            err = _kernel(name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg),
                _ptr(kv_seg), out.data_ptr(), lse.data_ptr(),
                b, tq, tk, h, hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *mask,
            )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches += 1
    launches_tc += tc
    return out, lse


def _bwd_args(q, k, v, dout, lse, delta, q_seg, kv_seg, causal, window,
              sinks, q_offset):
    """The inputs and the shape/stride/mask tail shared by both backward
    entries (validated; dO, lse and delta made contiguous as needed)."""
    _check_inputs(q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    if dout.stride(-1) != 1 or dout.dtype != q.dtype:
        dout = dout.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    q_seg, kv_seg = _segs(q, q_seg, kv_seg)
    # The caller holds these until the launch: `ins` points into them.
    alive = (dout, lse, delta, q_seg, kv_seg)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg))
    tail = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3],
            *_mask_args(q, k, causal, window, sinks, q_offset))
    return alive, ins, tail


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                 q_segment_ids=None, kv_segment_ids=None,
                 window: int | None = None, sinks: int = 0,
                 q_offset: int | None = None):
    """B2: dQ ``[B,Tq,H,D]`` in q's dtype from q, k, v, dO, the forward's
    lse ``[B,Tq,H]`` and delta = rowsum(dO·O) − dlse ``[B,Tq,H]``. The
    kernel of the route on a CUDA tensor, `flash_bwd_dq_reference` on a CPU
    one."""
    masks = dict(causal=causal, window=window, sinks=sinks, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(
            q, k, v, dout, lse, delta, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, **masks)
    return _launch_dq(q, k, v, dout, lse, delta, q_segment_ids,
                      kv_segment_ids, masks)


def _launch_dq(q, k, v, dout, lse, delta, q_seg, kv_seg, masks, route=None):
    """B2 on a CUDA tensor: the kernel of ``route`` (default `_route`)."""
    global launches_bwd_dq, launches_bwd_dq_tc
    alive, ins, tail = _bwd_args(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                 **masks)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or k.numel() == 0:
        return dq.zero_()
    tc = (route or _route(q.dtype, q.shape[-1])) == "tc"
    with torch.cuda.device(q.device):
        if tc:
            name = "flash_bwd_dq_sm90"
            dout, lse, delta, q_seg, kv_seg = alive
            mask = _mask_args(q, k, **masks)
            b, tq, h, d = q.shape
            err = _kernel(name)(
                _desc_arg(q, "q"), _desc_arg(k, "k"), _desc_arg(v, "v"),
                _desc_arg(dout, "dout"), lse.data_ptr(), delta.data_ptr(),
                _ptr(q_seg), _ptr(kv_seg), dq.data_ptr(), b, tq, k.shape[1],
                h, k.shape[2], d, *mask[:5], mask[6],
            )
        else:
            name = "flash_bwd_dq"
            err = _kernel(name)(*ins, dq.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches_bwd_dq += 1
    launches_bwd_dq_tc += tc
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                  q_segment_ids=None, kv_segment_ids=None,
                  window: int | None = None, sinks: int = 0,
                  q_offset: int | None = None):
    """B3: ``(dK, dV)`` ``[B,Tk,Hkv,D]`` in k's/v's dtypes, inputs as
    `flash_bwd_dq`. The kernel of the route on a CUDA tensor,
    `flash_bwd_dkv_reference` on a CPU one."""
    masks = dict(causal=causal, window=window, sinks=sinks, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(
            q, k, v, dout, lse, delta, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, **masks)
    return _launch_dkv(q, k, v, dout, lse, delta, q_segment_ids,
                       kv_segment_ids, masks)


def _launch_dkv(q, k, v, dout, lse, delta, q_seg, kv_seg, masks, route=None):
    """B3 on a CUDA tensor: the kernel of ``route`` (default `_route`)."""
    global launches_bwd_dkv, launches_bwd_dkv_tc
    alive, ins, tail = _bwd_args(q, k, v, dout, lse, delta, q_seg, kv_seg,
                                 **masks)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0 or q.numel() == 0:
        return dk.zero_(), dv.zero_()
    tc = (route or _route(q.dtype, q.shape[-1])) == "tc"
    with torch.cuda.device(q.device):
        if tc:
            name = "flash_bwd_dkv_sm90"
            dout, lse, delta, q_seg, kv_seg = alive
            stats = _tc_stats(lse, delta)
            mask = _mask_args(q, k, **masks)
            b, tq, h, d = q.shape
            err = _kernel(name)(
                _desc_arg(q, "q"), _desc_arg(k, "k"), _desc_arg(v, "v"),
                _desc_arg(dout, "dout"), stats.data_ptr(), _ptr(q_seg),
                _ptr(kv_seg), dk.data_ptr(), dv.data_ptr(), b, tq, k.shape[1],
                h, k.shape[2], d, stats.shape[-1], *mask[:5], mask[6],
            )
        else:
            name = "flash_bwd_dkv"
            err = _kernel(name)(*ins, dk.data_ptr(), dv.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches_bwd_dkv += 1
    launches_bwd_dkv_tc += tc
    return dk, dv


def _tc_stats(lse, delta):
    """lse and delta ``[B,Tq,H]`` as the tensor-core B3 reads them: one f32
    ``[2, B, H, Tq_pad]`` array, Tq padded with zeros to whole 64-row tiles,
    so that each tile's 64 values are one aligned 256-byte run (one stack,
    plus a pad where Tq is ragged)."""
    tq = lse.shape[1]
    stats = torch.stack((lse.transpose(1, 2), delta.transpose(1, 2)))
    pad = -tq % _TC_ROWS
    return torch.nn.functional.pad(stats, (0, pad)) if pad else stats


def _forward(q, k, v, q_seg, kv_seg, kw):
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_segment_ids=q_seg, kv_segment_ids=kv_seg, **kw)
    return _launch(q, k, v, q_seg, kv_seg, **kw)


class _FlashAttention(torch.autograd.Function):
    """B1 forward, B2 + B3 backward: on a CUDA tensor each launches the
    kernel of `_route` (``csrc/*_sm90.cu`` on the tensor-core route,
    ``flash_fwd.cu``/``flash_bwd.cu`` on the CUDA-core route); their plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, window, sinks,
                q_offset):
        kw = dict(causal=causal, window=window, sinks=sinks,
                  q_offset=q_offset)
        out, lse = _forward(q, k, v, q_seg, kv_seg, kw)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.kw = kw
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        # delta in f32, outside the kernels, as `_flash_bwd_core` does.
        delta = _delta(out, dout, dlse)
        masks = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg, **ctx.kw)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, **masks)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **masks)
        return dq, dk, dv, None, None, None, None, None, None


def _attention(q, k, v, *, causal, q_segment_ids, kv_segment_ids, window,
               sinks, q_offset):
    _check_segment_shapes(q, k, q_segment_ids, kv_segment_ids)
    check_window(window, causal)
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    if window is None:
        sinks = 0  # full causal attention already sees every sink
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    if q.device.type == "cuda" and _takes_dense(q, k, v):
        global launches_dense
        if not (q.dtype == k.dtype == v.dtype):
            raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        launches_dense += 1
        return flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, window=window, sinks=sinks,
            q_offset=q_offset)
    if q.device.type == "cuda":
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                     causal, window, sinks, q_offset)
    kw = dict(causal=causal, window=window, sinks=sinks, q_offset=q_offset)
    return _forward(q, k, v, q_segment_ids, kv_segment_ids, kw)


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
    ``[B,Tq,H]`` f32. Masks as in `flash_attention`; gradients flow
    through both outputs."""
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
    equal-id pairs. A fully masked row gives zero output and zero
    gradient."""
    del block_q, block_k
    out, _ = _attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, window=window, sinks=sinks,
        q_offset=q_offset,
    )
    return out
