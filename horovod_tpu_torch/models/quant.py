"""int8 quantization — port of `horovod_tpu.models.quant`: weight-only
storage for bandwidth-bound decode, and an int8 compute path for the
compute-bound prefill.

**Weight-only storage** (`quantize_params` + ``quantized=True`` in the
decode family): every ≥2-D weight of at least ``min_size`` elements is
stored as int8 with f32 scales over the flax kernel's axis 0, the JAX
package's lattice exactly (the per-leaf grouping is spelled out in
`quantize_params`); each decode step dequantizes inside its (captured)
step, so the weights live on the card as int8.

**int8 compute** (`int8_dot_general` + ``TransformerLM(int8_compute=True)``):
every Dense contraction quantizes its activations per row (amax over the
contracted axis, recomputed each call) and its weights per output
channel, takes an exact int32 product, and rescales by the outer product
of the two scale vectors in f32. On the card the int32 product is
`torch._int_mm` (cuBLASLt's int8 GEMM, as the JAX package's
``lax.dot_general(preferred_element_type=int32)`` is XLA's, outside any
Pallas kernel); on the CPU it is an exact int32 matmul. Inference only:
round() has no gradient, so the model refuses ``int8_compute`` in training.

`_quantize_sym` is the one lattice definition shared by both paths:
symmetric round-half-to-even (``torch.round`` is, as ``jnp.round`` is)
with amax/127 scales, so a dequantized weight requantizes onto the same
lattice.
"""

from __future__ import annotations

import torch
from torch import nn

_Q = "int8_q"

# `torch._int_mm`'s shape rules on the card: more than 16 rows, and
# contraction and output widths that are multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and _Q in x


def _quantize_sym(x, dim):
    """THE int8 lattice: symmetric round-to-nearest-even with amax/127
    scales reduced over ``dim`` (an int or a tuple, kept as size-1 dims).
    Returns ``(int8 values, f32 scale)``."""
    x32 = x.float()
    amax = torch.amax(x32.abs(), dim=dim, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, which rounds differently from the division.
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _grouped(name: str, w, n_heads: int):
    """``w`` (a `TransformerLM` state_dict entry) viewed so that the flax
    kernel's axis 0 is the port tensor's dim 1 — the reduction axis of
    `quantize_params`. flax reduces axis 0 of ``[d_in, ...]`` kernels (per
    output channel: dim 1 of an ``[out, in]`` weight), of the embedding
    ``[vocab, d]`` (per model channel: dim 0 here, so the view is its
    transpose) and of ``attn_out``'s ``[H, D, d]`` (per (head-dim, output)
    pair: ``[d, H*D]`` viewed ``[d, H, D]``)."""
    if name == "embed.weight":
        return w.t()
    if name.endswith("attn_out.weight"):
        return w.view(w.shape[0], n_heads, -1)
    return w


def refuse_moe_int8_compute() -> None:
    """The JAX model's refusal of ``int8_compute`` on an MoE model."""
    raise ValueError(
        "int8_compute does not cover MoE expert matmuls (the "
        "routed einsums bypass the Dense dot_general injection) — "
        "an MoE model would silently keep its dominant FLOPs in "
        "bf16; use a dense model or int8_compute=False"
    )


def quantize_params(model, *, min_size: int = 4096) -> dict:
    """A `TransformerLM`'s parameters as the JAX package's quantized tree:
    ``{name: {"int8_q": int8 [weight's shape], "scale": f32}}`` for every
    ≥2-D weight of at least ``min_size`` elements (symmetric, reduced over
    the flax kernel's axis 0 — see `_grouped`), the other tensors (the
    LayerNorm scales) passed through. `dequantize_params` inverts it."""
    out = {}
    n_heads = model.n_heads
    for name, p in model.state_dict().items():
        p = p.detach()
        if p.dim() < 2 or p.numel() < min_size:
            out[name] = p
            continue
        if name.endswith((".moe_up", ".moe_down")):
            # Expert weights keep flax's layout: reduced over axis 0 (the
            # experts), a [1, in, out] scale.
            q, scale = _quantize_sym(p, dim=0)
            out[name] = {_Q: q, "scale": scale}
            continue
        g = _grouped(name, p, n_heads)
        q, scale = _quantize_sym(g, dim=1)
        if name == "embed.weight":
            q, scale = q.t(), scale.t()  # back to [vocab, d] / [1, d]
        out[name] = {_Q: q.reshape(p.shape).contiguous(),
                     "scale": scale.contiguous()}
    return out


def _dequantize_leaf(leaf, dtype):
    q, scale = leaf[_Q], leaf["scale"]
    if scale.dim() == 3:  # attn_out [d, 1, D] over [d, H, D]; experts
        # [1, in, out] over [E, in, out]
        g = q.view(q.shape[0], -1, scale.shape[-1])
        return (g.to(dtype) * scale.to(dtype)).view(q.shape)
    return q.to(dtype) * scale.to(dtype)


def dequantize_params(qparams: dict, dtype=torch.bfloat16) -> dict:
    """The plain tensors of a `quantize_params` tree, quantized leaves as
    ``dtype`` (``int8 · scale`` in that dtype, as the JAX package's
    ``x.astype(dtype) * scale.astype(dtype)``). The decode family calls it
    inside each step, so the weights on the card stay int8."""
    return {k: _dequantize_leaf(v, dtype) if is_qleaf(v) else v
            for k, v in qparams.items()}


def make_unpack(quantized: bool):
    """The decode family's dequantization hook: `dequantize_params` for a
    quantized tree, the identity for a plain one."""
    if quantized:
        return dequantize_params
    return lambda q: q


def quantized_bytes(qparams: dict) -> int:
    """Total parameter bytes as stored (int8 values, scales, passthrough)."""
    total = 0
    for v in qparams.values():
        for t in (v[_Q], v["scale"]) if is_qleaf(v) else (v,):
            total += t.numel() * t.element_size()
    return total


def _int32_product(xq, wq):
    """Exact ``xq @ wq.T`` in int32 for int8 ``xq [M, K]``, ``wq [N, K]``:
    `torch._int_mm` on the card (rows padded to its minimum of 17; K and
    N must be multiples of 8, else ValueError), an int32 matmul on the
    CPU."""
    m, k = xq.shape
    n = wq.shape[0]
    if not xq.is_cuda:
        return torch.mm(xq.to(torch.int32), wq.to(torch.int32).t())
    if k % _INT_MM_ALIGN or n % _INT_MM_ALIGN:
        raise ValueError(
            f"int8 compute on the card needs the contraction ({k}) and "
            f"output ({n}) widths to be multiples of {_INT_MM_ALIGN} "
            "(torch._int_mm)"
        )
    if m < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - m, k))])
    return torch._int_mm(xq, wq.t())[:m]


def int8_dot_general(x, weight, out_dtype=None):
    """``x @ weight.T`` (a Dense contraction: ``x [..., K]``, ``weight [N,
    K]``, the JAX package's ``int8_dot_general`` with dimension numbers
    ``(((x.ndim-1,), (0,)), ((), ()))`` on the ``[K, N]`` kernel) on int8
    operands: per-row activation scales, per-output-channel weight scales,
    an exact int32 product, the int32 result times the outer product of
    the scales in f32, cast to ``out_dtype`` (default: the operands'
    promoted dtype)."""
    out_dtype = out_dtype or torch.promote_types(x.dtype, weight.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, s_x = _quantize_sym(x2, dim=1)  # [M, 1]
    wq, s_w = _quantize_sym(weight, dim=1)  # [N, 1]
    out = _int32_product(xq, wq)
    scale = s_x * s_w.reshape(1, -1)
    return (out.float() * scale).to(out_dtype).reshape(*lead, -1)


def int8_linear(layer: nn.Linear, x, compute_dtype, out_dtype=None):
    """A bias-free `nn.Linear` through `int8_dot_general`, its operands
    first cast to ``compute_dtype`` (flax's DenseGeneral casts both before
    its dot_general)."""
    return int8_dot_general(
        x.to(compute_dtype), layer.weight.to(compute_dtype),
        out_dtype=out_dtype or compute_dtype,
    )
