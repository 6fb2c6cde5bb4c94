"""Dense attention — the plain PyTorch references (port of
`horovod_tpu.ops.attention`'s dense path and of `_dense_with_lse` in
`horovod_tpu.ops.flash_attention`).

These materialize the ``[B, H, Tq, Tk]`` scores. They are the numerics
reference the CUDA flash kernel is held against on the card and the path
every CPU tensor takes. Layout ``[batch, seq, heads, head_dim]`` in and
out; statistics in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

# Finite stand-in for -inf: fully-masked rows stay at p == 0 through an
# explicit mask instead of producing NaN from inf - inf.
_BIG_NEG = -1e30


def check_window(window, causal) -> None:
    """Validate a sliding-window request (shared by every attention impl)."""
    if window is None:
        return
    if not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True — the "
            "band is defined as each query's `window` most recent keys"
        )
    if window < 1:
        raise ValueError(f"window must be a positive int, got {window}")


def _keep_mask(tq, tk, *, causal, offset, window, sinks, q_segment_ids,
               kv_segment_ids, device):
    """Boolean keep mask broadcastable to ``[B, H, Tq, Tk]``, or None when
    nothing is masked. Row r sits at key position r + ``offset``."""
    keep = None
    if causal:
        rows = torch.arange(tq, device=device)[:, None] + offset
        cols = torch.arange(tk, device=device)[None, :]
        keep = rows >= cols
        if window is not None:
            band = cols > rows - window
            if sinks:
                band = band | (cols < sinks)
            keep = keep & band
        keep = keep[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
        keep = seg if keep is None else keep & seg
    return keep


def acc(x):
    """``x`` in its accumulation dtype: f32 for f32/bf16 inputs, f64 for
    f64 (so a float64 gradcheck runs the same code in full precision)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k):
    """[B,Tq,H,D] x [B,Tk,H,D] -> [B,H,Tq,Tk] f32 logits, scaled."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bqhd,bkhd->bhqk", acc(q), acc(k)) * scale


def dense_attention(q, k, v, *, causal: bool = True, q_segment_ids=None,
                    kv_segment_ids=None, window: int | None = None,
                    sinks: int = 0):
    """Reference full-materialization attention (end-aligned causal mask,
    optional sliding window + sinks and segment-id equality). Fully
    masked rows give zero output."""
    check_window(window, causal)
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0, got {sinks}")
    s = _scores(q, k)
    tq, tk = s.shape[-2], s.shape[-1]
    keep = _keep_mask(
        tq, tk, causal=causal, offset=tk - tq, window=window, sinks=sinks,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        device=s.device,
    )
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _BIG_NEG))
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def dense_with_lse(q, k, v, *, causal: bool, q_segment_ids=None,
                   kv_segment_ids=None, window=None, q_offset=None, sinks=0):
    """Dense ``(out [B,Tq,H,D], lse [B,Tq,H])`` with the flash kernel's
    conventions: f32 statistics, a fully-masked row gives zero output and
    ``lse == _BIG_NEG``. ``q_offset`` overrides the end-aligned offset
    Tk − Tq (query row i sits at key position i + q_offset)."""
    s = _scores(q, k)
    tq, tk = s.shape[-2], s.shape[-1]
    off = tk - tq if q_offset is None else q_offset
    keep = _keep_mask(
        tq, tk, causal=causal, offset=off, window=window, sinks=sinks,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        device=s.device,
    )
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        # Exact zeros, so a fully-masked row has l == 0, not Tk.
        p = torch.where(keep, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, torch.ones_like(l), l)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", acc((p / l_safe).to(v.dtype)), acc(v)
    ).to(q.dtype)
    lse = torch.where(
        empty, torch.full_like(m, _BIG_NEG), m + torch.log(l_safe)
    )[..., 0]  # [B,H,Tq]
    return out, lse.transpose(1, 2).contiguous()  # [B,Tq,H]
