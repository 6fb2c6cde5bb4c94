"""Fused (chunked) linear + softmax cross-entropy — port of
`horovod_tpu.ops.fused_ce`.

``cross_entropy(h @ Wᵀ, labels)`` without the full ``[B·T, vocab]``
logits: the rows are cut into ``n_chunks`` chunks and each chunk's ``[C,
V]`` logits tile is built on the fly — in the forward for the logsumexp,
again in the backward for the softmax — so the extra memory is one tile,
not the logits and their cotangent. The JAX version is a `lax.scan` +
`custom_vjp` with XLA's own matmuls (no Pallas kernel); here it is a Python
loop inside a `torch.autograd.Function` with `torch.matmul` (cuBLAS on the
card).

Weight layout: ``w`` is the port's ``LMHead.weight``, ``[V, D]`` — the
transpose of flax's ``lm_head/kernel`` ``[D, V]``.

Precision: JAX builds each tile from compute-dtype operands with f32
accumulation and output (``preferred_element_type=f32``), and rounds the
backward's ``d = (softmax − onehot)·g`` to the compute dtype before the two
backward products. A bf16 `torch.matmul` would round the tile itself to
bf16, so the operands are rounded to the compute dtype and then upcast to
f32: the products of bf16 values are exact in f32 and only the summation
order differs from JAX's (1e-5 relative on the loss in the tests).
"""

from __future__ import annotations

import torch


def _tile(x, cd):
    """``x`` rounded to the compute dtype, then held in f32."""
    return x.to(cd).float()


def _chunks(n: int, n_chunks: int):
    """Row ranges of ``n_chunks`` chunks of ceil(n / n_chunks) rows (the
    last shorter or empty): JAX's zero-padded rows, which get g = 0 and add
    nothing, are simply not computed."""
    c = -(-n // n_chunks)
    return [(lo, min(n, lo + c)) for lo in range(0, n, c)] if n else []


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, n_chunks):
        cd = h.dtype
        hf = h.reshape(-1, h.shape[-1])
        lf = labels.reshape(-1).long()
        n = hf.shape[0]
        loss = torch.empty(n, dtype=torch.float32, device=h.device)
        correct = torch.empty(n, dtype=torch.float32, device=h.device)
        wt = _tile(w, cd).t()
        for lo, hi in _chunks(n, n_chunks):
            logits = _tile(hf[lo:hi], cd) @ wt  # [C, V] f32
            ll = logits.gather(1, lf[lo:hi, None])[:, 0]
            loss[lo:hi] = torch.logsumexp(logits, dim=-1) - ll
            correct[lo:hi] = (logits.argmax(dim=-1) == lf[lo:hi]).float()
        ctx.save_for_backward(h, w, labels)
        ctx.n_chunks = n_chunks
        loss, correct = loss.view(labels.shape), correct.view(labels.shape)
        ctx.mark_non_differentiable(correct)
        return loss, correct

    @staticmethod
    def backward(ctx, g_loss, _g_correct):
        # `correct` is piecewise constant: its cotangent is discarded.
        h, w, labels = ctx.saved_tensors
        cd = h.dtype
        hf = h.reshape(-1, h.shape[-1])
        lf = labels.reshape(-1).long()
        gf = g_loss.reshape(-1).float()
        wf = _tile(w, cd)  # [V, D]
        dh = torch.empty_like(hf)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for lo, hi in _chunks(hf.shape[0], ctx.n_chunks):
            hc = _tile(hf[lo:hi], cd)
            d = torch.softmax(hc @ wf.t(), dim=-1)  # recomputed [C, V] f32
            # d logits = (softmax − onehot(label)) · g — the CE gradient.
            rows = torch.arange(hi - lo, device=d.device)
            d[rows, lf[lo:hi]] -= 1.0
            d = _tile(d * gf[lo:hi, None], cd)
            dh[lo:hi] = (d @ wf).to(h.dtype)
            dw += d.t() @ hc
        return dh.view(h.shape), dw.to(w.dtype), None, None


def fused_linear_cross_entropy(h, w, labels, n_chunks: int = 8):
    """Per-token CE loss of ``h @ wᵀ`` against integer ``labels``, chunked.

    Args:
      h: ``[..., D]`` final hidden states (f32 or bf16; their dtype is the
        compute dtype of the products).
      w: ``[V, D]`` head weight (`LMHead.weight`).
      labels: integer ``[...]`` matching ``h``'s leading shape.
      n_chunks: row chunks; the extra memory is one ``ceil(rows /
        n_chunks) × V`` f32 tile.

    Returns ``(loss, correct)``, both f32 with ``labels``'s shape: the
    per-token ``lse − logit[label]`` and ``argmax == label``; ``correct``
    carries no gradient.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if h.shape[:-1] != labels.shape or w.shape[-1] != h.shape[-1]:
        raise ValueError(
            f"need h [..., D], w [V, D] and labels [...]: got "
            f"{tuple(h.shape)}, {tuple(w.shape)}, {tuple(labels.shape)}"
        )
    return _FusedLinearCE.apply(h, w, labels, int(n_chunks))
