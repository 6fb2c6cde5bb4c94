"""Decoder-only transformer LM — port of `horovod_tpu.models.transformer`.

Same architecture and numerics contract as the flax model: pre-LN blocks
(LayerNorm with eps 1e-6, no bias, statistics in f32), split-half RoPE
with f32 angles, tanh-GELU MLP at 4×, an explicit LM head, f32 params with
matmuls in ``compute_dtype`` and f32 logits. Attention over a whole
sequence (training forward and decode prefill) goes through
`ops.flash_attention` — the CUDA kernel on the card, its plain version on
the CPU. Decode steps attend over the KV cache with plain einsums, as the
JAX model does.

Decode mode mirrors ``apply(..., mutable=["cache"])``:
``model.decode(tokens, max_decode_len=L)`` is the prefill that creates the
cache; ``model.decode(tokens, cache)`` is a decode step (T == 1) or chunk
extension (T > 1) against it. The cache is the flax tree's layout, a dict
``{"Block_i": {"k", "v"}, "index"}`` with K/V ``[B, L, H_kv, D]`` in the
compute dtype and ``index`` a scalar or per-row ``[B]`` int32 tensor; the
K/V tensors of a passed cache are written IN PLACE (the JAX version
threads a new tree; here that would copy every layer's cache per token).

Training mirrors ``apply(..., train=True, labels=...)``: ``labels`` returns
``(per_token_loss, per_token_correct)`` through the fused chunked-CE head
(`ops.fused_ce`, ``fused_head_chunks`` row chunks, 0 = one chunk);
``segment_ids`` packs documents (RoPE positions restart per document,
attention stays within it); ``remat`` recomputes each block in the backward
(`torch.utils.checkpoint`). Dropout draws its masks from a seed the caller
passes (``dropout_seed``, the trainer's per-step seed, an int or a 0-d int64
tensor), never from torch's global RNG: block i's two sites are 2i and
2i + 1, and the mask is a hash of (seed, site, element index)
(`ops.dropout`, a CUDA kernel on the card), so a remat recompute redraws
the same mask.

Not in this slice — each raises `NotImplementedError` naming its ROADMAP
item: MoE blocks, int8 compute, the int8 / sliding KV caches and
sequence/tensor parallelism.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops.attention import _BIG_NEG
from horovod_tpu_torch.ops.dropout import dropout
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from horovod_tpu_torch.runtime import resolve_device


def _dtype(x) -> torch.dtype:
    return getattr(torch, x) if isinstance(x, str) else x


def _dtype_name(x: torch.dtype) -> str:
    return str(x).removeprefix("torch.")


def packed_positions(segment_ids):
    """``[B, T]`` within-document positions for contiguous-run packing:
    token i's position is its offset from the start of its run, so RoPE
    treats each packed document as starting at 0."""
    b, t = segment_ids.shape
    ar = torch.arange(t, device=segment_ids.device)
    changed = torch.ones((b, t), dtype=torch.bool, device=segment_ids.device)
    changed[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.cummax(torch.where(changed, ar, 0), dim=1).values
    return ar - starts


def rope(x, positions, *, base: float = 10000.0):
    """Rotary position embedding on ``[B, T, H, D]`` with ``[B, T]`` global
    positions: split-half rotation, f32 angles, result in x's dtype."""
    half = x.shape[-1] // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[:, :, None, None].float() * freqs  # [B,T,1,half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(use_bias=use_bias)``: eps 1e-6, mean and
    variance (E[x²] − E[x]², clipped at 0) in f32, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 eps: float = 1e-6, use_bias: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale.float())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


class Block(nn.Module):
    """Pre-LN attention + MLP block. MHA uses one fused ``qkv`` projection
    (rows ordered q heads, k heads, v heads); GQA (``n_kv_heads`` <
    ``n_heads``) uses ``q_proj`` and ``kv_proj`` (k heads, then v heads)."""

    def __init__(self, d_model: int, n_heads: int, dropout: float,
                 compute_dtype: torch.dtype, *, n_kv_heads: int | None = None,
                 window: int | None = None, attention_sinks: int = 0):
        super().__init__()
        h_kv = n_kv_heads or n_heads
        if n_heads % h_kv != 0:
            raise ValueError(
                f"n_heads ({n_heads}) must be a multiple of n_kv_heads "
                f"({h_kv})"
            )
        if attention_sinks < 0:
            raise ValueError("attention_sinks must be >= 0")
        if attention_sinks and window is None:
            raise ValueError(
                "attention_sinks is the global+local mask's global part — "
                "it needs window set (full causal attention already sees "
                "every sink)"
            )
        self.d_model, self.n_heads, self.h_kv = d_model, n_heads, h_kv
        self.head_dim = d_model // n_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.window, self.sinks = window, attention_sinks
        hd = self.head_dim
        self.ln_attn = LayerNorm(d_model, compute_dtype)
        if h_kv == n_heads:
            self.qkv = nn.Linear(d_model, 3 * n_heads * hd, bias=False)
        else:
            self.q_proj = nn.Linear(d_model, n_heads * hd, bias=False)
            self.kv_proj = nn.Linear(d_model, 2 * h_kv * hd, bias=False)
        self.attn_out = nn.Linear(n_heads * hd, d_model, bias=False)
        self.ln_mlp = LayerNorm(d_model, compute_dtype)
        self.mlp_up = nn.Linear(d_model, 4 * d_model, bias=False)
        self.mlp_down = nn.Linear(4 * d_model, d_model, bias=False)

    def _dense(self, layer: nn.Linear, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), layer.weight.to(cd))

    def _qkv(self, h):
        b, t, _ = h.shape
        hd = self.head_dim
        if self.h_kv == self.n_heads:
            q, k, v = self._dense(self.qkv, h).split(self.n_heads * hd, -1)
            return (x.view(b, t, self.n_heads, hd) for x in (q, k, v))
        q = self._dense(self.q_proj, h).view(b, t, self.n_heads, hd)
        k, v = self._dense(self.kv_proj, h).split(self.h_kv * hd, -1)
        return q, k.view(b, t, self.h_kv, hd), v.view(b, t, self.h_kv, hd)

    def forward(self, x, positions, *, train: bool = False, segment_ids=None,
                dropout_seed: int | None = None, dropout_site: int = 0,
                cache=None, decode_index=None, fresh: bool = False):
        """``cache`` (decode mode): this block's ``{"k", "v"}`` entry,
        written in place at ``decode_index``; ``fresh`` marks the prefill
        that created it. ``dropout_seed`` (train mode with dropout > 0)
        seeds this block's two dropout masks, sites ``dropout_site`` and
        ``dropout_site + 1``."""
        b, t, _ = x.shape
        drop = train and self.dropout > 0.0
        if drop and dropout_seed is None:
            raise ValueError(
                "train=True with dropout > 0 needs dropout_seed (the "
                "trainer passes its per-step seed)"
            )
        q, k, v = self._qkv(self.ln_attn(x))
        q, k = rope(q, positions), rope(k, positions)
        if cache is not None:
            out = self._decode_attention(q, k, v, cache, decode_index, fresh)
        else:
            out = flash_attention(
                q, k, v, causal=True, window=self.window, sinks=self.sinks,
                q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            )
        out = self._dense(self.attn_out, out.reshape(b, t, -1))
        if drop:
            out = dropout(out, self.dropout, dropout_seed, dropout_site)
        x = x + out
        h = self._dense(self.mlp_up, self.ln_mlp(x))
        h = self._dense(self.mlp_down, F.gelu(h, approximate="tanh"))
        if drop:
            h = dropout(h, self.dropout, dropout_seed, dropout_site + 1)
        return x + h

    def _decode_attention(self, q, k, v, cache, idx, fresh):
        b, t, h, d = q.shape
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[1]
        if length < t:
            raise ValueError(
                f"max_decode_len ({length}) < input length ({t})"
            )
        steps = torch.arange(t, dtype=torch.int32, device=q.device)
        if idx.dim() == 0:
            # dynamic_update_slice semantics: the start clamps to L − t.
            pos = (idx.clamp(0, length - t) + steps).long()
            ck.index_copy_(1, pos, k.to(ck.dtype))
            cv.index_copy_(1, pos, v.to(cv.dtype))
        else:
            # Per-row positions; writes past the cache end are DROPPED
            # (JAX mode="drop"). An out-of-range scatter index is a device
            # assert on CUDA, so each position is clamped and masked back
            # to the old value — free/retired serving rows step past the
            # end by design.
            rows = torch.arange(b, device=q.device)
            for j in range(t):
                p = idx + j
                ok = ((p >= 0) & (p < length))[:, None, None]
                pc = p.clamp(0, length - 1).long()
                ck[rows, pc] = torch.where(ok, k[:, j].to(ck.dtype), ck[rows, pc])
                cv[rows, pc] = torch.where(ok, v[:, j].to(cv.dtype), cv[rows, pc])
        if t > 1 and fresh:
            # Prefill: causal attention over the fresh K/V is the full
            # answer (the cache was empty) — the flash kernel's path.
            return flash_attention(
                q, k, v, causal=True, window=self.window, sinks=self.sinks
            )
        # Decode step / chunk extension: the t fresh queries attend over
        # the cache prefix [0 .. idx + row]; grouped einsum so each cached
        # kv head streams once for its `rep` query heads.
        h_kv = ck.shape[2]
        rep = h // h_kv
        q5 = q.reshape(b, t, h_kv, rep, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), ck.float())
        s = s * d ** -0.5
        qpos = (idx.reshape(1, 1) if idx.dim() == 0 else idx[:, None]) \
            + steps[None, :]
        kpos = torch.arange(length, dtype=torch.int32, device=q.device)
        valid = kpos[None, None, :] <= qpos[:, :, None]  # [Bq, t, L]
        if self.window is not None:
            keep = kpos[None, None, :] > qpos[:, :, None] - self.window
            if self.sinks:
                keep = keep | (kpos < self.sinks)[None, None, :]
            valid = valid & keep
        valid = valid[:, None, None, :, :]  # [Bq, 1, 1, t, L]
        s = torch.where(valid, s, torch.full_like(s, _BIG_NEG))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum(
            "bhgqk,bkhd->bqhgd", p.to(cv.dtype).float(), cv.float()
        )
        return out.reshape(b, t, h, d).to(q.dtype)


class LMHead(nn.Module):
    """The LM head: ``[vocab, d_model]`` weight (flax ``lm_head/kernel``
    transposed), a compute-dtype matmul, logits cast to ``logits_dtype``."""

    def __init__(self, d_model: int, vocab_size: int,
                 compute_dtype: torch.dtype, logits_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, d_model))
        self.compute_dtype = compute_dtype
        self.logits_dtype = logits_dtype

    def forward(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd)).to(self.logits_dtype)

    def fused_loss(self, x, labels, n_chunks: int):
        """(per-token loss, per-token correct) without full logits."""
        return fused_linear_cross_entropy(
            x.to(self.compute_dtype), self.weight, labels, max(1, n_chunks)
        )


# Options of the JAX model that this slice does not carry, with the
# ROADMAP item that ports each.
_NOT_PORTED = {
    "moe_every": "queue A item 12 (remaining models: MoE)",
    "int8_compute": "queue A item 10 (decode: models/quant.py)",
    "quantized_cache": "queue A item 10 (decode: int8 KV cache)",
    "sliding_cache": "queue A item 10 (decode: ring-buffer KV cache)",
    "sharding": "queue A item 12 (sequence/tensor parallelism)",
}


class TransformerLM(nn.Module):
    """Causal LM over integer tokens: ``[B, T] -> [B, T, vocab]`` logits.

    Parameters are created on ``device`` (default ``"cuda"``) from a
    seeded CPU generator, so one ``seed`` gives the same weights on every
    device. Hyperparameters keep the JAX model's names; `config()` returns
    them for a bundle to rebuild the model."""

    def __init__(self, vocab_size: int = 256, d_model: int = 256,
                 n_heads: int = 8, n_kv_heads: int | None = None,
                 window: int | None = None, n_layers: int = 4,
                 dropout: float = 0.1, compute_dtype=torch.float32,
                 logits_dtype=torch.float32, attention_sinks: int = 0,
                 remat: bool = False, fused_head_chunks: int = 0, *,
                 device="cuda", seed: int = 0, **not_ported):
        super().__init__()
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"TransformerLM({name}=...) is not ported yet — "
                    f"ROADMAP {_NOT_PORTED[name]}"
                )
        dev = resolve_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_kv_heads, self.window, self.n_layers = n_kv_heads, window, n_layers
        self.dropout = dropout
        self.compute_dtype = _dtype(compute_dtype)
        self.logits_dtype = _dtype(logits_dtype)
        self.attention_sinks = attention_sinks
        self.remat = bool(remat)
        self.fused_head_chunks = int(fused_head_chunks)
        self.embed = nn.Embedding(vocab_size, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, dropout, self.compute_dtype,
                  n_kv_heads=n_kv_heads, window=window,
                  attention_sinks=attention_sinks)
            for _ in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, self.compute_dtype)
        self.lm_head = LMHead(
            d_model, vocab_size, self.compute_dtype, self.logits_dtype
        )
        self.reset_parameters(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def config(self) -> dict:
        """JSON-serializable hyperparameters (`TransformerLM(**config)`)."""
        return {
            "vocab_size": self.vocab_size, "d_model": self.d_model,
            "n_heads": self.n_heads, "n_kv_heads": self.n_kv_heads,
            "window": self.window, "n_layers": self.n_layers,
            "dropout": self.dropout,
            "compute_dtype": _dtype_name(self.compute_dtype),
            "logits_dtype": _dtype_name(self.logits_dtype),
            "attention_sinks": self.attention_sinks,
            "remat": self.remat,
            "fused_head_chunks": self.fused_head_chunks,
        }

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a seeded CPU generator: lecun-normal
        (truncated at 2σ) matmul weights, N(0, 1/d) embedding, unit
        LayerNorm scales."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            elif name == "embed.weight":
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
            else:
                std = 1.0 / math.sqrt(p.shape[1]) / 0.87962566103423978
                w = torch.empty(p.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
                p.copy_(w)

    def _embed(self, tokens):
        return self.embed(tokens.long()).to(self.compute_dtype)

    def forward(self, tokens, *, train: bool = False, segment_ids=None,
                labels=None, dropout_seed: int | None = None):
        """Logits ``[B, T, vocab]``; with ``labels`` ``[B, T]`` instead
        ``(per_token_loss, per_token_correct)`` from the fused chunked-CE
        head (the ``Trainer(loss="module")`` contract). ``segment_ids``
        ``[B, T]`` packs documents: positions restart at each run and
        attention keeps equal-id pairs. ``dropout_seed`` seeds dropout
        under ``train=True`` (each layer derives its own masks from it)."""
        b, t = tokens.shape
        if segment_ids is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        else:
            if tuple(segment_ids.shape) != (b, t):
                raise ValueError(
                    f"segment_ids must be [B, T] = {(b, t)}, got "
                    f"{tuple(segment_ids.shape)}"
                )
            positions = packed_positions(segment_ids)
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            kw = dict(train=train, segment_ids=segment_ids,
                      dropout_seed=dropout_seed, dropout_site=2 * i)
            if self.remat and torch.is_grad_enabled():
                # Recompute the block in the backward. Dropout masks come
                # from (seed, layer, site), so the recompute redraws them;
                # no global RNG state to stash.
                x = checkpoint(blk, x, positions, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = blk(x, positions, **kw)
        x = self.ln_f(x)
        if labels is not None:
            return self.lm_head.fused_loss(x, labels, self.fused_head_chunks)
        return self.lm_head(x)

    def decode(self, tokens, cache=None, *, max_decode_len: int = 0):
        """Decode-mode forward: ``(logits [B, T, vocab], cache)``.

        ``cache=None`` is the prefill: a fresh cache of ``max_decode_len``
        positions is created, the prompt's K/V written at [0, T) and
        attention runs causally over the prompt (the flash path). With a
        cache, the T tokens land at ``cache["index"]`` (scalar, or ``[B]``
        per-row) and attend over the cache; the returned cache shares the
        passed K/V tensors (written in place) with ``index`` advanced by T.
        """
        b, t = tokens.shape
        dev = tokens.device
        fresh = cache is None
        if fresh:
            if max_decode_len < t:
                raise ValueError(
                    f"max_decode_len ({max_decode_len}) < input length ({t})"
                )
            h_kv, hd = self.n_kv_heads or self.n_heads, self.d_model // self.n_heads
            cache = {
                f"Block_{i}": {
                    n: torch.zeros(
                        (b, max_decode_len, h_kv, hd),
                        dtype=self.compute_dtype, device=dev,
                    )
                    for n in ("k", "v")
                }
                for i in range(self.n_layers)
            }
            cache["index"] = torch.zeros((), dtype=torch.int32, device=dev)
        idx = cache["index"]
        offs = torch.arange(t, dtype=torch.int32, device=dev)
        if idx.dim() == 0:
            positions = (idx + offs).expand(b, t)
        else:
            positions = idx[:, None] + offs[None, :]
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            x = blk(
                x, positions, cache=cache[f"Block_{i}"], decode_index=idx,
                fresh=fresh,
            )
        new_cache = {**cache, "index": idx + t}
        return self.lm_head(self.ln_f(x)), new_cache
