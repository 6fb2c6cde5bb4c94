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

Decode knobs, as in the JAX model: ``int8_compute`` runs every Dense
contraction and the LM head through `quant.int8_dot_general` (inference
only); ``quantized_cache`` stores K/V as int8 with per-(position, head) f32
scales ``k_scale``/``v_scale`` ``[B, L, H_kv]`` (the decode contractions
read the int8 values and apply the scales outside the head-dim sum);
``sliding_cache`` makes the cache a ring of ``attention_sinks + min(window,
max_decode_len)`` slots with per-slot absolute positions ``pos`` ``[B, L]``
(−1 for a slot never written, sinks pinned; prefill and single-token steps
at a lockstep index only). `TransformerLM.clone` returns a model of another
configuration that shares the parameter tensors (flax's ``Module.clone``).

MoE blocks, as in the JAX model: ``moe_every=k`` makes block i's MLP a
`models.moe.MoEMlp` (``n_experts``, ``moe_k``, ``capacity_factor``,
``moe_aux_coef``, ``moe_router``) when ``(i + 1) % k == 0``; its
auxiliary loss and drop-rate metric are sown (`sown_losses`,
`sown_metrics`). ``sharding=ShardingConfig(mesh, attn)`` places the model
on a `parallel.mesh.Mesh`: the MoE layers shard their experts over the
mesh's ``expert`` axis, and attention is the flash path (or the dense one,
``attn="dense"``). `param_specs` gives each parameter's placement by the
JAX model's rules. On a live ``pipe`` axis the model is replicated over
its ranks, as the JAX model is under GSPMD (no parameter is placed there);
the pipelined model is `models.pipelined_lm`.

Tensor parallelism and FSDP, as in the JAX model: on a mesh with a live
``model`` axis of tp ranks each rank holds its `param_specs` part of the
Megatron layout — ``n_heads/tp`` q heads and ``n_kv_heads/tp`` kv heads
(``qkv``/``kv_proj`` cut per part by heads, `parallel.sharding`), ``4·d/tp``
MLP features and ``vocab/tp`` LM-head rows. The column-parallel
projections sit behind Megatron's f (`collectives.enter_group`: identity
forward, a sum over ``model`` backward), the row-parallel ``attn_out`` and
``mlp_down`` behind g (`collectives.leave_group`: the sum forward), and
attention runs the flash kernels (or the ``seq`` ring) on the local heads.
The LM head's logits are gathered over ``model``; the fused-CE head
gathers the head weight instead, with a slicing backward (every model rank
computes the same loss on the same rows). On a live ``fsdp`` axis every
≥2-D parameter holds its ``fsdp`` shard and is gathered where it is used,
its gradient reduce-scattered back (`parallel.sharding.weight`). The
weights are drawn whole from the seed and cut, so a sharded model starts
from the one-rank model's weights; `unsharded` gathers them back into a
plain model (a collective). The decode cache holds the local kv heads,
``[B, L, H_kv/tp, D]``. MoE layers and int8 weights or caches on a live
``model`` axis, and MoE layers and ``int8_compute`` on a live ``fsdp``
axis, raise naming ROADMAP queue A item 18.

Sequence parallelism, as in the JAX model: on a mesh with a live ``seq``
axis of n ranks, the model takes this rank's ``[B, T/n]`` shard of the
tokens (and of ``segment_ids``, ``labels``) and returns its shard of the
output. Positions are global: shard c holds positions ``c·T/n +
arange(T/n)``, and packed positions are computed on the ids all-gathered
over the ``seq`` group, so a document that crosses a shard boundary keeps
counting. Attention runs over the ``seq`` group (`ShardingConfig.attn`):
``"ring"`` the flash ring (`ops.attention.ring_flash_attention`, the
flash kernels at every hop), ``"ring_dense"`` the dense-score ring,
``"ulysses"`` the head-swapping all-to-all; ``"dense"`` raises JAX's
error. Decoding (prefill and steps) does not shard over ``seq``, as in the
JAX model: every rank of a ``seq`` group decodes the whole prompt.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.models import quant
from horovod_tpu_torch.models.moe import MoEMlp, lecun_normal_
from horovod_tpu_torch.ops.attention import (
    _BIG_NEG, dense_attention, ring_attention, ring_flash_attention,
    ulysses_attention,
)
from horovod_tpu_torch.ops.dropout import dropout
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS,
)
from horovod_tpu_torch.runtime import resolve_device
from horovod_tpu_torch.training import train_state

#: The ROADMAP item of what the port does not carry on a mesh yet.
ITEM_18 = ("queue A item 18 (the model axis in MoE, seq2seq, LoRA and "
           "int8)")
#: The axes item 18's modules refuse (``also=`` of `refuse_unported_axes`).
ITEM_18_AXES = (MODEL_AXIS, FSDP_AXIS)


def refuse_unported_axes(mesh, what: str, also=()) -> None:
    """Raise `NotImplementedError` naming ROADMAP item 18 for the first
    live axis of ``mesh`` among ``also`` that ``what`` does not carry."""
    for ax in also:
        if mesh is not None and mesh.shape.get(ax, 1) > 1:
            raise NotImplementedError(
                f"{what} on a mesh with a live {ax!r} axis "
                f"({mesh.shape[ax]}) is not ported yet — ROADMAP {ITEM_18}"
            )


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How the model meets the mesh (the JAX model's config). ``attn``:
    ``"ring"`` (default: the flash ring), ``"ring_dense"`` (the ring with
    dense per-hop scores), ``"ulysses"`` (all-to-all head swap) on a live
    ``seq`` axis, where ``"dense"`` raises; on a mesh without one,
    ``"dense"`` takes `ops.attention.dense_attention` (the numerics
    reference) and the others the local flash path, as in the JAX model.
    A live ``pipe`` axis replicates the model over its ranks, as GSPMD
    does with the JAX model (the pipelined model is
    `models.pipelined_lm`)."""

    mesh: object = None
    attn: str = "ring"

    @property
    def seq_parallel(self) -> bool:
        return self.mesh is not None and self.mesh.shape.get(SEQ_AXIS, 1) > 1

    @property
    def seq_group(self):
        """The ranks sharing this one's batch rows, one sequence shard
        each (`collectives.SELF` without a live ``seq`` axis)."""
        return (self.mesh.group(SEQ_AXIS) if self.seq_parallel
                else collectives.SELF)

    @property
    def tp(self) -> int:
        """The size of the ``model`` axis (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.shape.get(MODEL_AXIS, 1)

    @property
    def model_group(self):
        """The ranks that hold this one's batch rows and tokens, one
        Megatron part each (`collectives.SELF` without a live ``model``
        axis)."""
        return (self.mesh.group(MODEL_AXIS) if self.tp > 1
                else collectives.SELF)


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
    ``n_heads``) uses ``q_proj`` and ``kv_proj`` (k heads, then v heads).
    Its layers are built whole; on a live ``model`` axis the model cuts
    them to this rank's heads and features (``heads``, ``kv_heads``
    local)."""

    def __init__(self, d_model: int, n_heads: int, dropout: float,
                 compute_dtype: torch.dtype, *, n_kv_heads: int | None = None,
                 window: int | None = None, attention_sinks: int = 0,
                 sharding: ShardingConfig | None = None,
                 use_moe: bool = False, n_experts: int = 8, moe_k: int = 2,
                 capacity_factor: float = 1.25, moe_aux_coef: float = 1e-2,
                 moe_router: str = "top_k"):
        super().__init__()
        h_kv = n_kv_heads or n_heads
        if n_heads % h_kv != 0:
            raise ValueError(
                f"n_heads ({n_heads}) must be a multiple of n_kv_heads "
                f"({h_kv})"
            )
        tp = (sharding or ShardingConfig()).tp
        if sharding is not None and sharding.mesh is not None:
            if n_heads % tp != 0:
                raise ValueError(
                    f"n_heads ({n_heads}) must divide over the model "
                    f"axis ({tp}) for sharded attention"
                )
            if h_kv % tp != 0:
                raise ValueError(
                    f"n_kv_heads ({h_kv}) must divide over the model axis "
                    f"({tp}) — the kv projection and decode cache "
                    f"shard their head dim"
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
        self.heads, self.kv_heads = n_heads // tp, h_kv // tp  # this rank's
        self.head_dim = d_model // n_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.window, self.sinks = window, attention_sinks
        self.int8_compute = False  # set by TransformerLM._propagate
        hd = self.head_dim
        self.ln_attn = LayerNorm(d_model, compute_dtype)
        if h_kv == n_heads:
            self.qkv = nn.Linear(d_model, 3 * n_heads * hd, bias=False)
        else:
            self.q_proj = nn.Linear(d_model, n_heads * hd, bias=False)
            self.kv_proj = nn.Linear(d_model, 2 * h_kv * hd, bias=False)
        self.attn_out = nn.Linear(n_heads * hd, d_model, bias=False)
        self.ln_mlp = LayerNorm(d_model, compute_dtype)
        self.sharding = sharding or ShardingConfig()
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoEMlp(d_model, n_experts=n_experts, k=moe_k,
                              capacity_factor=capacity_factor,
                              aux_loss_coef=moe_aux_coef, router=moe_router,
                              compute_dtype=compute_dtype,
                              sharding=self.sharding)
        else:
            self.mlp_up = nn.Linear(d_model, 4 * d_model, bias=False)
            self.mlp_down = nn.Linear(4 * d_model, d_model, bias=False)

    def _dense(self, layer: nn.Linear, x):
        cd = self.compute_dtype
        if self.int8_compute:
            return quant.int8_linear(layer, x, cd)
        return F.linear(x.to(cd), shard_lib.weight(layer).to(cd))

    def _qkv(self, h):
        b, t, _ = h.shape
        hd, nh, nkv = self.head_dim, self.heads, self.kv_heads
        h = collectives.enter_group(h, self.sharding.model_group)  # f
        if self.h_kv == self.n_heads:
            q, k, v = self._dense(self.qkv, h).split(nh * hd, -1)
            return (x.view(b, t, nh, hd) for x in (q, k, v))
        q = self._dense(self.q_proj, h).view(b, t, nh, hd)
        k, v = self._dense(self.kv_proj, h).split(nkv * hd, -1)
        return q, k.view(b, t, nkv, hd), v.view(b, t, nkv, hd)

    def _row(self, layer: nn.Linear, x):
        """A row-parallel projection: this rank's partial product, summed
        over ``model`` (Megatron's g)."""
        return collectives.leave_group(self._dense(layer, x),
                                       self.sharding.model_group)

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
        elif self.sharding.seq_parallel:
            out = self._seq_attention(q, k, v, segment_ids)
        elif self.sharding.attn == "dense":
            rep = self.n_heads // self.h_kv
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = dense_attention(
                q, k, v, causal=True, window=self.window, sinks=self.sinks,
                q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            ).to(q.dtype)
        else:
            out = flash_attention(
                q, k, v, causal=True, window=self.window, sinks=self.sinks,
                q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            )
        out = self._row(self.attn_out, out.reshape(b, t, -1))
        if drop:
            out = dropout(out, self.dropout, dropout_seed, dropout_site)
        x = x + out
        h = self._mlp(self.ln_mlp(x), train=train, decode=cache is not None)
        if drop:
            h = dropout(h, self.dropout, dropout_seed, dropout_site + 1)
        return x + h

    def _seq_attention(self, q, k, v, segment_ids):
        """Attention over the ``seq`` group (the JAX model's shard_map
        region), with JAX's refusals."""
        cfg = self.sharding
        if self.sinks and cfg.attn == "ring_dense":
            raise ValueError(
                "sinks need attn='ring' or 'ulysses' — the dense-block "
                "ring is sink-unaware"
            )
        impls = {"ring": ring_flash_attention, "ring_dense": ring_attention,
                 "ulysses": ulysses_attention}
        if cfg.attn not in impls:
            raise ValueError(
                f"sequence-parallel attention needs attn in {sorted(impls)}, "
                f"got {cfg.attn!r}"
            )
        if segment_ids is not None and cfg.attn == "ring_dense":
            raise ValueError(
                "packed sequences (segment_ids) need attn='ring' or "
                "'ulysses' — the dense-block ring is segment-unaware"
            )
        rep = self.n_heads // self.h_kv
        if rep > 1 and cfg.attn != "ring":
            # The flash ring reads GQA heads in place; the others take K/V
            # at q's heads, as the JAX model repeats them.
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        kw = dict(group=cfg.seq_group, causal=True, window=self.window)
        if self.sinks:
            kw["sinks"] = self.sinks
        if segment_ids is not None:
            kw["segment_ids"] = segment_ids
        return impls[cfg.attn](q, k, v, **kw)

    def _mlp(self, h, *, train: bool, decode: bool):
        if self.use_moe:
            if decode and self.moe.router_kind == "expert_choice":
                raise ValueError(
                    "expert_choice routing is training-only: expert "
                    "selection ranks tokens across the whole group, which "
                    "a per-token decode step cannot reproduce (the known "
                    "EC train/inference asymmetry) — decode with "
                    "moe_router='top_k'"
                )
            return self.moe(h, train=train, whole_batch=decode)
        h = collectives.enter_group(h, self.sharding.model_group)  # f
        h = self._dense(self.mlp_up, h)
        return self._row(self.mlp_down, F.gelu(h, approximate="tanh"))

    def _decode_attention(self, q, k, v, cache, idx, fresh):
        b, t, h, d = q.shape
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[1]
        ring = "pos" in cache
        qc = "k_scale" in cache
        if length < t and not ring:  # a ring prefill drops its early tokens
            raise ValueError(
                f"max_decode_len ({length}) < input length ({t})"
            )
        if ring:
            _ring_write(cache, k, v, idx, t, self.sinks, fresh)
        else:
            if qc:
                # Per-(position, head) scales; the fresh full-precision
                # k/v stay as they are for the prefill's flash attention
                # below — only the cache holds the int8 copies.
                wk, k_s = quant._quantize_sym(k, dim=-1)
                wv, v_s = quant._quantize_sym(v, dim=-1)
                fresh_vals = {"k": wk, "v": wv, "k_scale": k_s[..., 0],
                              "v_scale": v_s[..., 0]}
            else:
                fresh_vals = {"k": k, "v": v}
            _cache_write(cache, fresh_vals, idx, t)
        if t > 1 and fresh:
            # Prefill: causal attention over the fresh K/V is the full
            # answer (the cache was empty) — the flash kernel's path, with
            # the same window and sinks mask.
            return flash_attention(
                q, k, v, causal=True, window=self.window, sinks=self.sinks
            )
        # Decode step / chunk extension: the t fresh queries attend over
        # the cache; grouped so each cached kv head streams once for its
        # `rep` query heads, products summed in f32.
        h_kv = ck.shape[2]
        rep = h // h_kv
        steps = torch.arange(t, dtype=torch.int32, device=q.device)
        qg = q.reshape(b, t, h_kv, rep, d).permute(0, 2, 3, 1, 4)
        qg = qg.reshape(b * h_kv, rep * t, d)
        keys = ck.permute(0, 2, 3, 1).contiguous().to(q.dtype)
        s = _matmul_f32(qg, keys.view(b * h_kv, d, length))
        s = s.view(b, h_kv, rep, t, length) * d ** -0.5
        if qc:
            # score = (q · k_int8) · k_scale: the scale factors out of the
            # head-dim contraction onto the [.., L] scores.
            s = s * cache["k_scale"].permute(0, 2, 1)[:, :, None, None, :]
        if ring:
            # Ring slots carry their absolute positions: valid = written,
            # causal, and in the band or a pinned sink.
            qpos = (idx + steps)[None, :, None]  # [1, t, 1]
            kpos = cache["pos"][:, None, :]  # [B, 1, W]
            band = (kpos > qpos - self.window) | (kpos < self.sinks)
            valid = (kpos >= 0) & (kpos <= qpos) & band
        else:
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
        if qc:
            # The value side folds v_scale into the probabilities.
            p = p * cache["v_scale"].permute(0, 2, 1)[:, :, None, None, :]
        vals = cv.permute(0, 2, 1, 3).contiguous().to(q.dtype)
        out = _matmul_f32(p.to(q.dtype).reshape(b * h_kv, rep * t, length),
                          vals.view(b * h_kv, length, d))
        out = out.view(b, h_kv, rep, t, d).permute(0, 3, 1, 2, 4)
        return out.reshape(b, t, h, d).to(q.dtype)


def _matmul_f32(a, b):
    """Batched ``a @ b`` with an f32 result (the JAX model's
    ``preferred_element_type=f32``): a 16-bit product on the card keeps
    its operands and returns f32 (cuBLAS's f32 output); on the CPU, or for
    f32 operands, the operands are f32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _cache_write(cache, fresh, idx, t):
    """Write ``fresh`` (``{leaf: [B, t, ...]}``) into the cache leaves of
    the same names at position ``idx`` (scalar: ``dynamic_update_slice``
    semantics, the start clamped to L − t) or at per-row positions ``idx
    [B]`` (positions outside [0, L) dropped, JAX's ``mode="drop"``)."""
    any_leaf = cache["k"]
    b, length = any_leaf.shape[:2]
    steps = torch.arange(t, dtype=torch.int32, device=any_leaf.device)
    if idx.dim() == 0:
        pos = (idx.clamp(0, length - t) + steps).long()
        for name, val in fresh.items():
            cache[name].index_copy_(1, pos, val.to(cache[name].dtype))
        return
    # Per-row positions. An out-of-range index is a device assert on CUDA,
    # so a dropped position p (p >= L, as free or retired serving rows
    # step past the end) writes its slot p mod L back with its own value:
    # with t <= L those slots lie below every row's first in-range write
    # (or the row has none), so no two writes meet.
    p = idx[:, None] + steps[None, :]  # [B, t]
    ok = (p >= 0) & (p < length)
    slot = torch.remainder(p, length).long()
    rows = torch.arange(b, device=any_leaf.device)[:, None]
    for name, val in fresh.items():
        leaf = cache[name]
        keep = ok.view(b, t, *([1] * (leaf.dim() - 2)))
        leaf[rows, slot] = torch.where(keep, val.to(leaf.dtype),
                                       leaf[rows, slot])


def _ring_write(cache, k, v, idx, t, sinks, fresh):
    """The ring cache's write (JAX ``sliding_cache``): positions below
    ``sinks`` pin to slots [0, sinks), the rest ring over [sinks, L). A
    prefill keeps the sinks and its last L − sinks ring positions (earlier
    ones would be evicted within the same write); a step writes one token.
    Lockstep (scalar) indices only."""
    if idx.dim() != 0:
        raise ValueError(
            "per-row decode indices are not supported with sliding_cache "
            "— the ring buffer's slot math is lockstep"
        )
    if t > 1 and not fresh:
        raise ValueError(
            "sliding_cache supports prefill + single-token decode steps; "
            "chunk extension (speculative decoding's verify pass) needs the "
            "full-history cache — evicted rows could be needed by the "
            "chunk's early tokens"
        )
    ck = cache["k"]
    b, length = ck.shape[:2]
    win = length - sinks
    dev = ck.device
    if fresh:
        # The prefill writes from position 0: which positions survive is
        # known from t alone.
        keep = [j for j in range(t) if j < sinks or j >= t - win]
        src = torch.tensor(keep, dtype=torch.long, device=dev)
        slot = torch.tensor(
            [j if j < sinks else sinks + (j - sinks) % win for j in keep],
            dtype=torch.long, device=dev)
        new_pos = src.to(torch.int32)
        k, v = k.index_select(1, src), v.index_select(1, src)
    else:
        new_pos = idx.reshape(1)
        slot = torch.where(new_pos < sinks, new_pos,
                           sinks + torch.remainder(new_pos - sinks, win))
        slot = slot.long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slot, new_pos.expand(b, -1).contiguous())


class LMHead(nn.Module):
    """The LM head: ``[vocab, d_model]`` weight (flax ``lm_head/kernel``
    transposed), a compute-dtype matmul, logits cast to ``logits_dtype``
    (with ``int8_compute``: `quant.int8_dot_general` straight to
    ``logits_dtype``). On a live ``model`` axis (``sharding``) it holds
    ``vocab/tp`` rows: the logits are this rank's columns, gathered over
    ``model``; the fused loss gathers the weight instead."""

    def __init__(self, d_model: int, vocab_size: int,
                 compute_dtype: torch.dtype, logits_dtype: torch.dtype,
                 sharding: ShardingConfig | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, d_model))
        self.compute_dtype = compute_dtype
        self.logits_dtype = logits_dtype
        self.int8_compute = False  # set by TransformerLM._propagate
        self.sharding = sharding or ShardingConfig()

    def forward(self, x):
        cd = self.compute_dtype
        if self.int8_compute:
            return quant.int8_linear(self, x, cd, out_dtype=self.logits_dtype)
        group = self.sharding.model_group
        x = collectives.enter_group(x, group)  # f
        logits = F.linear(x.to(cd), shard_lib.weight(self).to(cd))
        # Each model rank computes the same loss on the gathered logits:
        # the gather's backward keeps this rank's columns.
        return collectives.all_gather_tiled(logits.to(self.logits_dtype),
                                            group, -1)

    def fused_loss(self, x, labels, n_chunks: int):
        """(per-token loss, per-token correct) without full logits; on a
        live ``model`` axis over the weight gathered whole, whose backward
        keeps this rank's rows (every model rank computes the same loss on
        the same rows: `collectives.gather_weight`, ``"slice"``)."""
        w = collectives.gather_weight(shard_lib.weight(self), 0,
                                      self.sharding.model_group, "slice")
        return fused_linear_cross_entropy(
            x.to(self.compute_dtype), w, labels, max(1, n_chunks)
        )


# The knobs `TransformerLM.clone` may change: the rest fix the parameter
# shapes the clone shares.
_CLONE_KNOBS = ("window", "dropout", "compute_dtype", "logits_dtype",
                "attention_sinks", "remat", "fused_head_chunks",
                "int8_compute", "quantized_cache", "sliding_cache",
                "capacity_factor", "moe_aux_coef", "moe_router")


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
                 remat: bool = False, fused_head_chunks: int = 0,
                 int8_compute: bool = False, quantized_cache: bool = False,
                 sliding_cache: bool = False, moe_every: int = 0,
                 n_experts: int = 8, moe_k: int = 2,
                 capacity_factor: float = 1.25, moe_aux_coef: float = 1e-2,
                 moe_router: str = "top_k",
                 sharding: ShardingConfig | None = None, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        sharding = sharding or ShardingConfig()
        _refuse_item_18(sharding.mesh, moe_every, int8_compute,
                        quantized_cache)
        if int8_compute and moe_every:
            quant.refuse_moe_int8_compute()
        dev = resolve_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_kv_heads, self.window, self.n_layers = n_kv_heads, window, n_layers
        self.dropout = dropout
        self.compute_dtype = _dtype(compute_dtype)
        self.logits_dtype = _dtype(logits_dtype)
        self.attention_sinks = attention_sinks
        self.remat = bool(remat)
        self.fused_head_chunks = int(fused_head_chunks)
        self.int8_compute = bool(int8_compute)
        self.quantized_cache = bool(quantized_cache)
        self.sliding_cache = bool(sliding_cache)
        self.moe_every, self.n_experts = int(moe_every), int(n_experts)
        self.moe_k, self.capacity_factor = int(moe_k), float(capacity_factor)
        self.moe_aux_coef, self.moe_router = float(moe_aux_coef), moe_router
        self.sharding = sharding
        self.embed = nn.Embedding(vocab_size, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, n_heads, dropout, self.compute_dtype,
                  n_kv_heads=n_kv_heads, window=window,
                  attention_sinks=attention_sinks, sharding=sharding,
                  use_moe=self.moe_every > 0
                  and (i + 1) % self.moe_every == 0,
                  n_experts=n_experts, moe_k=moe_k,
                  capacity_factor=capacity_factor, moe_aux_coef=moe_aux_coef,
                  moe_router=moe_router)
            for i in range(n_layers)
        )
        self.ln_f = LayerNorm(d_model, self.compute_dtype)
        self.lm_head = LMHead(
            d_model, vocab_size, self.compute_dtype, self.logits_dtype,
            sharding
        )
        self._propagate()
        self._cut_parameters()
        self.reset_parameters(seed)
        self.to(dev)

    def _cut_parameters(self) -> None:
        """Replace each parameter placed on a live ``model`` or ``fsdp``
        axis (`param_specs`) by this rank's part (``cuts``: name →
        placement); its owner keeps the whole shape (``full_shapes``) and,
        for an ``fsdp`` part, the dim to gather it along at use
        (``fsdp_dims``, ``fsdp_mesh``)."""
        mesh = self.sharding.mesh
        self.cuts: dict = {}
        self.reduces_over_ranks = False
        if mesh is None or max(mesh.shape[MODEL_AXIS],
                               mesh.shape[FSDP_AXIS]) == 1:
            return
        self.reduces_over_ranks = True  # the forward's collectives
        for name, spec in param_specs(self, mesh).items():
            on = {d: ax for d, ax in spec.items()
                  if ax in (MODEL_AXIS, FSDP_AXIS) and mesh.shape[ax] > 1}
            if not on:
                continue
            owner, leaf = name.rsplit(".", 1)
            mod = self.get_submodule(owner)
            whole = getattr(mod, leaf).detach()
            mod.full_shapes = {**getattr(mod, "full_shapes", {}),
                               leaf: tuple(whole.shape)}
            setattr(mod, leaf, nn.Parameter(
                shard_lib.shard_tensor(whole, name, on, mesh).clone()))
            for dim, ax in on.items():
                if ax == FSDP_AXIS:
                    mod.fsdp_dims = {**getattr(mod, "fsdp_dims", {}),
                                     leaf: dim}
                    mod.fsdp_mesh = mesh
            self.cuts[name] = on

    def _propagate(self) -> None:
        """Hand the model-level knobs down to the submodules that read
        them (at construction and after `clone`)."""
        cd = self.compute_dtype
        for blk in self.blocks:
            blk.compute_dtype = blk.ln_attn.dtype = blk.ln_mlp.dtype = cd
            blk.window, blk.sinks = self.window, self.attention_sinks
            blk.dropout = self.dropout
            blk.int8_compute = self.int8_compute
            if blk.use_moe:
                moe = blk.moe
                moe.compute_dtype = cd
                moe.capacity_factor = self.capacity_factor
                moe.aux_loss_coef = self.moe_aux_coef
                moe.set_router(self.moe_router)
        self.ln_f.dtype = self.lm_head.compute_dtype = cd
        self.lm_head.logits_dtype = self.logits_dtype
        self.lm_head.int8_compute = self.int8_compute

    def clone(self, **overrides) -> "TransformerLM":
        """A model of this configuration with ``overrides`` applied that
        SHARES this model's parameter tensors (flax's ``Module.clone`` as
        ``examples/lm_generate.py`` uses it: the same weights decoded with
        another window, sinks, cache or int8 knob). Knobs that shape the
        parameters cannot change."""
        bad = sorted(set(overrides) - set(_CLONE_KNOBS))
        if bad:
            raise ValueError(
                f"clone cannot change {bad}: the clone shares the "
                f"parameters; it may change {list(_CLONE_KNOBS)}"
            )
        # What the layers sowed belongs to the last forward (it may hold
        # tensors of an autograd graph, which do not copy).
        train_state.clear_sown(self)
        memo = {id(t): t for t in (*self.parameters(), *self.buffers())}
        new = copy.deepcopy(self, memo)
        for name, value in overrides.items():
            if name in ("compute_dtype", "logits_dtype"):
                value = _dtype(value)
            setattr(new, name, value)
        _refuse_item_18(new.sharding.mesh, new.moe_every, new.int8_compute,
                        new.quantized_cache)
        if new.int8_compute and new.moe_every:
            quant.refuse_moe_int8_compute()
        if new.attention_sinks < 0:
            raise ValueError("attention_sinks must be >= 0")
        if new.attention_sinks and new.window is None:
            raise ValueError(
                "attention_sinks is the global+local mask's global part — "
                "it needs window set (full causal attention already sees "
                "every sink)"
            )
        new._propagate()
        return new

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
            "int8_compute": self.int8_compute,
            "quantized_cache": self.quantized_cache,
            "sliding_cache": self.sliding_cache,
            "moe_every": self.moe_every, "n_experts": self.n_experts,
            "moe_k": self.moe_k, "capacity_factor": self.capacity_factor,
            "moe_aux_coef": self.moe_aux_coef,
            "moe_router": self.moe_router,
        }

    def sown_losses(self) -> list:
        """The auxiliary losses its layers sowed in the last forward (the
        JAX model's ``losses`` collection; MoE load balance, train only)."""
        return train_state.sown_losses(self)

    def sown_metrics(self) -> dict:
        """The metrics its layers sowed in the last forward, averaged over
        the layers by name (``moe_drop_rate``, ``moe_uncovered_rate``)."""
        return train_state.sown_metrics(self)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a seeded CPU generator: lecun-normal
        (truncated at 2σ) matmul weights, N(0, 1/d) embedding, unit
        LayerNorm scales. A parameter this rank holds a part of is drawn
        whole and cut (the MoE layers' experts, with the expert axis a
        batch axis of fan-in dim 1; the ``model``/``fsdp`` cuts), so every
        mesh starts from the one-rank weights."""
        g = torch.Generator().manual_seed(seed)
        full = _full_shapes(self)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            w = torch.empty(full[name])
            if name == "embed.weight":
                w = torch.randn(w.shape, generator=g) / math.sqrt(w.shape[1])
            else:
                lecun_normal_(w, g, w.shape[1])
            if ".moe." in name:
                owner, leaf = name.split(".moe.")
                w = self.get_submodule(owner + ".moe").local_part(leaf, w)
            elif name in self.cuts:
                w = shard_lib.shard_tensor(w, name, self.cuts[name],
                                           self.sharding.mesh)
            p.copy_(w)

    def unsharded(self) -> "TransformerLM":
        """A model of this configuration without a mesh, on this model's
        device, holding its whole weights: gathered over the mesh's
        groups, a collective every rank of the mesh calls at one point.
        The port runs one process a rank, so this is how a sharded model
        is exported or decoded alone on one rank."""
        mesh = self.sharding.mesh
        sd = self.state_dict()
        if mesh is not None:
            from horovod_tpu_torch.models.convert import gather_state_dict

            sd = gather_state_dict(
                sd, mesh, live_placements(param_specs(self, mesh), mesh))
        plain = TransformerLM(**self.config(), device=self.device)
        plain.load_state_dict(sd)
        return plain

    def _positions(self, tokens, segment_ids):
        """``[B, T]`` RoPE positions of this rank's tokens: global ones on
        a live ``seq`` axis (shard c starts at c·T/n; packed positions are
        computed on the ids gathered over the ``seq`` group, then cut)."""
        b, t = tokens.shape
        dev = tokens.device
        cfg = self.sharding
        c = cfg.mesh.coords[SEQ_AXIS] if cfg.seq_parallel else 0
        if segment_ids is None:
            return (c * t + torch.arange(t, device=dev)).expand(b, t)
        if not cfg.seq_parallel:
            return packed_positions(segment_ids)
        with torch.no_grad():
            full = collectives.all_gather_tiled(segment_ids, cfg.seq_group, 1)
        return packed_positions(full)[:, c * t:(c + 1) * t]

    def _embed(self, tokens):
        return F.embedding(tokens.long(), shard_lib.weight(self.embed)).to(
            self.compute_dtype)

    def forward(self, tokens, *, train: bool = False, segment_ids=None,
                labels=None, dropout_seed: int | None = None):
        """Logits ``[B, T, vocab]``; with ``labels`` ``[B, T]`` instead
        ``(per_token_loss, per_token_correct)`` from the fused chunked-CE
        head (the ``Trainer(loss="module")`` contract). ``segment_ids``
        ``[B, T]`` packs documents: positions restart at each run and
        attention keeps equal-id pairs. ``dropout_seed`` seeds dropout
        under ``train=True`` (each layer derives its own masks from it)."""
        if self.int8_compute and (train or labels is not None):
            raise ValueError(
                "int8_compute is inference-only: round() kills gradients "
                "(quantization-aware training would need a straight-"
                "through estimator) — clone the model with "
                "int8_compute=False for training"
            )
        if self.int8_compute and self.moe_every:
            quant.refuse_moe_int8_compute()
        b, t = tokens.shape
        if segment_ids is not None and tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [B, T] = {(b, t)}, got "
                f"{tuple(segment_ids.shape)}"
            )
        positions = self._positions(tokens, segment_ids)
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

    def new_cache(self, batch: int, max_decode_len: int, device=None) -> dict:
        """An empty decode cache for ``batch`` rows and ``max_decode_len``
        positions, in the layout of this model's cache knobs: per block
        ``k``/``v`` ``[B, L, H_kv, D]`` (int8 with f32 ``k_scale``/``v_scale``
        ``[B, L, H_kv]`` under ``quantized_cache``; L = ``attention_sinks +
        min(window, max_decode_len)`` slots with ``pos`` ``[B, L]`` = −1
        under ``sliding_cache``), and a scalar int32 ``index``."""
        if self.sliding_cache and self.window is None:
            raise ValueError(
                "sliding_cache is the ring buffer for sliding-window "
                "attention — set window too"
            )
        if self.quantized_cache and self.sliding_cache:
            raise ValueError(
                "quantized_cache does not compose with sliding_cache (the "
                "ring path keeps full-width slots) — pick one"
            )
        dev = self.device if device is None else device
        h_kv = (self.n_kv_heads or self.n_heads) // self.sharding.tp
        hd = self.d_model // self.n_heads
        length = (self.attention_sinks + min(self.window, max_decode_len)
                  if self.sliding_cache else max_decode_len)
        kv_dtype = torch.int8 if self.quantized_cache else self.compute_dtype

        def block():
            leaves = {n: torch.zeros((batch, length, h_kv, hd), dtype=kv_dtype,
                                     device=dev) for n in ("k", "v")}
            if self.quantized_cache:
                for n in ("k_scale", "v_scale"):
                    leaves[n] = torch.zeros((batch, length, h_kv),
                                            dtype=torch.float32, device=dev)
            if self.sliding_cache:
                leaves["pos"] = torch.full((batch, length), -1,
                                           dtype=torch.int32, device=dev)
            return leaves

        cache = {f"Block_{i}": block() for i in range(self.n_layers)}
        cache["index"] = torch.zeros((), dtype=torch.int32, device=dev)
        return cache

    def decode(self, tokens, cache=None, *, max_decode_len: int = 0):
        """Decode-mode forward: ``(logits [B, T, vocab], cache)``.

        ``cache=None`` is the prefill: a fresh cache of ``max_decode_len``
        positions is created (`new_cache`), the prompt's K/V written from
        position 0 and attention runs causally over the prompt (the flash
        path). With a cache, the T tokens land at ``cache["index"]``
        (scalar, or ``[B]`` per-row) and attend over the cache; the
        returned cache shares the passed tensors (written in place) with
        ``index`` advanced by T."""
        b, t = tokens.shape
        dev = tokens.device
        fresh = cache is None
        if fresh:
            if max_decode_len < t:
                raise ValueError(
                    f"max_decode_len ({max_decode_len}) < input length ({t})"
                )
            cache = self.new_cache(b, max_decode_len, dev)
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


# Megatron placements by layer name (the JAX `param_specs` tables), as dims
# of the port's own tensors: an `nn.Linear` weight is [out, in], so the
# JAX table's column-parallel kernels (features on flax dim 1) place dim 0
# here and its row-parallel ones (flax dim 0) dim 1; the LM head's
# [vocab, d] places the vocab, dim 0. Expert weights keep flax's layout.
_TP_DIM = {"qkv": 0, "q_proj": 0, "kv_proj": 0, "attn_out": 1,
           "mlp_up": 0, "mlp_down": 1, "lm_head": 0}
_MOE_DIMS = {"moe_up": {0: EXPERT_AXIS, 2: MODEL_AXIS},
             "moe_down": {0: EXPERT_AXIS, 1: MODEL_AXIS}}


def _full_shapes(module_or_state_dict) -> dict:
    """Parameter name → unsharded shape: a state dict's as they are; a
    module's with each MoE layer's experts counted whole and each
    ``model``/``fsdp`` part at its owner's ``full_shapes``."""
    if not isinstance(module_or_state_dict, nn.Module):
        return {k: tuple(v.shape) for k, v in module_or_state_dict.items()}
    shapes = {}
    for name, p in module_or_state_dict.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = module_or_state_dict.get_submodule(owner)
        shapes[name] = (mod.full_shape(leaf) if isinstance(mod, MoEMlp)
                        else getattr(mod, "full_shapes", {}).get(
                            leaf, tuple(p.shape)))
    return shapes


def param_specs(module_or_state_dict, mesh, extra_tp_dim=None) -> dict:
    """Per parameter name, its placement ``{dim: axis}`` ({} = replicated)
    by the JAX model's rules: expert weights ``moe_up`` {0: expert, 2:
    model} and ``moe_down`` {0: expert, 1: model} (a dim not divisible by
    its axis raises JAX's error), the Megatron table (`_TP_DIM`, extended
    by ``extra_tp_dim``) on ``model``, and with a live ``fsdp`` axis each
    ≥2-D weight's first free divisible dim on ``fsdp``. A LoRA adapter
    (`models.lora`: a leaf ``a`` or ``b`` under a ``lora`` component)
    skips the expert and Megatron rules, as in JAX. Placements on axes of
    size 1 are no-ops. ``module_or_state_dict`` is a module (its MoE
    layers counted at their full E) or a full state dict."""
    fsdp = mesh.shape.get(FSDP_AXIS, 1)
    tp_dim = {**_TP_DIM, **(extra_tp_dim or {})}
    specs = {}
    # By name, as JAX walks its tree: the same leaf fails first.
    for name, shape in sorted(_full_shapes(module_or_state_dict).items()):
        parts = name.split(".")
        spec: dict = {}
        # An adapter lives under the names of the kernel it adapts, with a
        # rank dimension: a submodule merely named 'lora' keeps the rules.
        is_lora = "lora" in parts and parts[-1] in ("a", "b")
        moe = None if is_lora else next(
            (n for n in parts if n in _MOE_DIMS), None)
        if moe is not None:
            for dim, axis in _MOE_DIMS[moe].items():
                if shape[dim] % mesh.shape[axis] != 0:
                    raise ValueError(
                        f"{moe} dim {dim} ({shape[dim]}) is not divisible "
                        f"by mesh axis {axis!r} ({mesh.shape[axis]})"
                    )
                spec[dim] = axis
        else:
            layer = next((n for n in parts if n in tp_dim), None)
            if layer is not None and len(shape) >= 2 and not is_lora:
                spec[tp_dim[layer]] = MODEL_AXIS
        if fsdp > 1 and len(shape) >= 2:
            for dim in range(len(shape)):
                if dim not in spec and shape[dim] % fsdp == 0:
                    spec[dim] = FSDP_AXIS
                    break
        specs[name] = dict(sorted(spec.items()))
    return specs


def live_placements(specs: dict, mesh) -> dict:
    """``specs`` restricted to the placements on axes larger than 1 (a
    pipelined model's stacks on ``pipe`` among them)."""
    live = {}
    for name, spec in specs.items():
        on = {d: ax for d, ax in spec.items() if mesh.shape.get(ax, 1) > 1}
        if on:
            live[name] = on
    return live


def _refuse_item_18(mesh, moe_every, int8_compute, quantized_cache) -> None:
    """The `TransformerLM` knobs a live ``model``/``fsdp`` axis does not
    carry yet, refused naming ROADMAP item 18."""
    if moe_every:
        refuse_unported_axes(mesh, "a MoE TransformerLM", also=ITEM_18_AXES)
    if int8_compute:
        refuse_unported_axes(mesh, "int8_compute", also=ITEM_18_AXES)
    if quantized_cache:
        refuse_unported_axes(mesh, "quantized_cache", also=(MODEL_AXIS,))
