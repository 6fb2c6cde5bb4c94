"""Encoder-decoder (seq2seq) transformer — port of
`horovod_tpu.models.seq2seq`.

The JAX model's architecture and numerics: pre-LN blocks (the LM's
`LayerNorm`, split-half RoPE, tanh-GELU MLP at 4×), f32 parameters with
matmuls in ``compute_dtype`` and logits in ``logits_dtype``. Three
attention sites, each one call of `_attention`:

* **encoder self-attention** — bidirectional over the source, padding
  masked by segment ids (``src_valid``: 1 for a real token, 0 for
  ``pad_id``);
* **decoder self-attention** — causal over the target;
* **cross-attention** — the target's queries against the encoder memory,
  non-causal with Tq ≠ Tk, query ids the constant 1 and the memory's ids
  ``src_valid``, so the mask is the source padding. No RoPE on the cross
  q/k (source and target positions are different spaces).

On the card the local path is `ops.flash_attention` (kernel B1 forward, B2
and B3 backward); ``attn="dense"`` takes `ops.attention.dense_attention`.
On a live ``seq`` axis the three sites run as rings over the ``seq``
group: the encoder and the decoder's self-attention through
`ring_flash_attention` (the encoder with its ids, non-causal), the
cross-attention through `ring_cross_attention` (the memory's ids rotate
with their block, the query ids stay). Each rank holds its ``[B, S/n]`` and
``[B, T/n]`` shards, and RoPE positions are global: shard c of the source
starts at ``c·S/n``, of the target at ``c·T/n``.

Decode mode (``decode_tokens(..., max_decode_len=L)`` creates the cache,
``decode_tokens(..., cache=cache)`` steps it): each decoder block keeps a
growing self-attention cache ``[B, L, H, D]`` written at ``index``, and a
static cross K/V cache ``[B, S, H, D]`` written once, from the memory, by
the call that creates the cache; steps read it and never touch the memory
or ``cross_kv``. The cache also holds ``src_valid``. The cache's tensors
are written in place (as the LM's are). `make_seq2seq_generate_fn` encodes
once, runs the BOS prefill, and then single-token steps as replays of one
captured step (`models.decoding.StepGraph`). Decode mode refuses a live
``seq`` axis, as the JAX model does.

Dropout takes ``dropout_seed`` (the trainer's per-step seed): encoder block
i's two sites are 2i and 2i + 1, decoder block j's three are 2·n_enc + 3j,
+1, +2.

Tensor parallelism and FSDP, as JAX's `param_specs` places the model: on a
live ``model`` axis of tp ranks each rank holds ``n_heads/tp`` heads of
each of the three attention sites and ``4·d/tp`` MLP features. ``qkv``,
``cross_q``, ``cross_kv`` and ``mlp_up`` are column-parallel behind
Megatron's f (`collectives.enter_group`), ``attn_out``, ``cross_out`` and
``mlp_down`` row-parallel behind g (`collectives.leave_group`); the fused
``qkv`` and ``cross_kv`` rows are cut per part by heads
(`parallel.sharding`). The head is `LMHead`'s vocab-parallel path. The
decode caches hold the local heads: ``[B, L, H/tp, D]`` self caches and
the static cross K/V. On a live ``fsdp`` axis every ≥2-D parameter holds
its shard and is gathered at use (`parallel.sharding.weight`). The weights
are drawn whole from the seed and cut (`models.transformer.cut_parameters`),
so a sharded model starts from the one-rank weights; `unsharded` gathers
them back, and ``clone(sharding=ShardingConfig())`` of a cut model is that
gathered model (a collective).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.decoding import (
    StepGraph, _sample, _steps, _token_step, check_sampling_params, make_rng,
)
from horovod_tpu_torch.models.moe import lecun_normal_
from horovod_tpu_torch.models.transformer import (
    LayerNorm, LMHead, ShardingConfig, _cache_write, _dtype, _full_shapes,
    _matmul_f32, cut_parameters, live_placements,
    param_specs as lm_param_specs, rope,
)
from horovod_tpu_torch.ops.attention import (
    _BIG_NEG, dense_attention, ring_cross_attention, ring_flash_attention,
)
from horovod_tpu_torch.ops.dropout import dropout
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import FSDP_AXIS, MODEL_AXIS, SEQ_AXIS
from horovod_tpu_torch.runtime import resolve_device

_DECODE_ON_SEQ = (
    "seq2seq decode mode does not compose with a live 'seq' axis — "
    "generate on a mesh without sequence parallelism"
)


def _attention(cfg: ShardingConfig, q, k, v, *, causal: bool, q_ids=None,
               kv_ids=None, cross: bool = False):
    """One attention dispatch for the three call sites (module
    docstring), with the JAX model's refusals."""
    if cfg.seq_parallel:
        if cfg.attn != "ring":
            raise ValueError(
                "sequence-parallel Seq2SeqTransformer supports attn='ring' "
                f"only (got {cfg.attn!r}) — the dense/Ulysses paths are "
                "decoder-only territory"
            )
        if cross:
            return ring_cross_attention(q, k, v, group=cfg.seq_group,
                                        q_segment_ids=q_ids,
                                        kv_segment_ids=kv_ids)
        if q_ids is not None:
            # Encoder self-attention: the ring takes one segment_ids for
            # both sides, so an asymmetric mask must not lose its kv ids.
            if q_ids is not kv_ids:
                raise ValueError(
                    "sequence-parallel self-attention needs q_ids and "
                    "kv_ids to be the same array (asymmetric masks are "
                    "cross=True territory)"
                )
            return ring_flash_attention(q, k, v, group=cfg.seq_group,
                                        causal=causal, segment_ids=q_ids)
        return ring_flash_attention(q, k, v, group=cfg.seq_group,
                                    causal=causal)
    if cfg.attn == "dense":
        return dense_attention(q, k, v, causal=causal, q_segment_ids=q_ids,
                               kv_segment_ids=kv_ids).to(q.dtype)
    return flash_attention(q, k, v, causal=causal, q_segment_ids=q_ids,
                           kv_segment_ids=kv_ids)


class _Layer(nn.Module):
    """What the encoder and decoder blocks share: the projections in the
    compute dtype (column-parallel behind f, row-parallel behind g on a
    live ``model`` axis), the MLP and the seeded dropout. Its layers are
    built whole; the model cuts them to this rank's ``heads``."""

    def __init__(self, d_model: int, n_heads: int, dropout: float,
                 compute_dtype: torch.dtype, sharding: ShardingConfig):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.head_dim = d_model // n_heads
        self.heads = n_heads // sharding.tp  # this rank's
        self.dropout, self.compute_dtype = dropout, compute_dtype
        self.sharding = sharding
        hd = n_heads * self.head_dim
        self.qkv = nn.Linear(d_model, 3 * hd, bias=False)
        self.attn_out = nn.Linear(hd, d_model, bias=False)
        self.mlp_up = nn.Linear(d_model, 4 * d_model, bias=False)
        self.mlp_down = nn.Linear(4 * d_model, d_model, bias=False)

    def _dense(self, layer: nn.Linear, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), shard_lib.weight(layer).to(cd))

    def _column(self, layer: nn.Linear, x):
        """A column-parallel projection behind Megatron's f."""
        return self._dense(layer, collectives.enter_group(
            x, self.sharding.model_group))

    def _row(self, layer: nn.Linear, x):
        """A row-parallel projection: the partial products summed over
        ``model`` (Megatron's g)."""
        return collectives.leave_group(self._dense(layer, x),
                                       self.sharding.model_group)

    def _heads(self, x):
        b, t, _ = x.shape
        return x.view(b, t, self.heads, self.head_dim)

    def _split(self, x):
        """A fused projection's blocks (q|k|v, k|v) at this rank's heads."""
        return (self._heads(a)
                for a in x.split(self.heads * self.head_dim, -1))

    def _self_qkv(self, h, positions):
        q, k, v = self._split(self._column(self.qkv, h))
        return rope(q, positions), rope(k, positions), v

    def _drop(self, x, train, seed, site):
        if not (train and self.dropout > 0.0):
            return x
        if seed is None:
            raise ValueError(
                "train=True with dropout > 0 needs dropout_seed (the "
                "trainer passes its per-step seed)"
            )
        return dropout(x, self.dropout, seed, site)

    def _mlp(self, x, train, seed, site):
        h = self._column(self.mlp_up, self.ln_mlp(x))
        h = self._row(self.mlp_down, F.gelu(h, approximate="tanh"))
        return x + self._drop(h, train, seed, site)


class EncoderBlock(_Layer):
    """Bidirectional self-attention over the source, then the MLP."""

    def __init__(self, d_model, n_heads, dropout, compute_dtype, sharding):
        super().__init__(d_model, n_heads, dropout, compute_dtype, sharding)
        self.ln_attn = LayerNorm(d_model, compute_dtype)
        self.ln_mlp = LayerNorm(d_model, compute_dtype)

    def forward(self, x, positions, src_valid, *, train=False,
                dropout_seed=None, site: int = 0):
        q, k, v = self._self_qkv(self.ln_attn(x), positions)
        # Pad positions (id 0) are disjoint from real tokens (id 1), so no
        # real position ever sees a pad. Pad queries still see each other
        # (segment masking is equality-based), so pad rows of the memory
        # are garbage — harmless only because the cross-attention mask
        # drops them downstream; any new consumer of the memory (e.g.
        # mean-pooling) must mask too.
        out = _attention(self.sharding, q, k, v, causal=False,
                         q_ids=src_valid, kv_ids=src_valid)
        out = self._row(self.attn_out, out.reshape(x.shape[0], x.shape[1],
                                                   -1))
        x = x + self._drop(out, train, dropout_seed, site)
        return self._mlp(x, train, dropout_seed, site + 1)


class DecoderBlock(_Layer):
    """Causal self-attention over the target, cross-attention into the
    encoder memory, then the MLP. ``cache`` (decode mode): this block's
    ``{"k", "v", "cross_k", "cross_v"}``, written in place."""

    def __init__(self, d_model, n_heads, dropout, compute_dtype, sharding):
        super().__init__(d_model, n_heads, dropout, compute_dtype, sharding)
        hd = n_heads * self.head_dim
        self.ln_self = LayerNorm(d_model, compute_dtype)
        self.ln_cross = LayerNorm(d_model, compute_dtype)
        self.ln_mlp = LayerNorm(d_model, compute_dtype)
        self.cross_q = nn.Linear(d_model, hd, bias=False)
        self.cross_kv = nn.Linear(d_model, 2 * hd, bias=False)
        self.cross_out = nn.Linear(hd, d_model, bias=False)

    def forward(self, x, positions, memory, mem_valid, *, train=False,
                dropout_seed=None, site: int = 0, cache=None,
                decode_index=None, fresh: bool = False):
        b, t, _ = x.shape
        cfg = self.sharding
        q, k, v = self._self_qkv(self.ln_self(x), positions)
        if cache is not None:
            out = self._cached_self_attention(q, k, v, cache, decode_index,
                                              fresh)
        else:
            out = _attention(cfg, q, k, v, causal=True)
        out = self._row(self.attn_out, out.reshape(b, t, -1))
        x = x + self._drop(out, train, dropout_seed, site)

        q = self._heads(self._column(self.cross_q, self.ln_cross(x)))
        if cache is not None:
            out = self._cached_cross_attention(q, memory, mem_valid, cache,
                                               fresh)
        else:
            ck, cv = self._split(self._column(self.cross_kv, memory))
            # Tq = target length, Tk = source length: the kernel's cross
            # grids. Non-causal; query ids the constant 1, so the mask is
            # the source-side padding mask.
            q_ids = torch.ones((b, t), dtype=torch.int32, device=x.device)
            out = _attention(cfg, q, ck, cv, causal=False, q_ids=q_ids,
                             kv_ids=mem_valid, cross=True)
        out = self._row(self.cross_out, out.reshape(b, t, -1))
        x = x + self._drop(out, train, dropout_seed, site + 1)
        return self._mlp(x, train, dropout_seed, site + 2)

    def _cached_self_attention(self, q, k, v, cache, idx, fresh):
        """The growing cache: the prefill writes [0:T) and (T > 1)
        attends causally over the fresh K/V; a step writes at ``idx`` and
        attends over the valid prefix."""
        t = q.shape[1]
        _cache_write(cache, {"k": k, "v": v}, idx, t)
        if t > 1 and fresh:
            return _attention(self.sharding, q, k, v, causal=True)
        length = cache["k"].shape[1]
        qpos = idx + torch.arange(t, dtype=torch.int32, device=q.device)
        kpos = torch.arange(length, dtype=torch.int32, device=q.device)
        valid = (kpos[None, :] <= qpos[:, None])[None, None]
        return _cached_softmax(q, cache["k"], cache["v"], valid)

    def _cached_cross_attention(self, q, memory, mem_valid, cache, fresh):
        """Cross-attention against the static cross K/V cache: computed
        from the memory by the call that creates the cache, read by every
        step after it."""
        if fresh:
            ck, cv = self._split(self._column(self.cross_kv, memory))
            cache["cross_k"], cache["cross_v"] = ck, cv
        valid = mem_valid.bool()[:, None, None, :]
        return _cached_softmax(q, cache["cross_k"], cache["cross_v"], valid)


def _cached_softmax(q, k, v, valid):
    """Dense attention of ``q [B, t, H, D]`` over ``k``/``v`` ``[B, L, H,
    D]`` with ``valid`` broadcastable to ``[B, H, t, L]``: f32 scores,
    the softmax's probabilities in v's dtype, an f32 product cast to q's
    dtype (the JAX model's einsums)."""
    b, t, h, d = q.shape
    length = k.shape[1]
    qh = q.permute(0, 2, 1, 3).reshape(b * h, t, d)
    kh = k.to(q.dtype).permute(0, 2, 3, 1).reshape(b * h, d, length)
    s = _matmul_f32(qh, kh).view(b, h, t, length) * d ** -0.5
    s = torch.where(valid, s, torch.full_like(s, _BIG_NEG))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    vh = v.permute(0, 2, 1, 3).reshape(b * h, length, d)
    out = _matmul_f32(p.reshape(b * h, t, length), vh.to(p.dtype))
    return out.view(b, h, t, d).permute(0, 2, 1, 3).to(q.dtype)


class Encoder(nn.Module):
    def __init__(self, vocab_size, d_model, n_heads, n_layers, dropout,
                 compute_dtype, sharding, pad_id):
        super().__init__()
        self.pad_id, self.compute_dtype = pad_id, compute_dtype
        self.sharding = sharding
        self.embed = nn.Embedding(vocab_size, d_model)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, dropout, compute_dtype, sharding)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, compute_dtype)

    def forward(self, src, *, train=False, dropout_seed=None):
        b, s = src.shape
        src_valid = (src != self.pad_id).to(torch.int32)
        positions = _positions(self.sharding, b, s, src.device)
        x = _embed(self.embed, src, self.compute_dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, positions, src_valid, train=train,
                    dropout_seed=dropout_seed, site=2 * i)
        return self.ln_f(x), src_valid


class Decoder(nn.Module):
    def __init__(self, vocab_size, d_model, n_heads, n_layers, dropout,
                 compute_dtype, sharding, logits_dtype, first_site: int):
        super().__init__()
        self.compute_dtype, self.sharding = compute_dtype, sharding
        self.heads, self.head_dim = n_heads // sharding.tp, d_model // n_heads
        self.first_site = first_site
        self.embed = nn.Embedding(vocab_size, d_model)
        self.blocks = nn.ModuleList(
            DecoderBlock(d_model, n_heads, dropout, compute_dtype, sharding)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, compute_dtype)
        self.lm_head = LMHead(d_model, vocab_size, compute_dtype,
                              logits_dtype, sharding)

    def forward(self, tgt, memory, mem_valid, *, train=False,
                dropout_seed=None):
        b, t = tgt.shape
        positions = _positions(self.sharding, b, t, tgt.device)
        x = _embed(self.embed, tgt, self.compute_dtype)
        for j, blk in enumerate(self.blocks):
            x = blk(x, positions, memory, mem_valid, train=train,
                    dropout_seed=dropout_seed,
                    site=self.first_site + 3 * j)
        return self.lm_head(self.ln_f(x))

    def new_cache(self, batch: int, max_decode_len: int, device) -> dict:
        """An empty self-attention cache of ``max_decode_len`` positions a
        block at this rank's heads (the cross K/V join it at the prefill),
        and ``index``."""
        shape = (batch, max_decode_len, self.heads, self.head_dim)
        cache = {f"Block_{j}": {n: torch.zeros(shape, dtype=self.compute_dtype,
                                               device=device)
                                for n in ("k", "v")}
                 for j in range(len(self.blocks))}
        cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
        return cache

    def decode(self, tgt, memory, mem_valid, cache, max_decode_len: int):
        b, t = tgt.shape
        fresh = cache is None
        if fresh:
            if max_decode_len < t:
                raise ValueError(
                    f"max_decode_len ({max_decode_len}) < input length ({t})"
                )
            cache = self.new_cache(b, max_decode_len, tgt.device)
            cache["src_valid"] = mem_valid
        idx = cache["index"]
        positions = (idx + torch.arange(t, dtype=torch.int32,
                                        device=tgt.device)).expand(b, t)
        x = _embed(self.embed, tgt, self.compute_dtype)
        for j, blk in enumerate(self.blocks):
            x = blk(x, positions, memory, cache["src_valid"],
                    cache=cache[f"Block_{j}"], decode_index=idx, fresh=fresh)
        logits = self.lm_head(self.ln_f(x))
        return logits, {**cache, "index": idx + t}


def _embed(embed: nn.Embedding, tokens, dtype):
    """The lookup over the whole table (gathered at use on ``fsdp``)."""
    return F.embedding(tokens.long(), shard_lib.weight(embed)).to(dtype)


def _positions(cfg: ShardingConfig, b: int, t: int, device):
    """``[B, t]`` RoPE positions of this rank's shard: global ones on a
    live ``seq`` axis (shard c starts at c·t)."""
    c = cfg.mesh.coords[SEQ_AXIS] if cfg.seq_parallel else 0
    return (c * t + torch.arange(t, device=device)).expand(b, t)


# The knobs `Seq2SeqTransformer.clone` may change.
_CLONE_KNOBS = ("dropout", "sharding")


class Seq2SeqTransformer(nn.Module):
    """Sequence-to-sequence transduction: ``{"src": [B, S], "tgt": [B, T]}
    -> [B, T, vocab]`` teacher-forced logits. ``tgt`` is the decoder input
    (BOS-prefixed, one position ahead of the labels the caller passes as
    ``y``). Source and target share one id space with separate embedding
    tables.

    Parameters are created on ``device`` (default ``"cuda"``) from a seeded
    CPU generator, drawn whole and cut to this rank's ``model``/``fsdp``
    parts (module docstring); a live ``pipe`` axis replicates the model
    over its ranks, as GSPMD does with the JAX model."""

    def __init__(self, vocab_size: int = 256, d_model: int = 256,
                 n_heads: int = 8, n_enc_layers: int = 4,
                 n_dec_layers: int = 4, dropout: float = 0.1,
                 compute_dtype=torch.float32,
                 sharding: ShardingConfig | None = None,
                 logits_dtype=torch.float32, pad_id: int = 0, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        sharding = sharding or ShardingConfig()
        mesh = sharding.mesh
        if mesh is not None and n_heads % sharding.tp != 0:
            raise ValueError(
                f"n_heads ({n_heads}) must divide over the model axis "
                f"({sharding.tp}) for sharded attention"
            )
        dev = resolve_device(device)
        self.vocab_size, self.d_model, self.n_heads = vocab_size, d_model, n_heads
        self.n_enc_layers, self.n_dec_layers = n_enc_layers, n_dec_layers
        self.dropout, self.pad_id = dropout, pad_id
        self.compute_dtype = _dtype(compute_dtype)
        self.logits_dtype = _dtype(logits_dtype)
        self.sharding = sharding
        self.encoder = Encoder(vocab_size, d_model, n_heads, n_enc_layers,
                               dropout, self.compute_dtype, sharding, pad_id)
        self.decoder = Decoder(vocab_size, d_model, n_heads, n_dec_layers,
                               dropout, self.compute_dtype, sharding,
                               self.logits_dtype, first_site=2 * n_enc_layers)
        self.cuts: dict = {}
        # The forward's collectives over the model and fsdp groups: a gloo
        # step runs eagerly (`training.graphs`).
        self.reduces_over_ranks = mesh is not None and max(
            mesh.shape[MODEL_AXIS], mesh.shape[FSDP_AXIS]) > 1
        if self.reduces_over_ranks:
            self.cuts = cut_parameters(self, param_specs(self, mesh), mesh)
        self.reset_parameters(seed)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.encoder.embed.weight.device

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a seeded CPU generator: lecun-normal
        matmul weights (fan-in the input features), N(0, 1/d) embeddings,
        unit LayerNorm scales; each drawn whole and cut to this rank's
        part."""
        g = torch.Generator().manual_seed(seed)
        full = _full_shapes(self)
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            w = torch.empty(full[name])
            if name.endswith("embed.weight"):
                w = torch.randn(w.shape, generator=g) / math.sqrt(w.shape[1])
            else:
                lecun_normal_(w, g, w.shape[1])
            p.copy_(shard_lib.shard_tensor(w, name, self.cuts.get(name, {}),
                                           self.sharding.mesh))

    def config(self) -> dict:
        """The constructor's hyperparameters (without the mesh)."""
        return {"vocab_size": self.vocab_size, "d_model": self.d_model,
                "n_heads": self.n_heads, "n_enc_layers": self.n_enc_layers,
                "n_dec_layers": self.n_dec_layers, "dropout": self.dropout,
                "compute_dtype": self.compute_dtype,
                "logits_dtype": self.logits_dtype, "pad_id": self.pad_id}

    def unsharded(self) -> "Seq2SeqTransformer":
        """A model of this configuration without a mesh, on this model's
        device, holding its whole weights: gathered over the mesh's
        groups (a collective every rank of the mesh calls)."""
        sd = self.state_dict()
        if self.cuts:
            from horovod_tpu_torch.models.convert import gather_state_dict

            mesh = self.sharding.mesh
            sd = gather_state_dict(sd, mesh, live_placements(
                param_specs(self, mesh), mesh))
        plain = Seq2SeqTransformer(**self.config(), device=self.device)
        plain.load_state_dict(sd)
        return plain

    def clone(self, **overrides) -> "Seq2SeqTransformer":
        """A model with ``overrides`` (``dropout``, ``sharding``) applied
        that SHARES this model's parameter tensors (flax's
        ``Module.clone``: the JAX example decodes a sharded model's
        weights with ``clone(sharding=ShardingConfig())``). A clone that
        leaves the ``model``/``fsdp`` cut of this model holds the gathered
        weights instead (`unsharded`, a collective); one onto another cut
        raises."""
        bad = sorted(set(overrides) - set(_CLONE_KNOBS))
        if bad:
            raise ValueError(
                f"clone cannot change {bad}: the clone shares the "
                f"parameters; it may change {list(_CLONE_KNOBS)}"
            )
        sharding = overrides.get("sharding", self.sharding) or ShardingConfig()
        src = self
        if _cut_of(sharding) != _cut_of(self.sharding):
            if _cut_of(sharding):
                raise ValueError(
                    "clone cannot move the weights onto another model/fsdp "
                    f"cut ({_cut_of(self.sharding)} -> {_cut_of(sharding)}): "
                    "build the model on that mesh")
            src = self.unsharded()
        memo = {id(t): t for t in (*src.parameters(), *src.buffers())}
        new = copy.deepcopy(src, memo)
        new.dropout = overrides.get("dropout", self.dropout)
        new.sharding = sharding
        for part in (new.encoder, new.decoder):
            part.sharding = sharding
            for blk in part.blocks:
                blk.dropout, blk.sharding = new.dropout, sharding
        new.decoder.lm_head.sharding = sharding
        return new

    def forward(self, batch, *, train: bool = False, dropout_seed=None):
        """Teacher-forced logits of ``batch = {"src", "tgt"}``."""
        memory, src_valid = self.encode(batch["src"], train=train,
                                        dropout_seed=dropout_seed)
        return self.decode_tokens(batch["tgt"], memory, src_valid,
                                  train=train, dropout_seed=dropout_seed)

    def encode(self, src, *, train: bool = False, dropout_seed=None):
        """``(memory [B, S, d], src_valid [B, S] int32)``."""
        return self.encoder(src, train=train, dropout_seed=dropout_seed)

    def decode_tokens(self, tgt, memory, src_valid, *, train: bool = False,
                      dropout_seed=None, cache=None,
                      max_decode_len: int | None = None):
        """The decoder over ``tgt``: teacher-forced logits; in decode mode
        (``max_decode_len`` given: the prefill that creates the cache from
        ``memory``; or ``cache`` given: a step against it, ``memory`` and
        ``src_valid`` unused) ``(logits, cache)``, with the cache's tensors
        written in place and ``index`` advanced by T."""
        if cache is None and max_decode_len is None:
            return self.decoder(tgt, memory, src_valid, train=train,
                                dropout_seed=dropout_seed)
        if self.sharding.seq_parallel:
            raise ValueError(_DECODE_ON_SEQ)
        return self.decoder.decode(tgt, memory, src_valid, cache,
                                   max_decode_len or 0)


def param_specs(module_or_state_dict, mesh) -> dict:
    """The LM's placements (`models.transformer.param_specs`) plus the
    cross-attention projections: ``cross_q`` and ``cross_kv``
    column-parallel, ``cross_out`` row-parallel (dims of the port's
    ``[out, in]`` weights)."""
    return lm_param_specs(module_or_state_dict, mesh,
                          extra_tp_dim={"cross_q": 0, "cross_kv": 0,
                                        "cross_out": 1})


def _cut_of(cfg: ShardingConfig) -> dict:
    """The live ``model``/``fsdp`` axis sizes of ``cfg``'s mesh."""
    mesh = cfg.mesh
    return {} if mesh is None else {
        ax: mesh.shape[ax] for ax in (MODEL_AXIS, FSDP_AXIS)
        if mesh.shape[ax] > 1}


def make_seq2seq_generate_fn(model: Seq2SeqTransformer, *,
                             max_new_tokens: int, bos_id: int,
                             temperature: float = 0.0, top_k: int = 0,
                             top_p: float = 0.0, eos_id: int | None = None):
    """The seq2seq generator ``fn(src [B, S], rng=None) -> tokens [B,
    max_new_tokens]`` over ``model``'s weights: encode once, a BOS prefill
    (which writes each block's static cross K/V cache), then
    ``max_new_tokens − 1`` single-token steps, replays of one captured
    step on CUDA (``fn.steps``, a `StepGraph`). After a row emits
    ``eos_id`` its remaining positions are filled with it. ``rng`` (a
    `torch.Generator` on the model's device, default seed 0) draws the
    sampled modes; greedy ignores it. Runs under `torch.inference_mode`."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    check_sampling_params(temperature, top_p)
    if model.sharding.seq_parallel:
        raise ValueError(_DECODE_ON_SEQ)
    sampling = (temperature, top_k, top_p)
    dmodel = model.clone(dropout=0.0) if model.dropout else model
    from horovod_tpu_torch.training.graphs import (
        forward_communicates_over_host,
    )

    runner = StepGraph(None, model.device, sampled=temperature > 0.0,
                       host_collectives=forward_communicates_over_host(model))
    width = max(1, max_new_tokens - 1)

    def step(tokens, cache):
        return dmodel.decode_tokens(tokens, None, None, cache=cache)

    @torch.inference_mode()
    def run(src, rng=None):
        dev = model.device
        if rng is None:
            rng = make_rng(0, dev)
        src = torch.as_tensor(src, device=dev).to(torch.int32)
        memory, src_valid = dmodel.encode(src)
        bos = torch.full((src.shape[0], 1), bos_id, dtype=torch.int32,
                         device=dev)
        logits, cache = dmodel.decode_tokens(bos, memory, src_valid,
                                             max_decode_len=max_new_tokens)
        tok = _sample(logits[:, -1], rng, *sampling)
        done = (torch.zeros_like(tok, dtype=torch.bool) if eos_id is None
                else tok == eos_id)
        runner.bind(_token_step(step, sampling, eos_id), None)
        rest, _ = _steps(runner, (cache, tok, rng, done), max_new_tokens - 1,
                         width)
        return torch.cat([tok[:, None], rest], dim=1)

    run.steps = runner
    return run
