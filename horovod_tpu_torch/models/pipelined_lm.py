"""Decoder-only LM partitioned into pipeline stages over the ``pipe`` axis —
port of `horovod_tpu.models.pipelined_lm`.

Every transformer-block parameter is a ``[n_layers, ...]`` stack in the JAX
model's layout and under its names — ``ln1``, ``qkv [L, d, 3d]``,
``attn_out [L, d, d]``, ``ln2``, ``mlp_up [L, d, 4d]``, ``mlp_down [L, 4d,
d]`` — beside ``embed [vocab, d]``, ``ln_f [d]`` and ``lm_head [d,
vocab]``, so `convert.pipelined_params_from_flax` copies arrays. On a mesh
with a live ``pipe`` axis of S ranks each rank holds its stage's rows of
every stack (`param_specs`: dim 0 on ``pipe``) and runs them as one stage
of a schedule (`parallel.pipeline`): ``gpipe``, ``1f1b`` or
``interleaved`` (``n_virtual`` chunks a rank; the stacks are then stored
in placement order, `to_interleaved_order` / `to_logical_order`). The
embedding, ``ln_f`` and ``lm_head`` are replicated: every stage embeds the
tokens (stage 0's feed the pipeline) and runs the head on the outputs the
last stage broadcasts.

With a live ``model`` axis every stage runs Megatron TP (JAX's ``_block``):
``qkv`` and ``mlp_up`` are column-parallel (their last dim on ``model``;
``qkv``'s columns are head-major, ``[h, 3, D]``, so the contiguous cut is
the cut by heads), ``attn_out`` and ``mlp_down`` row-parallel, behind
Megatron's f and g (`collectives.enter_group` / `leave_group`, one sum
over ``model`` a residual join).

The block is JAX's: `_layernorm` (f32 statistics, centred variance, eps
1e-6, a scale and no bias), RoPE, causal attention through
`ops.flash_attention` (B1 forward, B2/B3 backward on the card; ``window``
a sliding band over global positions), a tanh-GELU MLP at 4× and the f32
logits head. Without a mesh, or with ``pipe`` = 1, the layers run in
sequence (JAX's scan), with the mesh's other axes as on the pipe.

Packed rows: ``segment_ids`` turn into per-document RoPE positions
(`transformer.packed_positions`, on the whole row before any ``seq`` cut)
and mask attention to equal ids; both reach the stages as the schedule's
``extras``, per-microbatch constants that never ride the handoffs.

Sequence parallelism (a live ``seq`` axis of n ranks, pp × sp): as in
`transformer.TransformerLM`, the model takes this rank's ``[B, T/n]``
column block of the tokens (and of ``segment_ids``) and returns its block
of the logits, so each stage's activations carry T/n tokens (JAX's
``act_spec``). RoPE positions are global (block c starts at c·T/n; packed
positions come from the ids gathered over the ``seq`` group), and
attention is `ops.attention.ring_flash_attention` over the ``seq``
subgroup, with the segment ids and the window. The handoffs go over the
``pipe`` subgroup: the next stage at the same ``(data, seq)`` position.

``mlp="moe"`` routes every block's MLP through ``n_experts`` expert FFNs
(JAX's ``_moe_mlp``: the GShard dense dispatch of `models.moe` over
``router [L, d, E]``, ``moe_up [L, E, d, 4d]`` and ``moe_down [L, E, 4d,
d]``, which replace the dense stacks). The router runs in f32 and alike
on every rank; on a live ``expert`` axis each rank keeps its experts'
columns of the dispatch and combine one-hots (the stacks' E dim on
``expert``), on a live ``model`` axis the experts' hidden dim is cut too,
and one sum over ``expert`` and ``model`` joins the residual, between
`collectives.enter_group` on the gates and the tokens and `leave_group`.
Routing is `models.moe.route_tokens`, the `MoEMlp` layer's. On a live
``pipe`` axis dispatch groups are cut from this rank's tokens of a
microbatch, as JAX's ``shard_map`` does; the load-balance loss and the
kept-slot fraction ride the schedules' ``with_aux`` channel and are summed
over ``pipe`` and averaged over ``data``, ``fsdp`` and ``seq``
(`_mesh_mean`). Without one the layers run in sequence, and JAX's GSPMD
groups the global batch: so does the port (`models.moe.grouping_plan`
over the model's `token_shards`, which the `Trainer` sets), whose aux
values are then already global. Both are sown as JAX sows them
(`training.train_state.sow`): ``losses/moe_load_balance`` in training,
``metrics/moe_drop_rate`` in every forward.

Each rank feeds its batch shard, ``b`` rows of the global ``b·dp``: JAX's
microbatch clamp ``max(1, min(n_micro, b_global // dp))`` is ``min(n_micro,
b)`` here, and its batch check and error keep the global count. The
parameters are drawn whole from ``seed`` (flax's initializers: lecun-normal
dense stacks with the layer dim in the fan-in, the expert stacks with
their layer and expert dims as batch dims, N(0, 1) embedding, unit scales)
and cut, so a sharded model starts from the one-rank weights. JAX's init
probe, which may degrade the interleaved schedule to v = 1, has no
counterpart: the port's parameters exist at construction, so every forward
is a real one and takes the interleaved schedule's check.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.moe import (
    TokenShards, lecun_normal_, route_tokens,
)
from horovod_tpu_torch.models.transformer import (
    _dtype, _full_shapes, live_placements, packed_positions, rope,
)
from horovod_tpu_torch.ops.attention import ring_flash_attention
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
)
from horovod_tpu_torch.parallel.pipeline import (
    interleaved_layer_order, spmd_pipeline, spmd_pipeline_1f1b,
    spmd_pipeline_interleaved, stage_slice_size,
)
from horovod_tpu_torch.runtime import resolve_device
from horovod_tpu_torch.training.train_state import sow

# The per-layer stacks, in the JAX model's creation order (the dense
# model's; an MoE model's replace the MLP pair), and the dim of each (after
# the leading layer dim) that Megatron TP cuts over `model`: column-parallel
# kernels their output dim, row-parallel their input dim.
_STACKED = ("ln1", "qkv", "attn_out", "ln2", "mlp_up", "mlp_down")
_MOE_STACKED = ("ln1", "qkv", "attn_out", "ln2", "router", "moe_up",
                "moe_down")
_ALL_STACKED = _STACKED + ("router", "moe_up", "moe_down")
_TP_DIM = {"qkv": 1, "mlp_up": 1, "attn_out": 0, "mlp_down": 0}
# The expert stacks' placements after the layer dim: E on `expert`, the
# hidden dim on `model` (JAX's `_stack_specs`).
_MOE_DIMS = {"moe_up": {0: EXPERT_AXIS, 2: MODEL_AXIS},
             "moe_down": {0: EXPERT_AXIS, 1: MODEL_AXIS}}
# The expert stacks' batch dims (flax's ``lecun_normal(batch_axis=...)``):
# their fan-in is the input dim alone.
_BATCH_DIMS = {"router": 1, "moe_up": 2, "moe_down": 2}
_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _layernorm(x, scale, eps: float = 1e-6):
    """The JAX model's LayerNorm: f32 mean and centred variance, a scale,
    the result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


class _MeshMean(torch.autograd.Function):
    """The mean over the gradient group (``data``, ``fsdp``, ``seq``)
    forward, JAX's ``pmean``; backward the cotangent ÷ the ``seq`` size.
    Each rank owes the gradient of its own tokens: the optimizer sums a
    gradient over the group and divides by the data shards alone."""

    @staticmethod
    def forward(ctx, x, group, n: int, sp: int):
        ctx.sp = sp
        return collectives.all_reduce_sum(x.contiguous(), group) / n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.sp, None, None, None


class PipelinedLM(nn.Module):
    """Causal LM ``[B, T] -> [B, T, vocab]`` (f32 logits) with
    pipeline-parallel blocks; the JAX model's fields (module docstring).
    ``n_micro`` microbatches a step; a rank's batch must divide into
    them."""

    def __init__(self, vocab_size: int = 256, d_model: int = 256,
                 n_heads: int = 8, n_layers: int = 4, n_micro: int = 4,
                 window: int | None = None, compute_dtype=torch.float32,
                 mesh=None, schedule: str = "gpipe", n_virtual: int = 2,
                 mlp: str = "dense", n_experts: int = 8, moe_k: int = 2,
                 capacity_factor: float = 1.25, moe_aux_coef: float = 1e-2,
                 moe_group_size: int = 1024, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        # The JAX model's checks, in its order.
        if mlp not in ("dense", "moe"):
            raise ValueError(f"mlp must be 'dense' or 'moe', got {mlp!r}")
        if schedule not in _SCHEDULES:
            raise ValueError(
                f"schedule must be 'gpipe', '1f1b' or 'interleaved', "
                f"got {schedule!r}"
            )
        shape = mesh.shape if mesh is not None else {}
        ep = shape.get(EXPERT_AXIS, 1)
        if ep > 1 and mlp != "moe":
            raise ValueError(
                f"mesh has expert={ep} but mlp={mlp!r}; the expert axis "
                f"needs mlp='moe'"
            )
        if mlp == "moe" and n_experts % ep != 0:
            raise ValueError(
                f"n_experts ({n_experts}) must divide over the expert axis "
                f"({ep})"
            )
        self.pipe = shape.get(PIPE_AXIS, 1)
        self.sp, self.ep = shape.get(SEQ_AXIS, 1), ep
        self.tp = shape.get(MODEL_AXIS, 1)
        if self.tp > 1 and (n_heads % self.tp or (4 * d_model) % self.tp):
            raise ValueError(
                f"n_heads ({n_heads}) and 4*d_model ({4 * d_model}) must "
                f"divide over the model axis ({self.tp}) for in-stage TP"
            )
        if self.pipe > 1:
            stage_slice_size(n_layers, self.pipe)  # validates divisibility
            if schedule == "interleaved" and n_layers % (
                    self.pipe * n_virtual):
                raise ValueError(
                    f"n_layers ({n_layers}) must divide into pipe "
                    f"({self.pipe}) x n_virtual ({n_virtual}) chunks"
                )
        self.vocab_size, self.d_model, self.n_heads = (vocab_size, d_model,
                                                       n_heads)
        self.n_layers, self.n_micro = n_layers, n_micro
        self.window = window
        self.compute_dtype = _dtype(compute_dtype)
        self.mesh, self.schedule, self.n_virtual = mesh, schedule, n_virtual
        self.mlp, self.n_experts, self.moe_k = mlp, n_experts, moe_k
        self.capacity_factor, self.moe_aux_coef = capacity_factor, moe_aux_coef
        self.moe_group_size = moe_group_size
        self.stacks = _MOE_STACKED if mlp == "moe" else _STACKED
        if mlp == "moe":
            self.sown: dict = {}  # `train_state.sow`'s channel
        # Dispatch groups are cut from the batch's tokens: an MoE model's
        # function depends on its batch size (`checkpoint.export_serving`).
        self.batch_polymorphic = mlp != "moe"
        # A pipelined step runs eagerly on NCCL too (`training.graphs`: its
        # handoffs are not captured).
        self.eager_only = self.pipe > 1
        # Where this rank's tokens sit in the global batch (the sequential
        # MoE path groups the global batch; the `Trainer` sets it).
        self.token_shards = TokenShards.of(mesh)
        d, L, e = d_model, n_layers, n_experts
        shapes = {"ln1": (L, d), "qkv": (L, d, 3 * d),
                  "attn_out": (L, d, d), "ln2": (L, d)}
        if mlp == "moe":
            shapes.update(router=(L, d, e), moe_up=(L, e, d, 4 * d),
                          moe_down=(L, e, 4 * d, d))
        else:
            shapes.update(mlp_up=(L, d, 4 * d), mlp_down=(L, 4 * d, d))
        shapes.update(embed=(vocab_size, d), ln_f=(d,),
                      lm_head=(d, vocab_size))
        for name, s in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(s)))
        self.full_shapes: dict = {}
        self.reset_parameters(seed)
        self._cut_parameters()
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a seeded CPU generator, on the whole
        shapes: unit scales, N(0, 1) embedding, lecun-normal kernels whose
        fan-in counts every dim but the last (the layer dim of a dense
        stack included, as flax's ``lecun_normal`` does; an expert stack's
        layer and expert dims are batch dims, so its fan-in is its input
        dim: d for ``router`` and ``moe_up``, 4d for ``moe_down``)."""
        g = torch.Generator().manual_seed(seed)
        for name in (*self.stacks, "embed", "ln_f", "lm_head"):
            p = getattr(self, name)
            if name.startswith("ln"):
                p.fill_(1.0)
            elif name == "embed":
                p.copy_(torch.randn(p.shape, generator=g))
            else:
                lecun_normal_(p, g, math.prod(
                    p.shape[_BATCH_DIMS.get(name, 0):-1]))

    def _cut_parameters(self) -> None:
        """Replace each parameter placed on a live ``pipe`` or ``model``
        axis (`param_specs`) by this rank's part (``cuts``: name →
        placement), keeping its whole shape in ``full_shapes``."""
        self.cuts: dict = {}
        if self.mesh is None:
            return
        for name, on in live_placements(param_specs(self, self.mesh),
                                        self.mesh).items():
            whole = getattr(self, name).detach()
            self.full_shapes[name] = tuple(whole.shape)
            setattr(self, name, nn.Parameter(shard_lib.shard_tensor(
                whole, name, on, self.mesh).clone()))
            self.cuts[name] = on

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def reduces_over_ranks(self) -> bool:
        """The forward's collectives (Megatron's f and g, the ring, the
        expert sums, the handoffs, the routing over the token shards): a
        step under gloo with them runs eagerly (`training.graphs`)."""
        return (max(self.pipe, self.tp, self.sp, self.ep) > 1
                or (self.mlp == "moe" and self.token_shards.count > 1))

    @property
    def model_group(self):
        return (self.mesh.group(MODEL_AXIS) if self.tp > 1
                else collectives.SELF)

    def _group(self, axis: str):
        """The ``axis`` subgroup of the mesh (`collectives.SELF` without
        one)."""
        return (self.mesh.group(axis) if self.mesh is not None
                else collectives.SELF)

    def config(self) -> dict:
        """JSON-serializable hyperparameters (`PipelinedLM(**config)` on
        no mesh)."""
        return {"vocab_size": self.vocab_size, "d_model": self.d_model,
                "n_heads": self.n_heads, "n_layers": self.n_layers,
                "n_micro": self.n_micro, "window": self.window,
                "compute_dtype": str(self.compute_dtype).removeprefix(
                    "torch."),
                "schedule": self.schedule, "n_virtual": self.n_virtual,
                "mlp": self.mlp, "n_experts": self.n_experts,
                "moe_k": self.moe_k, "capacity_factor": self.capacity_factor,
                "moe_aux_coef": self.moe_aux_coef,
                "moe_group_size": self.moe_group_size}

    def unsharded(self) -> "PipelinedLM":
        """A model of this configuration without a mesh, on this model's
        device, holding its whole weights (gathered over the mesh's
        groups: a collective every rank of the mesh calls at one point).
        The clone runs its layers in row order, so an interleaved model's
        placement-ordered stacks are put back in logical order."""
        sd = self.state_dict()
        if self.cuts:
            from horovod_tpu_torch.models.convert import gather_state_dict

            sd = gather_state_dict(sd, self.mesh, self.cuts)
        if self.schedule == "interleaved" and self.pipe > 1:
            sd = to_logical_order(sd, self.n_layers, self.pipe,
                                  self.n_virtual)
        plain = PipelinedLM(**self.config(), device=self.device)
        plain.load_state_dict(sd)
        return plain

    def forward(self, tokens, *, train: bool = False, segment_ids=None,
                dropout_seed=None):
        """Logits ``[B, T, vocab]`` in f32 (on a live ``seq`` axis this
        rank's ``[B, T/n]`` block in, its logits out). ``segment_ids``
        ``[B, T]`` packs documents. ``train`` gates the MoE load-balance
        sow; ``dropout_seed`` (the Trainer's contract) changes nothing: the
        model has no dropout."""
        del dropout_seed
        b, t = tokens.shape
        if segment_ids is not None and tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [B, T] = {(b, t)}, got "
                f"{tuple(segment_ids.shape)}"
            )
        d, cd = self.d_model, self.compute_dtype
        x = F.embedding(tokens.long(), self.embed).to(cd)
        extra = None
        if segment_ids is not None:
            extra = (segment_ids, self._packed_positions(segment_ids))
        stacks = [getattr(self, n) for n in self.stacks]
        moe = self.mlp == "moe"
        if self.pipe == 1:
            res, n_micro = self._stage(stacks, x, extra), 1
        else:
            res, n_micro = self._pipelined(stacks, x, extra)
        x, aux = res if moe else (res, None)
        if moe:
            if self.pipe > 1:  # a microbatch's groups were this rank's
                aux = {k: self._mesh_mean(v) for k, v in aux.items()}
            aux_loss = aux["aux"] / n_micro
            # The kept-slot fraction counts one-hots: it takes no gradient.
            fill = aux["fill"].detach() / (self.n_layers * n_micro)
            if train:
                sow(self, "losses", "moe_load_balance",
                    self.moe_aux_coef * aux_loss)
            sow(self, "metrics", "moe_drop_rate", 1.0 - fill)
        x = _layernorm(x.reshape(b, t, d), self.ln_f)
        return x.float() @ self.lm_head.float()

    def _packed_positions(self, segment_ids):
        """Per-document RoPE positions of this rank's tokens, computed on
        the whole rows (the ids gathered over the ``seq`` group, then cut
        back to this rank's block)."""
        if self.sp == 1:
            return packed_positions(segment_ids)
        t = segment_ids.shape[1]
        c = self.mesh.coords[SEQ_AXIS]
        with torch.no_grad():
            full = collectives.all_gather_tiled(segment_ids,
                                                self._group(SEQ_AXIS), 1)
        return packed_positions(full)[:, c * t:(c + 1) * t]

    def _mesh_mean(self, v):
        """An aux value over the mesh (JAX's ``pmean(psum(v, pipe),
        (data, fsdp, seq))``): the stages' layers summed (`leave_group`:
        each stage owes the gradient of its own layers), then the mean
        over the token shards (`_MeshMean`)."""
        v = collectives.leave_group(v, self._group(PIPE_AXIS))
        if self.mesh is None:
            return v
        n = self.mesh.data_shards * self.sp
        if n == 1:
            return v
        return _MeshMean.apply(v, self.mesh.grad_group, n, self.sp)

    def _pipelined(self, stacks, x, extra):
        """The stacks as this rank's stage of the schedule, over the
        microbatches of ``x`` (JAX's clamp and checks). Returns the
        schedule's result (the outputs ``[n_micro, mb, t, d]``; an MoE
        model's with the aux sums) and n_micro."""
        b, t, d = x.shape
        dp = self.mesh.data_shards
        n_micro = max(1, min(self.n_micro, b))
        if b % n_micro:
            raise ValueError(
                f"batch ({b * dp}) must divide into n_micro ({n_micro}) x "
                f"data axes ({dp})"
            )
        if self.schedule == "interleaved" and n_micro < self.pipe:
            raise ValueError(
                f"interleaved schedule needs n_micro ({n_micro}, after "
                f"batch clamping) >= pipe ({self.pipe}); raise the batch or "
                f"n_micro"
            )
        mb = b // n_micro
        x_micro = x.reshape(n_micro, mb, t, d)
        kw = dict(group=self.mesh.group(PIPE_AXIS),
                  with_aux=self.mlp == "moe",
                  extras=None if extra is None else tuple(
                      e.reshape(n_micro, mb, t) for e in extra))
        if self.schedule == "interleaved":
            v = self.n_virtual
            chunked = [w.reshape((v, w.shape[0] // v) + tuple(w.shape[1:]))
                       for w in stacks]
            res = spmd_pipeline_interleaved(self._stage, chunked, x_micro,
                                            n_virtual=v, **kw)
        elif self.schedule == "1f1b":
            res = spmd_pipeline_1f1b(self._stage, stacks, x_micro, **kw)
        else:
            res = spmd_pipeline(self._stage, stacks, x_micro, **kw)
        return res, n_micro

    def _stage(self, stacks, x, extra=None):
        """The layers of ``stacks`` (this stage's rows, or a chunk's) in
        order, with a packed microbatch's ``(segment_ids, positions)``;
        an MoE model's also returns its layers' aux values, summed."""
        seg, pos = extra if extra is not None else (None, None)
        auxs = []
        for i in range(stacks[0].shape[0]):
            p = dict(zip(self.stacks, (w[i] for w in stacks)))
            x = self._block(x, p, seg, pos)
            if self.mlp == "moe":
                x, aux = x
                auxs.append(aux)
        if self.mlp != "moe":
            return x
        return x, {k: torch.stack([a[k] for a in auxs]).sum()
                   for k in auxs[0]}

    def _block(self, x, p, seg=None, positions=None):
        """One pre-LN block over one layer's parameters ``p`` (this model
        rank's heads and MLP features under TP, this expert rank's experts
        under EP; this seq rank's tokens, attention around the ``seq``
        ring under SP), f and g around the Megatron pair."""
        mb, t, d = x.shape
        hd = d // self.n_heads
        h_local = self.n_heads // self.tp
        cd, group = self.compute_dtype, self.model_group
        hidden = collectives.enter_group(_layernorm(x, p["ln1"]), group)
        fused = (hidden @ p["qkv"].to(cd)).reshape(mb, t, h_local, 3 * hd)
        q, k, v = fused.split(hd, dim=-1)
        if positions is None:
            base = self.mesh.coords[SEQ_AXIS] * t if self.sp > 1 else 0
            positions = (base + torch.arange(t, device=x.device)).expand(
                mb, t)
        q, k = rope(q, positions), rope(k, positions)
        if self.sp > 1:
            att = ring_flash_attention(q, k, v, group=self._group(SEQ_AXIS),
                                       causal=True, segment_ids=seg,
                                       window=self.window)
        else:
            att = flash_attention(q, k, v, causal=True, window=self.window,
                                  q_segment_ids=seg, kv_segment_ids=seg)
        out = att.reshape(mb, t, h_local * hd) @ p["attn_out"].to(cd)
        x = x + collectives.leave_group(out, group)
        if self.mlp == "moe":
            mixed, aux = self._moe_mlp(_layernorm(x, p["ln2"]), p)
            return x + mixed, aux
        hidden = collectives.enter_group(_layernorm(x, p["ln2"]), group)
        hidden = F.gelu(hidden @ p["mlp_up"].to(cd), approximate="tanh")
        return x + collectives.leave_group(hidden @ p["mlp_down"].to(cd),
                                           group)

    def _moe_mlp(self, x, p):
        """JAX's ``_moe_mlp`` over one layer's expert stacks
        (`models.moe.route_tokens`: the f32 router and top-k, renormalised
        for k > 1, the load-balance loss from the top-1 one-hot, cumsum
        slotting at capacity ``max(1, int(k·s/E·cf))``), this rank's
        experts (this model rank's part of their hidden dim) between
        entering and leaving the ``expert`` and ``model`` groups. Without
        a pipe axis the groups are the global batch's, and the aux values
        global. Returns ``(mixed, {"aux", "fill"})``."""
        mb, t, d = x.shape
        shards = self.token_shards if self.pipe == 1 else TokenShards()
        tokens = x.reshape(mb * t, d)
        probs = torch.softmax(tokens.float() @ p["router"].float(), dim=-1)
        cd = self.compute_dtype

        def experts(expert_in):
            h = F.gelu(torch.einsum("necd,edh->nech", expert_in,
                                    p["moe_up"].to(cd)), approximate="tanh")
            return torch.einsum("nech,ehd->necd", h, p["moe_down"].to(cd))

        per = self.n_experts // self.ep
        lo = per * (self.mesh.coords[EXPERT_AXIS] if self.ep > 1 else 0)
        groups = (self._group(EXPERT_AXIS) if self.ep > 1
                  else collectives.SELF, self.model_group)
        mixed, stats = route_tokens(
            tokens, probs, shards.plan(mb, t, self.moe_group_size), shards,
            experts, k=self.moe_k, capacity_factor=self.capacity_factor,
            router="top_k", expert_range=(lo, lo + per), groups=groups,
            compute_dtype=cd)
        return mixed.reshape(mb, t, d).to(x.dtype), stats


def _stack_specs(tp: bool) -> dict:
    """{name: {dim: axis}} of the per-layer stacks after their leading
    layer dim (JAX's ``_stack_specs``): the Megatron dim on ``model`` when
    TP is live, the expert stacks' E on ``expert`` (and their hidden dim
    on ``model`` with TP), the router replicated."""
    specs = {name: ({_TP_DIM[name]: MODEL_AXIS}
                    if tp and name in _TP_DIM else {})
             for name in _ALL_STACKED}
    for name, dims in _MOE_DIMS.items():
        specs[name] = {dim: ax for dim, ax in dims.items()
                       if tp or ax != MODEL_AXIS}
    return specs


def param_specs(module_or_state_dict, mesh) -> dict:
    """Per parameter name, its placement ``{dim: axis}``: each per-layer
    stack dim 0 on ``pipe`` (and Megatron's dim on ``model`` when that
    axis is live; an expert stack's E on ``expert``), everything else
    replicated ({}). ``module_or_state_dict``
    is a `PipelinedLM` (its parameters counted whole) or a full state
    dict."""
    stack = _stack_specs(mesh.shape.get(MODEL_AXIS, 1) > 1)
    specs = {}
    for name in _full_shapes(module_or_state_dict):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in stack:
            specs[name] = {0: PIPE_AXIS, **{1 + dim: ax for dim, ax in
                                            stack[leaf].items()}}
        else:
            specs[name] = {}
    return specs


def _reorder_stacks(state_dict, order) -> dict:
    """A row permutation applied to every per-layer stack."""
    idx = torch.as_tensor(np.asarray(order, dtype=np.int64))
    return {name: (t.index_select(0, idx.to(t.device))
                   if name.rsplit(".", 1)[-1] in _ALL_STACKED else t)
            for name, t in state_dict.items()}


def to_interleaved_order(state_dict, n_layers: int, n_stages: int,
                         n_virtual: int) -> dict:
    """Logical-order stacks → the placement order an interleaved pipe mesh
    stores (physical row p = logical layer
    `interleaved_layer_order`\\ ``(...)[p]``)."""
    return _reorder_stacks(
        state_dict, interleaved_layer_order(n_layers, n_stages, n_virtual))


def to_logical_order(state_dict, n_layers: int, n_stages: int,
                     n_virtual: int) -> dict:
    """Inverse of `to_interleaved_order`."""
    order = interleaved_layer_order(n_layers, n_stages, n_virtual)
    return _reorder_stacks(state_dict, np.argsort(order))
