"""Decoder-only LM partitioned into pipeline stages over the ``pipe`` axis —
port of `horovod_tpu.models.pipelined_lm` (its dense model).

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
1e-6, a scale and no bias), RoPE at positions 0..T−1, causal attention
through `ops.flash_attention` (B1 forward, B2/B3 backward on the card), a
tanh-GELU MLP at 4× and the f32 logits head. Without a mesh, or with
``pipe`` = 1, the layers run in sequence (JAX's scan), with Megatron TP
where ``model`` is live.

Each rank feeds its batch shard, ``b`` rows of the global ``b·dp``: JAX's
microbatch clamp ``max(1, min(n_micro, b_global // dp))`` is ``min(n_micro,
b)`` here, and its batch check and error keep the global count. The
parameters are drawn whole from ``seed`` (flax's initializers: lecun-normal
stacks with the layer dim in the fan-in, N(0, 1) embedding, unit scales)
and cut, so a sharded model starts from the one-rank weights. JAX's init
probe, which may degrade the interleaved schedule to v = 1, has no
counterpart: the port's parameters exist at construction, so every forward
is a real one and takes the interleaved schedule's check.

Not ported yet (ROADMAP queue A item 12.4, the pipeline's second half):
``mlp="moe"``, ``window``, ``segment_ids`` and a live ``seq`` axis raise
`NotImplementedError` on every mesh, the sequential path included, as
JAX validates a configuration the same way on every mesh.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.moe import lecun_normal_
from horovod_tpu_torch.models.transformer import (
    _dtype, _full_shapes, live_placements, rope,
)
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

#: The ROADMAP item of what the pipelined model does not carry yet.
SECOND_HALF = "queue A item 12.4 (the pipeline's second half)"

# The per-layer stacks, in the JAX model's creation order, and the dim of
# each (after the leading layer dim) that Megatron TP cuts over `model`:
# column-parallel kernels their output dim, row-parallel their input dim.
_STACKED = ("ln1", "qkv", "attn_out", "ln2", "mlp_up", "mlp_down")
_TP_DIM = {"qkv": 1, "mlp_up": 1, "attn_out": 0, "mlp_down": 0}
_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def refuse_second_half(what: str) -> None:
    raise NotImplementedError(
        f"PipelinedLM: {what} is not ported yet — ROADMAP {SECOND_HALF}")


def _layernorm(x, scale, eps: float = 1e-6):
    """The JAX model's LayerNorm: f32 mean and centred variance, a scale,
    the result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


class PipelinedLM(nn.Module):
    """Causal LM ``[B, T] -> [B, T, vocab]`` (f32 logits) with
    pipeline-parallel blocks; the JAX model's fields (module docstring;
    the MoE ones wait for the MoE pipeline, which is refused). ``n_micro``
    microbatches a step; a rank's batch must divide into them."""

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
        if mlp == "moe":
            refuse_second_half("mlp='moe' (the MoE pipeline)")
        if window is not None:
            refuse_second_half("window (the windowed pipeline)")
        if shape.get(SEQ_AXIS, 1) > 1:
            refuse_second_half(
                f"a live 'seq' axis ({shape[SEQ_AXIS]}, pp x sp)")
        self.pipe = shape.get(PIPE_AXIS, 1)
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
        self.compute_dtype = _dtype(compute_dtype)
        self.mesh, self.schedule, self.n_virtual = mesh, schedule, n_virtual
        # The forward's collectives (Megatron's f and g, the handoffs): a
        # step under gloo runs eagerly; a pipelined one runs eagerly on
        # NCCL too (`training.graphs`: its handoffs are not captured).
        self.reduces_over_ranks = self.pipe > 1 or self.tp > 1
        self.eager_only = self.pipe > 1
        d, L = d_model, n_layers
        shapes = {"ln1": (L, d), "qkv": (L, d, 3 * d),
                  "attn_out": (L, d, d), "ln2": (L, d),
                  "mlp_up": (L, d, 4 * d), "mlp_down": (L, 4 * d, d),
                  "embed": (vocab_size, d), "ln_f": (d,),
                  "lm_head": (d, vocab_size)}
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
        fan-in counts every dim but the last (the layer dim of a stack
        included, as flax's ``lecun_normal`` does)."""
        g = torch.Generator().manual_seed(seed)
        for name in (*_STACKED, "embed", "ln_f", "lm_head"):
            p = getattr(self, name)
            if name.startswith("ln"):
                p.fill_(1.0)
            elif name == "embed":
                p.copy_(torch.randn(p.shape, generator=g))
            else:
                lecun_normal_(p, g, math.prod(p.shape[:-1]))

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
    def model_group(self):
        return (self.mesh.group(MODEL_AXIS) if self.tp > 1
                else collectives.SELF)

    def config(self) -> dict:
        """JSON-serializable hyperparameters (`PipelinedLM(**config)` on
        no mesh)."""
        return {"vocab_size": self.vocab_size, "d_model": self.d_model,
                "n_heads": self.n_heads, "n_layers": self.n_layers,
                "n_micro": self.n_micro,
                "compute_dtype": str(self.compute_dtype).removeprefix(
                    "torch."),
                "schedule": self.schedule, "n_virtual": self.n_virtual}

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
        """Logits ``[B, T, vocab]`` in f32. ``train`` and ``dropout_seed``
        (the Trainer's contract) change nothing: the model has no
        dropout."""
        del train, dropout_seed
        if segment_ids is not None:
            refuse_second_half("segment_ids (the packed pipeline)")
        b, t = tokens.shape
        d, cd = self.d_model, self.compute_dtype
        x = F.embedding(tokens.long(), self.embed).to(cd)
        stacks = [getattr(self, n) for n in _STACKED]
        if self.pipe == 1:
            x = self._stage(stacks, x)
        else:
            x = self._pipelined(stacks, x).reshape(b, t, d)
        x = _layernorm(x, self.ln_f)
        return x.float() @ self.lm_head.float()

    def _pipelined(self, stacks, x):
        """The stacks as this rank's stage of the schedule, over the
        microbatches of ``x`` (JAX's clamp and checks)."""
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
        x_micro = x.reshape(n_micro, b // n_micro, t, d)
        group = self.mesh.group(PIPE_AXIS)
        if self.schedule == "interleaved":
            v = self.n_virtual
            chunked = [w.reshape((v, w.shape[0] // v) + tuple(w.shape[1:]))
                       for w in stacks]
            return spmd_pipeline_interleaved(self._stage, chunked, x_micro,
                                             n_virtual=v, group=group)
        if self.schedule == "1f1b":
            return spmd_pipeline_1f1b(self._stage, stacks, x_micro,
                                      group=group)
        return spmd_pipeline(self._stage, stacks, x_micro, group=group)

    def _stage(self, stacks, x):
        """The layers of ``stacks`` (this stage's rows, or a chunk's) in
        order."""
        for i in range(stacks[0].shape[0]):
            x = self._block(x, *(w[i] for w in stacks))
        return x

    def _block(self, x, ln1, qkv, attn_out, ln2, mlp_up, mlp_down):
        """One pre-LN block over one layer's parameters (this model rank's
        heads and MLP features under TP), f and g around the Megatron
        pair."""
        mb, t, d = x.shape
        hd = d // self.n_heads
        h_local = self.n_heads // self.tp
        cd, group = self.compute_dtype, self.model_group
        hidden = collectives.enter_group(_layernorm(x, ln1), group)
        fused = (hidden @ qkv.to(cd)).reshape(mb, t, h_local, 3 * hd)
        q, k, v = fused.split(hd, dim=-1)
        positions = torch.arange(t, device=x.device).expand(mb, t)
        q, k = rope(q, positions), rope(k, positions)
        att = flash_attention(q, k, v, causal=True)
        out = att.reshape(mb, t, h_local * hd) @ attn_out.to(cd)
        x = x + collectives.leave_group(out, group)
        hidden = collectives.enter_group(_layernorm(x, ln2), group)
        hidden = F.gelu(hidden @ mlp_up.to(cd), approximate="tanh")
        return x + collectives.leave_group(hidden @ mlp_down.to(cd), group)


def _stack_specs(tp: bool) -> dict:
    """{name: {dim: axis}} of the per-layer stacks after their leading
    layer dim (JAX's ``_stack_specs``): the Megatron dim on ``model`` when
    TP is live."""
    return {name: ({_TP_DIM[name]: MODEL_AXIS}
                   if tp and name in _TP_DIM else {})
            for name in _STACKED}


def param_specs(module_or_state_dict, mesh) -> dict:
    """Per parameter name, its placement ``{dim: axis}``: each per-layer
    stack dim 0 on ``pipe`` (and Megatron's dim on ``model`` when that
    axis is live), everything else replicated ({}). ``module_or_state_dict``
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
                   if name.rsplit(".", 1)[-1] in _STACKED else t)
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
