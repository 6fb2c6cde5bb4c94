"""Mixture-of-Experts MLP with expert parallelism over the ``expert`` mesh
axis — port of `horovod_tpu.models.moe`.

The GShard/Switch dense-dispatch formulation, as in the JAX layer: tokens
are cut into dispatch groups of at most ``group_size``
(`dispatch_group_count`), each expert takes a static ``capacity`` of
tokens a group, and routing builds one-hot ``dispatch`` and gated
``combine`` tensors ``[n, S, E, C]`` that two einsums move the tokens
with. The router runs in f32 (softmax, top-k renormalised for k > 1 with
JAX's 1e-9); the Switch load-balancing loss over top-1 assignments is
sown into ``losses`` in training, and the fraction of routed (token,
choice) pairs past capacity into ``metrics`` as ``moe_drop_rate`` in every
forward (`training.train_state.sow`; the `Trainer` adds the losses to its
objective and the metrics to its logs). ``router="expert_choice"`` has
each expert take its top-``capacity`` tokens of the group instead: no aux
loss, and ``moe_uncovered_rate`` (the tokens no expert chose) as its
metric; it is training-only (the decode path refuses it). The experts are
``moe_up [E, d, 4d]`` and ``moe_down [E, 4d, d]`` with the tanh GELU
between them, LeCun-normal initialised with the expert axis as a batch
axis; ``dispatch``, the tokens and the experts run in ``compute_dtype``,
the router and ``combine`` in f32, and the output is cast back to the
input's dtype.

**Expert parallelism.** On a mesh with ``expert`` = ep > 1 the layer holds
only this rank's E/ep experts, ``[lo, hi)`` by its expert coordinate. The
JAX layer shards the batch over ``(data, fsdp)`` only, so every rank of an
expert group holds the same tokens, and GSPMD turns its
``P(None, 'expert', None, None)`` constraint on ``expert_in`` into a
local slice and the combine's contraction over E into a sum over the
expert group. The port computes the same explicitly: routing is
replicated, the local experts' ``expert_in`` and combine sit between
`collectives.enter_group` (identity forward, gradient summed over the
group backward, on the tokens and the gates) and
`collectives.leave_group` (the sum over the group forward). Under gloo
those sums go through the host (the `Trainer` then steps eagerly,
``reduces_over_ranks``); under NCCL they are captured with the step.

**Tensor parallelism and FSDP.** On a live ``model`` axis of tp ranks the
JAX layer places ``moe_up`` ``(expert, None, model)`` and ``moe_down``
``(expert, model, None)``: each rank holds ``4d/tp`` of every local
expert's hidden features (`full_shape`, `local_part`), and its experts'
FFNs sit between entering and leaving the ``model`` group too, as a
Megatron MLP's do. Routing stays in f32 and is the same on every ``model``
rank, which holds the same tokens. On a live ``fsdp`` axis the owning
`models.transformer.TransformerLM` cuts the router and the stacks to
their ``fsdp`` shards and the layer gathers them at use
(`parallel.sharding.weight`).

**Grouping across data shards.** Under GSPMD the JAX layer sees the global
batch, so its groups are cut from all data shards' tokens; the port's
layer sees one shard. The two agree exactly when this shard's token count
is a multiple of the global group length; where it is not, the layer
raises at its first forward rather than group differently (ROADMAP queue A
item 12.5). ``data_shards`` (the `Trainer` sets it to its data-parallel
size; else the mesh's) says how many shards the global batch has. On a
live ``seq`` axis each rank holds a column block of every row, so the JAX
layer's groups, cut from the global ``[B, T]`` token order, span the
sequence shards: the layer raises there at its first forward (item 12.5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, dp_size,
)
from horovod_tpu_torch.training.train_state import sow


def dispatch_group_count(g: int, group_size: int) -> int:
    """Smallest divisor of ``g`` whose groups stay within ``group_size``."""
    for n in range(1, g + 1):
        if g % n == 0 and g // n <= group_size:
            return n
    return g


def check_grouping(what: str, g: int, data_shards: int, seq_shards: int,
                   group_size: int) -> None:
    """Refuse a shard of ``g`` tokens whose dispatch groups would differ
    from those a GSPMD layer cuts from the global batch of ``data_shards``
    × ``seq_shards`` shards (ROADMAP queue A item 12.5): any live ``seq``
    axis (a group spans the sequence shards), or ``g`` not a multiple of
    the global group length."""
    if seq_shards > 1:
        raise ValueError(
            f"{what} on a live 'seq' axis ({seq_shards} sequence "
            "shards): the JAX layer cuts its dispatch groups from the "
            "global [B, T] token order, so a group spans the sequence "
            "shards, which the port's layer does not see together "
            "(ROADMAP queue A item 12.5, MoE grouping across shards)"
        )
    if data_shards <= 1:
        return
    total = g * data_shards
    s_glob = total // dispatch_group_count(total, group_size)
    if g % s_glob:
        raise ValueError(
            f"{what}: this data shard's {g} tokens are not a multiple of "
            f"the dispatch group of {s_glob} tokens that the JAX layer "
            f"cuts from the global batch of {total} tokens ({data_shards} "
            "data shards): the JAX layer would group tokens across data "
            "shards, which the port does not — use a per-rank batch "
            f"whose tokens are a multiple of {s_glob} (ROADMAP queue A "
            "item 12.5, MoE grouping across data shards)"
        )


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot`` (f32), with no host check of the indices (a
    captured step may hold it)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def lecun_normal_(p: torch.Tensor, generator, fan_in: int) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, σ scaled so the
    truncated draw has variance 1/fan_in."""
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    w = torch.empty(p.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    p.copy_(w)


class MoEMlp(nn.Module):
    """Routed MLP: ``[B, T, d] -> [B, T, d]`` through E expert FFNs.

    Args as the JAX layer's: ``d_model``, ``n_experts`` (E), ``mlp_ratio``,
    ``k`` (experts per token), ``capacity_factor`` (per-expert slots
    ``max(1, int(k · S / E · capacity_factor))``), ``aux_loss_coef``,
    ``router`` (``"top_k"`` or ``"expert_choice"``), ``compute_dtype``,
    ``sharding`` (a `models.transformer.ShardingConfig`; its mesh's
    ``expert`` axis shards the experts, its ``model`` axis their hidden
    features) and ``group_size``. Parameters are drawn from ``seed`` as
    the full E experts, then this rank's part is kept."""

    def __init__(self, d_model: int, n_experts: int = 8, mlp_ratio: int = 4,
                 k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_coef: float = 1e-2, router: str = "top_k",
                 compute_dtype=torch.float32, sharding=None,
                 group_size: int = 1024, *, seed: int = 0):
        super().__init__()
        mesh = getattr(sharding, "mesh", None) if sharding else None
        ep = mesh.shape.get(EXPERT_AXIS, 1) if mesh is not None else 1
        tp = mesh.shape.get(MODEL_AXIS, 1) if mesh is not None else 1
        if n_experts % ep != 0:
            raise ValueError(
                f"n_experts ({n_experts}) must be divisible by the expert "
                f"mesh axis ({ep})"
            )
        hidden = mlp_ratio * d_model
        if hidden % tp != 0:
            raise ValueError(
                f"moe_up dim 2 ({hidden}) is not divisible by mesh axis "
                f"'model' ({tp})"
            )
        self.set_router(router)
        self.d_model, self.n_experts, self.mlp_ratio = d_model, n_experts, mlp_ratio
        self.k, self.capacity_factor = k, capacity_factor
        self.aux_loss_coef = aux_loss_coef
        self.compute_dtype = compute_dtype
        self.group_size = group_size
        self.mesh = mesh
        self.ep, self.tp = ep, tp
        per = n_experts // ep
        self.expert_lo = per * (mesh.coords[EXPERT_AXIS] if ep > 1 else 0)
        self.expert_hi = self.expert_lo + per
        self.hidden_lo = hidden // tp * (mesh.coords[MODEL_AXIS]
                                         if tp > 1 else 0)
        self.hidden_hi = self.hidden_lo + hidden // tp
        self.data_shards = dp_size(mesh) if mesh is not None else 1
        self.seq_shards = mesh.shape[SEQ_AXIS] if mesh is not None else 1
        # The forward's all-reduces over the expert and model groups: a
        # gloo step with them runs eagerly (`training.graphs`).
        self.reduces_over_ranks = ep > 1 or tp > 1
        self.sown: dict = {}
        self.router = nn.Linear(d_model, n_experts, bias=False)
        self.moe_up = nn.Parameter(torch.empty(per, d_model, hidden // tp))
        self.moe_down = nn.Parameter(torch.empty(per, hidden // tp, d_model))
        self.reset_parameters(seed)

    def set_router(self, router: str) -> None:
        if router not in ("top_k", "expert_choice"):
            raise ValueError(
                f"router must be 'top_k' or 'expert_choice', got {router!r}"
            )
        self.router_kind = router

    @property
    def groups(self) -> tuple:
        """The groups the experts' FFNs enter and leave: the ``expert``
        group (the ranks the experts are spread over) and the ``model``
        group (their hidden features)."""
        return tuple(self.mesh.group(ax) if n > 1 else collectives.SELF
                     for ax, n in ((EXPERT_AXIS, self.ep),
                                   (MODEL_AXIS, self.tp)))

    def full_shape(self, name: str) -> tuple:
        """The unsharded shape of parameter ``name`` (``moe_up``,
        ``moe_down`` or ``router.weight``)."""
        hidden = self.mlp_ratio * self.d_model
        if name == "moe_up":
            return (self.n_experts, self.d_model, hidden)
        if name == "moe_down":
            return (self.n_experts, hidden, self.d_model)
        return (self.n_experts, self.d_model)

    def local_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the unsharded parameter ``full``: its
        experts, and its hidden features of each."""
        lo, hi = self.hidden_lo, self.hidden_hi
        if name == "moe_up":
            return full[self.expert_lo:self.expert_hi, :, lo:hi]
        if name == "moe_down":
            return full[self.expert_lo:self.expert_hi, lo:hi]
        return full

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a seeded CPU generator, the full E
        experts drawn and this rank's kept."""
        g = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            full = torch.empty(self.full_shape(name))
            lecun_normal_(full, g, full.shape[1])
            p.copy_(self.local_part(name, full))

    def check_grouping(self, g: int) -> None:
        """Refuse a shard whose ``g`` tokens would be grouped otherwise
        than the JAX layer groups the global batch (module docstring):
        the tokens of the batch's ``data_shards × seq_shards`` shards."""
        check_grouping("MoEMlp", g, self.data_shards, self.seq_shards,
                       self.group_size)

    def forward(self, x, *, train: bool = False, whole_batch: bool = False):
        """``whole_batch``: ``x`` is the whole batch, not one data shard of
        it (a decode step), so no grouping across shards applies."""
        self.sown.clear()
        b, t, d = x.shape
        e = self.n_experts
        g = b * t
        if not whole_batch:
            self.check_grouping(g)
        n_groups = dispatch_group_count(g, self.group_size)
        s = g // n_groups
        tokens = x.reshape(n_groups, s, d)
        capacity = max(1, int(self.k * s / e * self.capacity_factor))

        # --- routing (f32, alike on every expert and model rank) ---------
        logits = F.linear(tokens.float(),
                          shard_lib.weight(self.router).float())
        probs = torch.softmax(logits, dim=-1)  # [n, S, E]
        if self.router_kind == "expert_choice":
            return self._expert_choice(x, tokens, probs, capacity, n_groups, s)

        top_probs, top_idx = torch.topk(probs, self.k, dim=-1)  # [n, S, k]
        if self.k > 1:
            top_probs = top_probs / (top_probs.sum(-1, keepdim=True) + 1e-9)

        # Switch load-balancing loss over top-1 assignments, meaned over
        # the dispatch groups.
        frac = _one_hot(top_idx[..., 0], e).mean(1)
        aux = (e * torch.sum(frac * probs.mean(1), dim=-1)).mean()
        if train:
            sow(self, "losses", "moe_load_balance", self.aux_loss_coef * aux)

        # --- dispatch plan: each (token, choice)'s slot in its expert -----
        choice = _one_hot(top_idx, e).movedim(-2, 1)  # [n, k, S, E]
        flat = choice.reshape(n_groups, self.k * s, e)
        pos = torch.cumsum(flat, dim=1) * flat - 1.0
        pos = pos.reshape(n_groups, self.k, s, e)
        in_cap = (pos >= 0) & (pos < capacity)
        slot = pos.clamp(0, capacity - 1).long()
        slot_oh = _one_hot(slot, capacity) * in_cap[..., None]  # [n,k,S,E,C]
        routed = float(n_groups * self.k * s)
        sow(self, "metrics", "moe_drop_rate",
            1.0 - torch.sum(slot_oh) / routed)

        # --- this rank's experts, between entering and leaving the groups
        local = slot_oh[:, :, :, self.expert_lo:self.expert_hi]
        gates = self._enter(top_probs.float())
        combine = torch.einsum("nksec,nsk->nsec", local, gates)
        dispatch = local.sum(1)  # [n, S, E_local, C]
        cd = self.compute_dtype
        tokens_in = self._enter(tokens)
        expert_in = torch.einsum("nsec,nsd->necd", dispatch.to(cd),
                                 tokens_in.to(cd))
        out = self._experts(expert_in)
        mixed = torch.einsum("nsec,necd->nsd", combine.to(cd), out)
        return self._leave(mixed).reshape(b, t, d).to(x.dtype)

    def _enter(self, x):
        for group in self.groups:
            x = collectives.enter_group(x, group)
        return x

    def _leave(self, x):
        for group in self.groups:
            x = collectives.leave_group(x, group)
        return x

    def _expert_choice(self, x, tokens, probs, capacity, n_groups, s):
        """Each expert takes its top-``capacity`` tokens of the group;
        every expert is exactly full, and ``moe_uncovered_rate`` is the
        fraction of tokens no expert chose."""
        b, t, d = x.shape
        cd = self.compute_dtype
        capacity = min(capacity, s)
        g_val, g_idx = torch.topk(probs.movedim(-1, 1), capacity, dim=-1)
        dispatch = _one_hot(g_idx, s)  # [n, E, C, S]
        chosen = torch.clamp(dispatch.sum((1, 2)), 0.0, 1.0)  # [n, S]
        sow(self, "metrics", "moe_uncovered_rate",
            1.0 - torch.sum(chosen) / float(n_groups * s))
        lo, hi = self.expert_lo, self.expert_hi
        local = dispatch[:, lo:hi]
        tokens_in = self._enter(tokens)
        expert_in = torch.einsum("necs,nsd->necd", local.to(cd),
                                 tokens_in.to(cd))
        out = self._experts(expert_in)
        gates = self._enter(g_val)[:, lo:hi]
        combine = local * gates[..., None]
        mixed = torch.einsum("necs,necd->nsd", combine.to(cd), out)
        return self._leave(mixed).reshape(b, t, d).to(x.dtype)

    def _experts(self, expert_in):
        """The local experts' FFNs over ``[n, E_local, C, d]`` (this rank's
        part of their hidden features: a partial sum on a ``model``
        group)."""
        cd = self.compute_dtype
        up = shard_lib.weight(self, "moe_up").to(cd)
        down = shard_lib.weight(self, "moe_down").to(cd)
        h = F.gelu(torch.einsum("necd,edh->nech", expert_in, up),
                   approximate="tanh")
        return torch.einsum("nech,ehd->necd", h, down)
