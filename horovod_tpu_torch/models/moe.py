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

**Grouping across shards.** Under GSPMD the JAX layer sees the global
batch: it cuts its dispatch groups of at most ``group_size`` tokens from the
global ``[B, T]`` token order, whatever the mesh. The port's layer sees one
shard (`TokenShards`: data shard i of ``data × fsdp`` and sequence shard c
of ``seq``; the `Trainer` sets them, else the mesh's) and groups exactly as
JAX does all the same (`grouping_plan`): a local token ``(b, t)`` has the
global flat index ``(i·B + b)·(T·sp) + c·T + t``, its group is that index
// s and its place that index % s. Where this shard's groups are all its
own (an aligned shard) routing is local; where a group spans shards (a
live ``seq`` axis, or a data shard whose tokens are not a multiple of the
group) every rank gathers the routing decisions of the gradient group —
the top-k expert ids, or for expert choice the detached probabilities —
never the activations, computes the global slots of its own tokens from
them and dispatches its own tokens into its groups' capacity slots (a
slot another shard holds is a zero row here). Each expert's FFN acts on a
slot's row alone, so the output is JAX's. The load-balance loss and the
rates are sums over the gradient group: every rank sows JAX's global
values, and the loss's gradient is this rank's share, scaled to the
optimizer's rule (`_TokenSum`). Under gloo these collectives go through
the host (the `Trainer` then steps eagerly); under NCCL they are captured
with the step, as the plan holds no host read of a device tensor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS
from horovod_tpu_torch.training.train_state import sow


def dispatch_group_count(g: int, group_size: int) -> int:
    """Smallest divisor of ``g`` whose groups stay within ``group_size``."""
    for n in range(1, g + 1):
        if g % n == 0 and g // n <= group_size:
            return n
    return g


@dataclasses.dataclass(frozen=True)
class TokenShards:
    """Where this rank's ``[B, T]`` tokens sit in the global batch: data
    shard ``data_index`` of ``data_shards`` (``data × fsdp``) and sequence
    shard ``seq_index`` of ``seq_shards``. The ranks that hold the other
    shards are ``mesh``'s gradient group, or the world without a mesh;
    their members stand in the order ``data_index · seq_shards +
    seq_index``."""

    data_shards: int = 1
    data_index: int = 0
    seq_shards: int = 1
    seq_index: int = 0
    mesh: object = dataclasses.field(default=None, compare=False)

    @classmethod
    def of(cls, mesh) -> "TokenShards":
        if mesh is None:
            return cls()
        return cls(mesh.data_shards, mesh.data_index, mesh.seq_shards,
                   mesh.seq_index, mesh)

    @property
    def count(self) -> int:
        return self.data_shards * self.seq_shards

    @property
    def group(self):
        """The ranks of the other shards (`collectives.SELF` for one)."""
        if self.count == 1:
            return collectives.SELF
        return self.mesh.grad_group if self.mesh is not None else None

    def plan(self, b: int, t: int, group_size: int) -> "GroupingPlan":
        return grouping_plan(b, t, group_size, self.data_index,
                             self.data_shards, self.seq_index,
                             self.seq_shards)


@contextlib.contextmanager
def whole_batches(module):
    """Within: every layer of ``module`` that groups tokens across shards
    takes the batch it sees as the whole batch (an exported function runs
    on one device, on the batch it is given, as JAX's export does)."""
    held = [(m, m.token_shards) for m in module.modules()
            if isinstance(getattr(m, "token_shards", None), TokenShards)]
    for m, _ in held:
        m.token_shards = TokenShards()
    try:
        yield module
    finally:
        for m, shards in held:
            m.token_shards = shards


@dataclasses.dataclass(frozen=True)
class GroupingPlan:
    """JAX's dispatch groups as this shard meets them: ``n`` groups of
    ``s`` tokens cut from the global batch's flat order; this shard's
    ``b × t`` tokens fall in ``m`` of them, all within the ``span`` groups
    from ``first``. ``aligned``: every one of those groups is wholly this
    shard's (the same on every rank), so routing needs no other shard's
    decisions. Python integers only: a captured step holds the tensors it
    makes (`flat`, `span_rows`, `slots`)."""

    b: int
    t: int
    data_index: int
    data_shards: int
    seq_index: int
    seq_shards: int
    n: int
    s: int
    first: int
    span: int
    m: int

    @property
    def aligned(self) -> bool:
        # A group wholly within this shard's run of b·t tokens (one seq
        # shard) or within each of its rows' blocks of t (several): either
        # way a property of the shapes, alike on every rank.
        run = self.b * self.t if self.seq_shards == 1 else self.t
        return run % self.s == 0

    def flat(self, device) -> torch.Tensor:
        """Each local token's index in JAX's global flat order."""
        i = torch.arange(self.b * self.t, device=device)
        row, col = i // self.t, i % self.t
        return ((self.data_index * self.b + row) * (self.t * self.seq_shards)
                + self.seq_index * self.t + col)

    def group_and_place(self, device) -> tuple:
        """Each local token's global group and its place in that group."""
        f = self.flat(device)
        return f // self.s, f % self.s

    def span_rows(self, device) -> torch.Tensor:
        """Each local token's row in the span's ``[span · s]`` tokens."""
        return self.flat(device) - self.first * self.s

    def slots(self, device) -> torch.Tensor:
        """Each local token's row in the ``[m · s]`` layout of the groups
        it falls in, in group order (the flat index only grows along the
        local order, so a group's rank among them counts the group changes
        before it)."""
        g, p = self.group_and_place(device)
        j = torch.cumsum(torch.cat([g.new_zeros(1), (g[1:] != g[:-1]).long()]),
                         0)
        return j * self.s + p


@functools.lru_cache(maxsize=256)
def grouping_plan(b: int, t: int, group_size: int, data_index: int = 0,
                  data_shards: int = 1, seq_index: int = 0,
                  seq_shards: int = 1) -> GroupingPlan:
    """The `GroupingPlan` of a ``[b, t]`` shard at ``(data_index,
    seq_index)`` of a global batch of ``data_shards · b`` rows of
    ``seq_shards · t`` tokens."""
    row_len = t * seq_shards
    total = data_shards * b * row_len
    n = dispatch_group_count(total, group_size)
    s = total // n
    m, last, first = 0, -1, None
    for bb in range(b):
        start = (data_index * b + bb) * row_len + seq_index * t
        g0, g1 = start // s, (start + t - 1) // s
        first = g0 if first is None else first
        m += g1 - g0 + 1 - (g0 == last)
        last = g1
    return GroupingPlan(b, t, data_index, data_shards, seq_index,
                        seq_shards, n, s, first, last - first + 1, m)


#: Bytes this rank received in the routing collectives (`route_tokens`:
#: the gathered decisions and the summed shares) and their count; counted
#: where the forward's Python runs (eager steps and a capture).
routing_traffic = {"bytes": 0, "calls": 0}


def _count_routing(t: torch.Tensor) -> None:
    routing_traffic["bytes"] += t.numel() * t.element_size()
    routing_traffic["calls"] += 1


class _TokenSum(torch.autograd.Function):
    """The sum over the token shards' group forward (every rank then holds
    the global value); backward the cotangent × ``scale``, the data
    shards. A rank owes the gradient of its own tokens' share, and the
    optimizer sums a gradient over the group and divides by the data
    shards: ``scale · share`` summed and divided is the global value's
    gradient."""

    @staticmethod
    def forward(ctx, x, group, scale: int):
        ctx.scale = scale
        return collectives.all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None, None


def _global_sums(values, shards: TokenShards):
    """``values`` (0-d, this shard's shares) summed over the token shards
    in one collective."""
    v = torch.stack([x.float() for x in values])
    if shards.count > 1:
        v = _TokenSum.apply(v, shards.group, shards.data_shards)
        _count_routing(v)
    return v.unbind()


def _to_span(own: torch.Tensor, plan: GroupingPlan, shards: TokenShards):
    """The span's tokens ``[span · s, ...]`` in global order, from every
    shard's ``own`` ``[b · t, ...]`` gathered over the token group (no
    gradient: routing decisions only)."""
    got = collectives.all_gather_tensor(own.detach().contiguous(),
                                        shards.group)
    _count_routing(got)
    rest = tuple(own.shape[1:])
    got = got.reshape((plan.data_shards, plan.seq_shards, plan.b, plan.t)
                      + rest).transpose(1, 2).reshape((-1,) + rest)
    return got[plan.first * plan.s:(plan.first + plan.span) * plan.s]


def _ids_dtype(n_experts: int):
    """The narrowest integer type the expert ids cross ranks in."""
    return torch.uint8 if n_experts <= 256 else torch.int32


def route_tokens(x, probs, plan: GroupingPlan, shards: TokenShards, experts,
                 *, k: int, capacity_factor: float, router: str,
                 expert_range: tuple, groups: tuple, compute_dtype):
    """JAX's GShard dense dispatch of this shard's tokens ``x [g, d]`` by
    their f32 router probabilities ``probs [g, E]``, grouped by ``plan``:
    each (token, choice) takes its slot in its expert's ``capacity`` by
    the cumulative count down its group's ``[k · s]`` choices (top-k), or
    each expert its top-``capacity`` tokens of the group (expert choice).
    ``experts`` maps the dispatched ``[m, E_local, C, d]`` rows of the
    experts in ``expert_range`` to theirs, between entering and leaving
    ``groups`` (the ``expert`` and ``model`` groups). Returns ``(mixed [g,
    d] in compute_dtype, stats)``: top-k's ``aux`` (the global load-balance
    loss, this rank's share in its gradient) and ``fill`` (the kept
    fraction of routed choices), expert choice's ``uncovered`` (the
    fraction of tokens no expert took), each the global value."""
    g, d = x.shape
    e = probs.shape[-1]
    s, n, m = plan.s, plan.n, plan.m
    lo, hi = expert_range
    dev = x.device
    cap = max(1, int(k * s / e * capacity_factor))
    shared = not plan.aligned
    rows = plan.span_rows(dev) if shared else None
    slots = plan.slots(dev) if shared else None

    def own(t):  # span rows → this shard's tokens
        return t.index_select(0, rows) if shared else t

    def pad(t, fill=0):  # this shard's tokens → its groups' [m · s] rows
        if not shared:
            return t
        return t.new_full((m * s,) + tuple(t.shape[1:]), fill).index_copy(
            0, slots, t)

    def enter(t):
        for grp in groups:
            t = collectives.enter_group(t, grp)
        return t

    if router == "expert_choice":
        cap = min(cap, s)
        span = _to_span(probs, plan, shards) if shared else probs.detach()
        ns = span.shape[0] // s
        _, pick = torch.topk(span.reshape(ns, s, e).movedim(-1, 1), cap,
                             dim=-1)  # [ns, E, C]
        chosen = torch.zeros(ns, s, device=dev).scatter_(
            1, pick.reshape(ns, e * cap), 1.0).reshape(ns * s)
        (uncovered,) = _global_sums([own(chosen).sum()], shards)
        stats = {"uncovered": 1.0 - uncovered / float(n * s)}
        take = _one_hot(pick[:, lo:hi], s).movedim(-1, 1)  # [ns,s,El,C]
        take = own(take.reshape(ns * s, hi - lo, cap))
        gates = enter(probs)[:, lo:hi]
        dispatch = pad(take).reshape(m, s, hi - lo, cap)
        combine = pad(take * gates[..., None]).reshape(m, s, hi - lo, cap)
    else:
        top_probs, top_idx = torch.topk(probs, k, dim=-1)  # [g, k]
        if k > 1:
            top_probs = top_probs / (top_probs.sum(-1, keepdim=True) + 1e-9)
        ids = (_to_span(top_idx.to(_ids_dtype(e)), plan, shards).long()
               if shared else top_idx)
        ns = ids.shape[0] // s
        choice = _one_hot(ids.reshape(ns, s, k), e).movedim(-2, 1)
        flat = choice.reshape(ns, k * s, e)
        pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(ns, k, s, e)
        pos = own(pos.movedim(1, 2).reshape(ns * s, k, e))  # [g, k, E]
        # Switch's load balance over top-1 assignments, meaned over the
        # groups: linear in each token's probabilities given the top-1
        # fractions, so each shard's tokens owe their share.
        frac = choice[:, 0].mean(1)  # [ns, E]
        frac = (frac.index_select(0, rows // s) if shared
                else frac[:, None].expand(ns, s, e).reshape(g, e))
        share = e / float(n * s) * torch.sum(frac * probs)
        in_cap = (pos >= 0) & (pos < cap)
        aux, kept = _global_sums([share, in_cap.sum()], shards)
        stats = {"aux": aux, "fill": kept.detach() / float(n * k * s)}
        pos = pad(pos, -1.0).reshape(m, s, k, e).movedim(2, 1)[..., lo:hi]
        in_cap = (pos >= 0) & (pos < cap)
        local = _one_hot(pos.clamp(0, cap - 1).long(), cap) * in_cap[
            ..., None]  # [m, k, s, E_local, C]
        gates = pad(enter(top_probs.float())).reshape(m, s, k)
        combine = torch.einsum("nksec,nsk->nsec", local, gates)
        dispatch = local.sum(1)  # [m, s, E_local, C]
    cd = compute_dtype
    tokens = pad(enter(x)).reshape(m, s, d)
    expert_in = torch.einsum("nsec,nsd->necd", dispatch.to(cd), tokens.to(cd))
    out = experts(expert_in)
    mixed = torch.einsum("nsec,necd->nsd", combine.to(cd), out)
    mixed = mixed.reshape(m * s, d)
    if shared:
        mixed = mixed.index_select(0, slots)
    for grp in groups:
        mixed = collectives.leave_group(mixed, grp)
    return mixed, stats


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
        # Where this rank's tokens sit in the global batch (the `Trainer`
        # sets it from its own layout).
        self.token_shards = TokenShards.of(mesh)
        self.sown: dict = {}
        self.router = nn.Linear(d_model, n_experts, bias=False)
        self.moe_up = nn.Parameter(torch.empty(per, d_model, hidden // tp))
        self.moe_down = nn.Parameter(torch.empty(per, hidden // tp, d_model))
        self.reset_parameters(seed)

    @property
    def data_shards(self) -> int:
        return self.token_shards.data_shards

    @property
    def reduces_over_ranks(self) -> bool:
        """The forward's collectives: the sums over the expert and model
        groups, and over the token shards (`route_tokens`). A gloo step
        with them runs eagerly (`training.graphs`)."""
        return self.ep > 1 or self.tp > 1 or self.token_shards.count > 1

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

    def forward(self, x, *, train: bool = False, whole_batch: bool = False):
        """``whole_batch``: ``x`` is the whole batch, not one shard of it
        (a decode step), so its groups are its own."""
        self.sown.clear()
        b, t, d = x.shape
        shards = TokenShards() if whole_batch else self.token_shards
        plan = shards.plan(b, t, self.group_size)
        tokens = x.reshape(b * t, d)
        # Routing in f32, alike on every expert and model rank.
        logits = F.linear(tokens.float(),
                          shard_lib.weight(self.router).float())
        probs = torch.softmax(logits, dim=-1)  # [g, E]
        mixed, stats = route_tokens(
            tokens, probs, plan, shards, self._experts, k=self.k,
            capacity_factor=self.capacity_factor, router=self.router_kind,
            expert_range=(self.expert_lo, self.expert_hi),
            groups=self.groups, compute_dtype=self.compute_dtype)
        if self.router_kind == "expert_choice":
            sow(self, "metrics", "moe_uncovered_rate", stats["uncovered"])
        else:
            if train:
                sow(self, "losses", "moe_load_balance",
                    self.aux_loss_coef * stats["aux"])
            sow(self, "metrics", "moe_drop_rate", 1.0 - stats["fill"])
        return mixed.reshape(b, t, d).to(x.dtype)

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
