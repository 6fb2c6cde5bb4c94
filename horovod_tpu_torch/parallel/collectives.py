"""Host-level collectives over `torch.distributed` — port of the eager
(``axis_name=None``) branch of `horovod_tpu.parallel.collectives`.

Semantics follow the JAX package: ``allreduce`` averages by default (the
Horovod contract), every op is the identity without a process group (a
single process), and trees are nested dicts/lists/tuples of tensors (or
numpy arrays, or a module's ``state_dict``) flattened in JAX's leaf order:
plain-dict keys sorted, ``OrderedDict`` keys in insertion order.

It also carries the JAX package's boundary reduction, eagerly and over
`torch.distributed` (sub)groups: the ZeRO-1 scatter layout, the int8/fp8
wires with error feedback, the two-hop (dcn, ici) sum and
`reduce_gradients` (see the sections below).

Transport: NCCL takes CUDA tensors only and gloo is used here for host
tensors, so each op moves its operand to the backend's device first —
CUDA tensors go through the host under gloo (the two-ranks-on-one-card and
CPU cases), host tensors go to this rank's card under NCCL — and moves the
result back; `allreduce_` skips both moves where the operand already lies
there. gloo has no ``ReduceOp.AVG``: averages are a sum, then a division by
the world size, on every backend.
"""

from __future__ import annotations

import collections

import torch

from horovod_tpu_torch import runtime

#: Default fusion-bucket size: Horovod's fusion threshold default (64 MB).
DEFAULT_BUCKET_BYTES = 64 * 1024 * 1024

_LEAF = object()


def tree_flatten(tree):
    """``(leaves, treedef)`` in JAX's order; None is an empty subtree."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = (list(node) if isinstance(node, collections.OrderedDict)
                    else sorted(node))
            return (type(node), keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(c) for c in node])
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """Inverse of `tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is _LEAF:
            return next(it)
        kind, keys, children = node
        values = [build(c) for c in children]
        return kind(zip(keys, values)) if keys is not None else kind(values)

    return build(treedef)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree of ``rest``), rebuilt in ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(leaves, *others)])


def first_leaf(tree):
    """The first leaf of ``tree`` in `tree_flatten` order (a batch part's
    row count is its length)."""
    return tree_flatten(tree)[0][0]


def _comm_device() -> torch.device:
    """Where the live backend takes its tensors."""
    if runtime.backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_comm(x) -> torch.Tensor:
    """A private copy of ``x`` on the backend's device (ops run in place)."""
    t = torch.as_tensor(x)
    dev = _comm_device()
    return t.to(dev, copy=True).contiguous()


def _home(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def allreduce(x, average: bool = True):
    """Sum (or mean, the default) of ``x`` over every rank."""
    if not runtime.is_distributed():
        return x
    t = _to_comm(x)
    torch.distributed.all_reduce(t)
    if average:
        t = t / runtime.size()
    return t.to(_home(x))


def allreduce_(t: torch.Tensor, average: bool = True) -> torch.Tensor:
    """`allreduce` written into ``t`` itself, which is returned. A
    contiguous ``t`` already where the backend takes its tensors (a CUDA
    tensor under NCCL, a host one under gloo) is reduced with no copy; any
    other goes through a staging copy there and back."""
    if not runtime.is_distributed():
        return t
    allreduce_sum_(t)
    if average:
        t.div_(runtime.size())
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward: the sum is its own
    adjoint (every rank's output takes every rank's input with weight
    one)."""

    @staticmethod
    def forward(ctx, x):
        return allreduce_(x.clone(memory_format=torch.contiguous_format),
                          average=False)

    @staticmethod
    def backward(ctx, grad):
        return allreduce_(grad.clone(memory_format=torch.contiguous_format),
                          average=False)


def allreduce_mean_differentiable(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: forward an
    all-reduce sum ÷ size, backward an all-reduce sum of the incoming
    gradient (÷ size). Each rank's backward then holds the gradient of
    the sum of every rank's loss; the optimizer's averaging makes it the
    gradient of the global-batch loss (sync-BN's identity). Its caller,
    `models.resnet.BatchNorm`, calls it only at size > 1."""
    return _AllReduceSum.apply(x) / runtime.size()


def allgather(x, tiled: bool = True):
    """Every rank's ``x`` (same shape on all), concatenated along the
    leading axis (``tiled``) or stacked on a new one (≈
    ``hvd.allgather``)."""
    if not runtime.is_distributed():
        return torch.as_tensor(x)
    t = _to_comm(x)
    parts = [torch.empty_like(t) for _ in range(runtime.size())]
    torch.distributed.all_gather(parts, t)
    out = torch.cat(parts) if tiled and t.dim() > 0 else torch.stack(parts)
    return out.to(_home(x))


def broadcast(x, root: int = 0):
    """Every rank adopts rank ``root``'s ``x`` (≈ ``hvd.broadcast``)."""
    if not runtime.is_distributed():
        return torch.as_tensor(x)
    t = _to_comm(x)
    torch.distributed.broadcast(t, src=root)
    return t.to(_home(x))


def pmean_pytree(tree):
    """Average every floating leaf of ``tree`` across ranks, as a few fused
    bucket all-reduces (not one per leaf)."""
    if not runtime.is_distributed():
        return tree
    buckets, spec = flatten_buckets(tree)
    return unflatten_buckets([allreduce(b) for b in buckets], spec)


def broadcast_pytree(tree, root: int = 0):
    """Every leaf from ``root`` — ``hvd.broadcast_global_variables`` over an
    arbitrary tree — as one broadcast per bucket."""
    if not runtime.is_distributed():
        return tree
    buckets, spec = flatten_buckets(tree)
    return unflatten_buckets([broadcast(b, root) for b in buckets], spec)


def broadcast_object(obj, root: int = 0):
    """``hvd.broadcast_object``: every rank adopts ``root``'s picklable
    object."""
    if not runtime.is_distributed():
        return obj
    box = [obj if runtime.rank() == root else None]
    torch.distributed.broadcast_object_list(box, src=root)
    return box[0]


def scatter_object(objs, root: int = 0):
    """Rank r adopts ``objs[r]``, the list of picklable objects given on
    ``root`` (ignored elsewhere)."""
    if not runtime.is_distributed():
        return objs[0]
    out = [None]
    torch.distributed.scatter_object_list(
        out, list(objs) if runtime.rank() == root else None, src=root)
    return out[0]


def allgather_object(obj) -> list:
    """``hvd.allgather_object``: the list of every rank's object, by rank."""
    if not runtime.is_distributed():
        return [obj]
    out = [None] * runtime.size()
    torch.distributed.all_gather_object(out, obj)
    return out


def metric_mean(metrics: dict) -> dict:
    """Cross-rank mean of a dict of scalars (MetricAverageCallback's op),
    as Python floats; one all-reduce for the whole dict."""
    keys = sorted(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys],
                          dtype=torch.float32)
    return dict(zip(keys, allreduce(values).tolist()))


# --- Bucketed fusion ---------------------------------------------------------
#
# Horovod's tensor fusion: many small gradient tensors batched into a few
# collectives. The layout is the JAX package's, bucket for bucket: leaves
# grouped by dtype in first-appearance order, raveled, concatenated and cut
# into chunks of at most ``bucket_bytes`` (``bucket_bytes // itemsize``
# elements).


def flatten_buckets(tree, bucket_bytes: int | None = None, *,
                    reverse: bool = False):
    """Pack a tree into contiguous dtype-homogeneous 1-D buckets.
    ``reverse=True`` walks the leaves last-first (the order the backward
    finishes them). Returns ``(buckets, spec)``; `unflatten_buckets` is the
    exact inverse."""
    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_BYTES
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    order = range(len(leaves) - 1, -1, -1) if reverse else range(len(leaves))
    by_dtype: dict = {}
    for i in order:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    buckets, groups = [], []
    for dtype, idxs in by_dtype.items():
        flat = [leaves[i].reshape(-1) for i in idxs]
        vec = flat[0] if len(flat) == 1 else torch.cat(flat)
        per = max(1, bucket_bytes // vec.element_size())
        chunks = list(vec.split(per)) if vec.numel() else [vec]
        buckets.extend(chunks)
        groups.append((tuple(idxs), len(chunks)))
    spec = (treedef, tuple(tuple(l.shape) for l in leaves),
            tuple(l.dtype for l in leaves), tuple(groups))
    return buckets, spec


def unflatten_buckets(buckets, spec):
    """Inverse of `flatten_buckets`; each leaf is cast back to its recorded
    dtype, so a reduction on a 16-bit wire round-trips."""
    treedef, shapes, dtypes, groups = spec
    leaves: list = [None] * len(shapes)
    pos = 0
    for idxs, n_chunks in groups:
        chunks = buckets[pos:pos + n_chunks]
        pos += n_chunks
        vec = chunks[0] if len(chunks) == 1 else torch.cat(list(chunks))
        off = 0
        for i in idxs:
            n = 1
            for s in shapes[i]:
                n *= s
            leaves[i] = vec[off:off + n].reshape(shapes[i]).to(dtypes[i])
            off += n
    if pos != len(buckets):
        raise ValueError(
            f"unflatten_buckets got {len(buckets)} buckets for a spec "
            f"describing {pos} — bucket list and spec do not match"
        )
    return tree_unflatten(treedef, leaves)


def dense_bucket_pieces(spec, bucket_bytes: int) -> list:
    """Per bucket of a `flatten_buckets` spec, ``(leaf, lo, hi)``: the
    leaf's flat elements ``[lo, hi)`` it carries, in order (a bucket
    assembled from these alone equals the concat-then-split one)."""
    _, shapes, dtypes, groups = spec
    out = []
    for idxs, n_chunks in groups:
        per = max(1, bucket_bytes // dtypes[idxs[0]].itemsize)
        spans, at = [], 0
        for i in idxs:
            n = _numel(shapes[i])
            spans.append((i, at, at + n))
            at += n
        for j in range(n_chunks):
            lo, hi = j * per, min((j + 1) * per, at)
            out.append([(i, max(a, lo) - a, min(b, hi) - a)
                        for i, a, b in spans if a < hi and b > lo])
    return out


# --- Collectives over a group, on any device ----------------------------------
#
# The reduction below runs over the whole world or over a subgroup of it
# (`parallel.mesh.hier_groups`). Each op takes its operand on any device and
# returns the result there; a group of one rank (and a world without a
# process group) is the identity. fp8 payloads cross the wire as their
# uint8 bytes: the two collectives that move them do no arithmetic.


class _Self:
    """The group of this rank alone (a mesh axis of size 1): every
    collective over it is the identity, with no call made."""

    def __repr__(self) -> str:
        return "SELF"


SELF = _Self()


#: Bytes this rank handed to the group collectives below (the larger of
#: each call's operand and result) and their count; read where the
#: collectives run eagerly (under gloo every step; under NCCL the warm-up).
traffic = {"bytes": 0, "calls": 0}


#: Bytes this rank sent in ring shifts (`ring_shift`, both directions) and
#: the shifts' count; also counted in `traffic`.
shift_traffic = {"bytes": 0, "calls": 0}


def _count(t: torch.Tensor) -> None:
    traffic["bytes"] += t.numel() * t.element_size()
    traffic["calls"] += 1


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the world); 1 without a process group."""
    if group is SELF or not runtime.is_distributed():
        return 1
    return torch.distributed.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's position in ``group`` (None: the world)."""
    if group is SELF or not runtime.is_distributed():
        return 0
    return torch.distributed.get_group_rank(
        group or torch.distributed.group.WORLD, runtime.rank())


def _trivial(group) -> bool:
    """No process group, or a subgroup of one rank: nothing to exchange. (A
    world of one with a process group still runs its collectives, as the
    replicated reduction always has.)"""
    return group is SELF or not runtime.is_distributed() or (
        group is not None and torch.distributed.get_world_size(group) == 1)


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@torch.no_grad()
def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` (leading dim a multiple of the group size) cut into one block
    per member along dim 0, block j sent to member j; returns the blocks
    received, member i's in block i (``lax.all_to_all`` tiled on axis
    0)."""
    if _trivial(group):
        return t.clone()
    src = _to_comm(_bytes_view(t))
    out = torch.empty_like(src)
    _count(src)
    torch.distributed.all_to_all_single(out, src, group=group)
    out = out.to(t.device)
    return out.view(t.dtype) if t.dtype == torch.float8_e4m3fn else out


@torch.no_grad()
def all_gather_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every member's ``t`` stacked on a new leading axis, by member."""
    if _trivial(group):
        return t.unsqueeze(0).clone()
    g = group_size(group)
    src = _to_comm(_bytes_view(t)).reshape(-1)
    out = src.new_empty((g * src.numel(),))
    _count(out)
    torch.distributed.all_gather_into_tensor(out, src, group=group)
    out = out.to(t.device)
    if t.dtype == torch.float8_e4m3fn:
        out = out.view(t.dtype)
    return out.reshape((g,) + tuple(t.shape))


@torch.no_grad()
def reduce_scatter_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the group, cut into one block per member along
    its flat order; returns this member's block (``lax.psum_scatter``
    tiled)."""
    if _trivial(group):
        return t.clone()
    g = group_size(group)
    src = _to_comm(t).reshape(-1)
    out = src.new_empty((src.numel() // g,))
    _count(src)
    torch.distributed.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


@torch.no_grad()
def allreduce_sum_(t: torch.Tensor, async_op: bool = False, group=None):
    """Sum ``t`` over the world (or ``group``) in place (`allreduce_`
    without the division). Returns a function that waits for the sum to be
    in ``t``: with ``async_op`` the collective is only issued here. A
    world of one with a process group still makes the call."""
    if group is SELF or not runtime.is_distributed():
        return lambda: None
    staged = (t if t.device == _comm_device() and t.is_contiguous()
              else _to_comm(t))
    _count(staged)
    work = torch.distributed.all_reduce(staged, group=group,
                                        async_op=async_op)

    def wait() -> None:
        if work is not None:
            work.wait()
        if staged is not t:
            t.copy_(staged)

    if not async_op:
        wait()
    return wait


@torch.no_grad()
def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the group, out of place."""
    if _trivial(group):
        return t.clone()
    src = _to_comm(t)
    _count(src)
    torch.distributed.all_reduce(src, group=group)
    return src.to(t.device)


@torch.no_grad()
def broadcast_in_group(t: torch.Tensor, group, position: int = 0
                       ) -> torch.Tensor:
    """``t`` from the member of ``group`` at ``position`` (default the
    first, its lowest rank) on every member, out of place; ranks of the
    world for None."""
    if _trivial(group):
        return t.clone()
    src = _to_comm(t)
    torch.distributed.broadcast(src, src=_peer(group, position), group=group)
    return src.to(t.device)


# --- Sequence-parallel collectives -----------------------------------------------
#
# What the JAX package's ring and Ulysses attention take from `lax` —
# ``ppermute`` around the ring, ``all_to_all`` and ``all_gather`` tiled — as
# differentiable ops over a group (a mesh's ``seq`` subgroup). Under NCCL a
# CUDA tensor moves on the card; under gloo it stages through the host, as
# every op above does.


def _peer(group, position: int) -> int:
    """The global rank of ``group``'s member at ``position``."""
    if group is None:
        return position
    return torch.distributed.get_global_rank(group, position)


@torch.no_grad()
def _shift(tensors, group, step: int) -> list:
    """Each of ``tensors`` sent to the member ``step`` places on in
    ``group`` (cyclically) and replaced by the one the member ``step``
    places back sent; all in one batch of sends and receives."""
    g, me = group_size(group), group_rank(group)
    dst = _peer(group, (me + step) % g)
    src = _peer(group, (me - step) % g)
    dist = torch.distributed
    on_card = runtime.backend() == "nccl"
    sends = [t.contiguous() if on_card and t.is_cuda else _to_comm(t)
             for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    for s in sends:
        _count(s)
        shift_traffic["bytes"] += s.numel() * s.element_size()
    shift_traffic["calls"] += 1
    if on_card:
        ops = [dist.P2POp(dist.isend, s, dst, group) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, src, group) for r in recvs]
        works = dist.batch_isend_irecv(ops)
    else:
        works = [dist.isend(s, dst, group=group, tag=i)
                 for i, s in enumerate(sends)]
        works += [dist.irecv(r, src, group=group, tag=i)
                  for i, r in enumerate(recvs)]
    for w in works:
        w.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


class _RingShift(torch.autograd.Function):
    """The tensors from member r − 1 on member r, forward; the gradients
    back from member r + 1, backward. Integer tensors ride along without a
    gradient."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floats = [t.is_floating_point() for t in tensors]
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        out = _shift(tensors, group, 1)
        ctx.mark_non_differentiable(
            *[o for o, f in zip(out, ctx.floats) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        back = [g if g is not None else torch.zeros(s, dtype=dt, device=dev)
                for g, f, (s, dt, dev) in zip(grads, ctx.floats, ctx.shapes)
                if f]
        moved = iter(_shift(back, ctx.group, -1))
        return (None, *[next(moved) if f else None for f in ctx.floats])


def ring_shift(*tensors, group=None):
    """``lax.ppermute`` with ``perm = r → r + 1`` over ``group``: each
    tensor (None passes through) comes from the member before this one.
    The tensors of one hop move as ONE autograd node, so the backward's
    shifts come in one order on every member whatever else the members'
    graphs hold; the backward is the shift the other way."""
    present = [t for t in tensors if t is not None]
    if _trivial(group) or not present:
        return tensors
    moved = iter(_RingShift.apply(group, *present))
    return tuple(next(moved) if t is not None else None for t in tensors)


def _swap_axes(x, group, split: int, concat: int):
    blocks = torch.stack(x.chunk(group_size(group), dim=split))
    return torch.cat(all_to_all(blocks, group).unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _swap_axes(x, group, split, concat)

    @staticmethod
    def backward(ctx, grad):
        return (_swap_axes(grad, ctx.group, ctx.concat, ctx.split), None,
                None, None)


def all_to_all_tiled(x, group, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: ``x`` cut into one block per member along
    ``split_axis``, block j sent to member j, the blocks received joined
    along ``concat_axis`` in member order. The backward is the inverse
    swap."""
    if _trivial(group):
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _GatherKeepSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.position = group_rank(group)
        return torch.cat(all_gather_tensor(x.contiguous(), group).unbind(0),
                         dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.position * ctx.size, ctx.size),
                None, None)


def all_gather_tiled(x, group, dim: int = 1):
    """The members' ``x`` joined along ``dim`` in member order
    (``lax.all_gather(axis=dim, tiled=True)``). Its backward keeps this
    member's slice of the cotangent and adds nothing from the others: it
    serves a value every member computes alike from the gathered tensor
    (a sequence-parallel loss), whose gradient each member owes for its
    own slice only."""
    if _trivial(group):
        return x
    return _GatherKeepSlice.apply(x, group, dim)


class _GatherReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather_tensor(x.contiguous(), group).unbind(0),
                         dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # Member i's block of the flat order of `grad` moved to dim 0 is
        # its slice along `dim`.
        moved = grad.movedim(ctx.dim, 0).contiguous()
        part = reduce_scatter_sum(moved, ctx.group)
        part = part.view((moved.shape[0] // group_size(ctx.group),)
                         + tuple(moved.shape[1:]))
        return part.movedim(0, ctx.dim), None, None


def gather_weight(t, dim: int, group, backward: str):
    """A weight sharded along ``dim`` over ``group``, whole: the members'
    parts joined along ``dim`` in member order (one autograd node). Its
    backward is ``"reduce_scatter"`` — the members' gradients of the whole
    weight summed and this member's slice kept, for weight-gathered FSDP,
    where each member's loss is over other batch rows — or ``"slice"`` —
    this member's slice of its own gradient (`all_gather_tiled`), where
    every member computed the same function on the same rows (the fused-CE
    head on a ``model`` group). The wrong choice scales the gradient by
    the group's size, up or down."""
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError("gather_weight backward must be 'reduce_scatter' "
                         f"or 'slice', got {backward!r}")
    if _trivial(group):
        return t
    if backward == "slice":
        return _GatherKeepSlice.apply(t, group, dim)
    return _GatherReduceScatter.apply(t, group, dim)


# --- Entering and leaving a sharded region --------------------------------------
#
# The Megatron pair around compute that each member of a group does on its
# own part (an MoE layer's local experts, a tensor-parallel block's heads
# and MLP features): the region's inputs are the same on every member, and
# its output is the sum of the members' parts. `enter_group` is Megatron's
# f, `leave_group` its g. Without `enter_group` the inputs' gradients would
# be each member's partial gradient only.


class _EnterGroup(torch.autograd.Function):
    """Identity forward; sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


class _LeaveGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group``."""
    return x if _trivial(group) else _EnterGroup.apply(x, group)


def leave_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient passes unchanged."""
    return x if _trivial(group) else _LeaveGroup.apply(x, group)


# --- Pipeline handoffs ---------------------------------------------------------
#
# What the JAX package's pipeline takes from `lax` over the ``pipe`` axis:
# the ``ppermute`` that hands each stage's output to the next stage (and, in
# the backward, each cotangent back), and the masked ``psum`` that
# broadcasts the last stage's outputs to every stage. The port's schedules
# (`parallel.pipeline`) run one rank a stage and move only what a tick
# really hands over: `pipe_exchange` forward from stage s to s + 1 (and
# over the interleaved schedule's wrap S − 1 → 0), and the same exchange
# with the directions swapped in their backward tick loops, which is the
# handoff's transpose. Under NCCL the tensors move on the card in one batch
# of sends and receives; under gloo through the host, as `_shift` does.

#: Bytes this rank sent in pipeline handoffs.
pipe_traffic = {"bytes": 0}
_p2p_ready: set = set()


def pipe_ready(group) -> None:
    """One collective over ``group`` before its first handoff, which every
    member makes at one point (a schedule's start): NCCL's batched
    point-to-point calls need the group's first call to involve every
    member, and a tick's handoffs involve some only. Once per group."""
    if _trivial(group) or id(group) in _p2p_ready:
        return
    all_reduce_sum(torch.zeros(1), group)
    _p2p_ready.add(id(group))


@torch.no_grad()
def pipe_exchange(sends, recvs, group, tag: int = 0) -> list:
    """One tick's handoffs over ``group``: ``sends`` ``[(position,
    tensor)]`` go to the members at those positions, and ``recvs``
    ``[(position, like)]`` come from them, into tensors shaped and typed
    like ``like`` on its device, returned in order. A member sends at most
    one tensor to each peer a call and receives at most one from each
    (asserted), and every member makes its calls in tick order, so the
    pairs match by peer and call; under gloo they also carry ``tag`` (the
    tick), as `_shift`'s carry theirs. Sends and receives go in one batch,
    so no send waits on a receive posted after it and the exchange cannot
    deadlock."""
    if not sends and not recvs:
        return []
    for ops in (sends, recvs):
        peers = [pos for pos, _ in ops]
        assert len(set(peers)) == len(peers), (
            f"pipe_exchange: a peer twice in one call: {peers}")
    dist = torch.distributed
    on_card = runtime.backend() == "nccl"
    out = [(_peer(group, pos),
            t.contiguous() if on_card and t.is_cuda else _to_comm(t))
           for pos, t in sends]
    bufs = [(_peer(group, pos), torch.empty(like.shape, dtype=like.dtype,
                                            device=_comm_device()))
            for pos, like in recvs]
    for _, t in out:
        pipe_traffic["bytes"] += t.numel() * t.element_size()
    if on_card:
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t, peer, group) for peer, t in out]
            + [dist.P2POp(dist.irecv, b, peer, group) for peer, b in bufs])
    else:
        works = ([dist.isend(t, peer, group=group, tag=tag)
                  for peer, t in out]
                 + [dist.irecv(b, peer, group=group, tag=tag)
                    for peer, b in bufs])
    for w in works:
        w.wait()
    return [b.to(like.device) for (_, b), (_, like) in zip(bufs, recvs)]


class _BroadcastLast(torch.autograd.Function):
    """The last member's ``x`` on every member, forward. Backward, the last
    member keeps its own cotangent and the others give zeros (the masked
    ``psum``'s transpose): every member computes the same function of the
    broadcast value (the pipelined model's head and loss, on the same
    rows), so one member's cotangent is the whole gradient. The schedules
    read this cotangent on the last stage only."""

    @staticmethod
    def forward(ctx, x, group):
        last = group_size(group) - 1
        ctx.keeps = group_rank(group) == last
        return broadcast_in_group(x, group, last)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keeps else torch.zeros_like(grad)), None


def pipe_broadcast_last(x: torch.Tensor, group) -> torch.Tensor:
    """The masked ``psum`` of the JAX pipeline: the last member's ``x``
    on every member of ``group``, differentiable (`_BroadcastLast`)."""
    return x if _trivial(group) else _BroadcastLast.apply(x, group)


# --- The sharded weight-update layout -----------------------------------------
#
# ZeRO-1 (Xu et al., arXiv:2004.13336) shards each parameter's optimizer
# state along its first dp-divisible dimension (`zero1_shard_dim`, the one
# rule). The scatter reduction lays each dtype-homogeneous bucket out as a
# [dp, cols] matrix whose row s is exactly shard s's slice of every leaf in
# the bucket (`flatten_scatter_buckets`), so one reduce-scatter hands every
# rank the gradient slice its optimizer shard consumes. Leaves with no
# dp-divisible dimension ("tail" leaves) are zero-padded to a dp multiple
# and ride the same buckets; their full values come back by an all-gather
# of just their columns. Each bucket is assembled only from the leaf pieces
# it carries and each leaf only from the buckets that carry it, so a
# bucket's collective can issue as soon as its leaves' gradients are final.
# The cut points equal a concat-then-split at ``bucket_bytes``. torch's
# layouts differ from flax's (a Linear weight is [out, in], a conv
# [Cout, Cin, H, W]), so the rule picks other dims on the port's own
# parameters; sums and elementwise optimizers do not care.


def zero1_shard_dim(shape, dp: int):
    """The first dimension of ``shape`` that ``dp`` divides, or None (the
    leaf and its optimizer state stay replicated)."""
    for i, dim in enumerate(shape):
        if dim % dp == 0:
            return i
    return None


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _scatter_matrix(a: torch.Tensor, sd, dp: int) -> torch.Tensor:
    """Leaf ``a`` as its [dp, cols] block matrix: the shard dim moved first
    (row s = shard s's block), or raveled and zero-padded for a tail
    leaf."""
    if sd is not None:
        return torch.movedim(a, sd, 0).reshape(dp, -1)
    v = a.reshape(-1)
    pad = (-v.numel()) % dp
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v.reshape(dp, -1)


def scatter_plan(shapes, dtypes, dp: int, bucket_bytes: int | None = None,
                 *, reverse: bool = False):
    """The bucket layout `flatten_scatter_buckets` builds, from the leaves'
    shapes and dtypes alone: ``(sdims, descs, bucket_dtypes)``, where
    ``descs[b]`` holds bucket b's ``(leaf_index, column_width)`` pieces in
    order."""
    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_BYTES
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    dp = int(dp)
    if dp < 1:
        raise ValueError(f"scatter shard count must be >= 1, got {dp}")
    sdims = [zero1_shard_dim(s, dp) for s in shapes]
    by_dtype: dict = {}
    order = range(len(shapes) - 1, -1, -1) if reverse else range(len(shapes))
    for i in order:
        by_dtype.setdefault(dtypes[i], []).append(i)
    descs, bucket_dtypes = [], []
    for dt, idxs in by_dtype.items():
        per = max(1, bucket_bytes // (dp * dt.itemsize))
        pdesc, cols, open_ = [], 0, False
        for i in idxs:
            n = _numel(shapes[i])
            w = (n // dp if sdims[i] is not None else -(-n // dp))
            if w == 0:
                pdesc.append((i, 0))
                open_ = True
                continue
            off = 0
            while off < w:
                take = min(per - cols, w - off)
                pdesc.append((i, take))
                open_ = True
                cols += take
                off += take
                if cols == per:
                    descs.append(tuple(pdesc))
                    bucket_dtypes.append(dt)
                    pdesc, cols, open_ = [], 0, False
        if open_:
            descs.append(tuple(pdesc))
            bucket_dtypes.append(dt)
    return tuple(sdims), tuple(descs), tuple(bucket_dtypes)


def assemble_scatter_bucket(mats, pieces, dtype, device=None):
    """One scatter-layout bucket as a flat [dp · cols] tensor: the leaves'
    [dp, cols] matrices ``mats`` (by leaf index) cut at ``pieces``, its
    `scatter_bucket_pieces` entry."""
    parts = [mats[i] if (lo == 0 and hi == mats[i].shape[1])
             else mats[i][:, lo:hi] for i, lo, hi in pieces]
    if not parts:
        return torch.zeros((0,), dtype=dtype, device=device)
    mat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return mat.reshape(-1)


def flatten_scatter_buckets(tree, dp: int, bucket_bytes: int | None = None,
                            *, reverse: bool = False):
    """Pack a tree into scatter-ready dtype-homogeneous 1-D buckets of
    ``dp · cols`` elements (see the section comment). Returns ``(buckets,
    spec)``; the spec is ``(treedef, shapes, dtypes, sdims, dp, descs)``,
    ``descs`` holding each bucket's ``(leaf_index, column_width)``
    pieces."""
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    dtypes = tuple(leaf.dtype for leaf in leaves)
    sdims, descs, bdtypes = scatter_plan(shapes, dtypes, dp, bucket_bytes,
                                         reverse=reverse)
    spec = (treedef, shapes, dtypes, sdims, int(dp), descs)
    mats = [_scatter_matrix(leaf, sd, int(dp))
            for leaf, sd in zip(leaves, sdims)]
    buckets = [assemble_scatter_bucket(mats, pieces, dt,
                                       leaves[desc[0][0]].device)
               for pieces, dt, desc in zip(scatter_bucket_pieces(spec),
                                           bdtypes, descs)]
    return buckets, spec


def bucket_families(spec) -> list:
    """Per bucket: ``"scatter"`` (every piece's leaf has a dp-divisible
    dim), ``"tail"`` (none has) or ``"mixed"``."""
    sdims = spec[3]
    fams = []
    for pieces in spec[5]:
        kinds = {"scatter" if sdims[i] is not None else "tail"
                 for i, _w in pieces}
        fams.append(kinds.pop() if len(kinds) == 1 else
                    ("mixed" if kinds or len(pieces) else "scatter"))
    return fams


def bucket_tail_spans(spec) -> list:
    """Per bucket, the ordered ``(column_start, width)`` spans of its tail
    pieces: the columns whose reduced rows are all-gathered back to full
    values. An empty tuple: a pure-scatter bucket."""
    sdims = spec[3]
    out = []
    for pieces in spec[5]:
        col, spans = 0, []
        for i, w in pieces:
            if sdims[i] is None and w:
                spans.append((col, w))
            col += w
        out.append(tuple(spans))
    return out


def scatter_bucket_pieces(spec) -> list:
    """Per bucket of a scatter spec, ``(leaf, lo, hi)``: the leaf's row
    columns ``[lo, hi)`` it carries, in order."""
    offsets: dict = {}
    out = []
    for pieces in spec[5]:
        cur = []
        for i, w in pieces:
            if w == 0:
                continue
            lo = offsets.get(i, 0)
            cur.append((i, lo, lo + w))
            offsets[i] = lo + w
        out.append(cur)
    return out


def unflatten_scatter_buckets(entries, spec):
    """Inverse of `flatten_scatter_buckets` after a scatter reduction.
    Each bucket's entry is this rank's reduced row ``[cols]``, or, for a
    bucket with tail pieces, ``(row, gathered)`` where ``gathered`` holds
    the bucket's tail columns gathered back to ``[dp, tail_cols]`` (flat,
    row-major). Scatter leaves come back as this rank's block (the shard
    dim divided by dp), tail leaves whole; dtypes are restored."""
    treedef, shapes, dtypes, sdims, dp, descs = spec
    if len(entries) != len(descs):
        raise ValueError(
            f"unflatten_scatter_buckets got {len(entries)} buckets for a "
            f"spec describing {len(descs)} — bucket list and spec do not "
            "match"
        )
    parts: list[list] = [[] for _ in shapes]
    for entry, pieces in zip(entries, descs):
        if isinstance(entry, (tuple, list)):
            row, gathered = entry
        else:
            row, gathered = entry, None
        tail_cols = sum(w for i, w in pieces if sdims[i] is None)
        gm = None
        if tail_cols:
            if gathered is None:
                raise ValueError(
                    "bucket carries tail-family pieces but its entry is a "
                    "bare local row — pass (local_row, gathered_tails); "
                    "see bucket_tail_spans"
                )
            gm = gathered.reshape(dp, tail_cols)
        col = tcol = 0
        for i, w in pieces:
            if w == 0:
                continue
            if sdims[i] is None:
                parts[i].append(gm[:, tcol:tcol + w])
                tcol += w
            else:
                parts[i].append(row[col:col + w])
            col += w
    leaves: list = [None] * len(shapes)
    for i, segs in enumerate(parts):
        if sdims[i] is not None:
            sd = sdims[i]
            rest = tuple(shapes[i][:sd]) + tuple(shapes[i][sd + 1:])
            blk = shapes[i][sd] // dp
            vec = (torch.zeros((0,), dtype=dtypes[i]) if not segs
                   else segs[0] if len(segs) == 1 else torch.cat(segs))
            leaves[i] = torch.movedim(vec.reshape((blk,) + rest), 0,
                                      sd).to(dtypes[i])
        else:
            n = _numel(shapes[i])
            if not segs:
                flat = torch.zeros((n,), dtype=dtypes[i])
            else:
                mat = segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
                flat = mat.reshape(-1)[:n]
            leaves[i] = flat.reshape(shapes[i]).to(dtypes[i])
    return tree_unflatten(treedef, leaves)


def unflatten_scatter_full(buckets, spec):
    """Inverse of `flatten_scatter_buckets` from whole (un-scattered)
    ``[dp · cols]`` buckets: the error-feedback residual's path, and the
    gather of updated shards back into parameters."""
    treedef, shapes, dtypes, sdims, dp, descs = spec
    if len(buckets) != len(descs):
        raise ValueError(
            f"unflatten_scatter_full got {len(buckets)} buckets for a "
            f"spec describing {len(descs)} — bucket list and spec do not "
            "match"
        )
    parts: list[list] = [[] for _ in shapes]
    for b, pieces in zip(buckets, descs):
        cols = sum(w for _i, w in pieces)
        m = b.reshape(dp, cols)
        col = 0
        for i, w in pieces:
            if w == 0:
                continue
            parts[i].append(m[:, col:col + w])
            col += w
    leaves: list = [None] * len(shapes)
    for i, segs in enumerate(parts):
        if not segs:
            leaves[i] = torch.zeros(shapes[i], dtype=dtypes[i])
            continue
        mat = segs[0] if len(segs) == 1 else torch.cat(segs, dim=1)
        if sdims[i] is not None:
            sd = sdims[i]
            rest = tuple(shapes[i][:sd]) + tuple(shapes[i][sd + 1:])
            moved = mat.reshape((shapes[i][sd],) + rest)
            leaves[i] = torch.movedim(moved, 0, sd).to(dtypes[i])
        else:
            n = _numel(shapes[i])
            leaves[i] = mat.reshape(-1)[:n].reshape(shapes[i]).to(dtypes[i])
    return tree_unflatten(treedef, leaves)


def slice_zero1_local(tree, dp: int, index: int | None = None):
    """Each leaf of a fully reduced tree cut to shard ``index``'s block
    (default: this rank's); leaves with no dp-divisible dim pass through
    whole."""
    if index is None:
        index = runtime.rank()

    def cut(leaf):
        sd = zero1_shard_dim(tuple(leaf.shape), dp)
        if sd is None:
            return leaf
        blk = leaf.shape[sd] // dp
        return leaf.narrow(sd, index * blk, blk)

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [cut(torch.as_tensor(l)) for l in leaves])


# --- The quantized wire ---------------------------------------------------------
#
# int8/fp8 reductions (EQuARX's aggressive tier): one f32 scale per bucket,
# payloads on the wire, sums dequantized in f32 so no sub-16-bit partial
# sum ever exists. The arithmetic is the JAX package's op for op; divisions
# take a tensor divisor, since CUDA turns a division by a Python scalar
# into a multiplication by its reciprocal, which rounds otherwise.

#: Wire dtype -> its largest magnitude (the scale's denominator). int8 keeps
#: the symmetric [-127, 127] grid; fp8 is e4m3 (max finite 448).
_QUANTIZED_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def is_quantized_wire(wire_dtype) -> bool:
    """Whether ``wire_dtype`` takes the quantized reduction (int8/fp8)
    rather than a cast-then-sum (bf16/fp16)."""
    return wire_dtype in _QUANTIZED_QMAX


def _quantize(v: torch.Tensor, wire_dtype):
    """``(payload, scale)``: ``v`` scaled by one f32 scalar onto the wire
    grid, int8 rounded half to even. An all-zero ``v`` has scale 0 and
    zero payload (no 0/0)."""
    qmax = _QUANTIZED_QMAX[wire_dtype]
    v = v.float()
    amax = (v.abs().amax() if v.numel()
            else torch.zeros((), dtype=torch.float32, device=v.device))
    scale = amax / torch.full((), qmax, dtype=torch.float32,
                              device=v.device)
    inv = torch.where(scale > 0, torch.reciprocal(scale),
                      torch.zeros_like(scale))
    scaled = torch.clamp(v * inv, -qmax, qmax)
    if wire_dtype == torch.int8:
        return torch.round(scaled).to(torch.int8), scale
    return scaled.to(wire_dtype), scale


def _dequantize(payload: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return payload.float() * scale


def _quantized_gather_sum(v, wire_dtype, *, group=None):
    """The one-shot gather-sum, kept as the reference for
    `quantized_group_sum`: every member gathers every payload and sums
    locally (receive bytes = group size × payload). Returns ``(sum_f32,
    own_error)``."""
    payload, scale = _quantize(v, wire_dtype)
    own = _dequantize(payload, scale)
    gathered = all_gather_tensor(payload, group)
    scales = all_gather_tensor(scale, group)
    scales = scales.reshape((-1,) + (1,) * (gathered.dim() - 1))
    total = (gathered.float() * scales).sum(0)
    return total, v.float() - own


def _quantized_matrix_reduce_scatter(mat, wire_dtype, *, group=None):
    """The quantized reduce-scatter shot: ``mat`` is this member's f32
    ``[g, chunk]`` contribution, row j the chunk member j owns; it is
    quantized with one scale and moved by an all-to-all, and each member
    sums the chunks it receives in f32. Returns ``(chunk_sum_f32,
    error)``, the error ``[g, chunk]``."""
    payload, scale = _quantize(mat, wire_dtype)
    own = _dequantize(payload, scale)
    recv = all_to_all(payload, group)
    scales = all_gather_tensor(scale, group)
    chunk = (recv.float() * scales.reshape(-1, 1)).sum(0)
    return chunk, mat.float() - own


def quantized_group_sum(v, wire_dtype, *, group=None, group_position=None):
    """Sum ``v`` over ``group`` (None: the world) with only wire-dtype
    bytes on the wire, as a two-shot reduce-scatter + all-gather: shot 1
    pads ``v`` to a group-size multiple, cuts one chunk per member, and
    runs `_quantized_matrix_reduce_scatter`; shot 2 re-quantizes each
    member's reduced chunk and all-gathers the (payload, scale) pairs.

    ``group_position`` is this rank's index in ``group`` (the chunk it
    owns, where shot 2's error is charged); by default its rank there.
    Returns ``(sum_f32, own_error)``: this rank's shot-1 error everywhere
    plus shot 2's on the chunk it owns, so the errors summed over the
    group equal the true sum minus the delivered sum."""
    g = group_size(group)
    if group_position is None:
        group_position = group_rank(group)
    shape = v.shape
    flat = v.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % g
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mat = flat.reshape(g, -1)
    chunk, err1 = _quantized_matrix_reduce_scatter(mat, wire_dtype,
                                                   group=group)
    p2, s2 = _quantize(chunk, wire_dtype)
    dq2 = _dequantize(p2, s2)
    gathered = all_gather_tensor(p2, group)
    s2s = all_gather_tensor(s2, group)
    total = (gathered.float() * s2s.reshape(-1, 1)).reshape(-1)
    err = err1.clone()
    err[group_position] += chunk - dq2
    return total[:n].reshape(shape), err.reshape(-1)[:n].reshape(shape)


# --- The boundary reduction ---------------------------------------------------


def _compress16(orig_dtype, wire_dtype) -> bool:
    """Whether ``wire_dtype`` is a plain cast wire narrower than a floating
    ``orig_dtype``."""
    return (wire_dtype is not None and not is_quantized_wire(wire_dtype)
            and orig_dtype.is_floating_point
            and wire_dtype.itemsize < orig_dtype.itemsize)


def _check_dcn(dcn: int) -> int:
    n = group_size()
    if dcn < 1 or n % dcn:
        raise ValueError(f"dcn factor {dcn} does not divide the world size "
                         f"{n}")
    return n


def hierarchical_psum(x, dcn: int, *, wire_dtype=None, ici_wire_dtype=None):
    """Two-hop sum over the world factored as (dcn outer, ici inner)
    (`parallel.mesh.hier_groups`): hop 1 sums within each ici group, in
    full precision or on ``ici_wire_dtype`` (a 16-bit cast, or a quantized
    `quantized_group_sum`); hop 2 sums across the dcn groups, cast to
    ``wire_dtype`` or quantized. With no wire it equals the flat sum up to
    addition order."""
    return _hierarchical_psum_err(x, dcn, wire_dtype=wire_dtype,
                                  ici_wire_dtype=ici_wire_dtype)[0]


def _hierarchical_psum_err(x, dcn: int, *, wire_dtype=None,
                           ici_wire_dtype=None, residual=None):
    """`hierarchical_psum` returning ``(sum, error)``: ``residual`` is added
    before the first quantized hop and each quantized hop charges its own
    error (per-hop charging); with no quantized hop the residual is flushed
    (sent whole, zero error back). The error is None without a
    residual."""
    from horovod_tpu_torch.parallel import mesh

    n = _check_dcn(dcn)
    orig = x.dtype
    floating = orig.is_floating_point
    quantize_dcn = is_quantized_wire(wire_dtype) and floating
    quantize_ici = is_quantized_wire(ici_wire_dtype) and floating and n > dcn
    ici_g, dcn_g, ici_pos, dcn_pos = mesh.hier_groups(dcn)
    if residual is not None and not (quantize_dcn or quantize_ici):
        x = x.float() + residual
        residual = None
        err = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    else:
        err = None
    if quantize_ici:
        v = x.float()
        if residual is not None:
            v = v + residual
            residual = None
        x, e1 = quantized_group_sum(v, ici_wire_dtype, group=ici_g,
                                    group_position=ici_pos)
        err = e1 if err is None else err + e1
    elif n > dcn:
        if _compress16(orig, ici_wire_dtype):
            x = all_reduce_sum(x.to(ici_wire_dtype), ici_g).to(orig)
        else:
            x = all_reduce_sum(x, ici_g)
    if quantize_dcn:
        v = x.float()
        if residual is not None:
            v = v + residual
        total, e2 = quantized_group_sum(v, wire_dtype, group=dcn_g,
                                        group_position=dcn_pos)
        err = e2 if err is None else err + e2
        return total.to(orig), err
    if _compress16(orig, wire_dtype):
        x = x.to(wire_dtype)
    return all_reduce_sum(x, dcn_g).to(orig), err


def reduce_dense_bucket(b, residual=None, *, dcn: int = 1, wire_dtype=None,
                        ici_wire_dtype=None, group=None):
    """One dense bucket summed over the world: two-hop when ``dcn > 1``,
    else a quantized `quantized_group_sum` for an int8/fp8 wire or a sum
    cast to the 16-bit wire. Returns ``(sum, error)`` (error None without
    ``residual``; zeros where no quantized hop ran). ``group`` (a mesh's
    batch group) takes the exact and 16-bit single-hop sums only."""
    orig = b.dtype
    if group is not None and (dcn > 1 or is_quantized_wire(wire_dtype)):
        raise ValueError("a reduction over a subgroup is single-hop and "
                         "exact or 16-bit")
    if dcn > 1:
        return _hierarchical_psum_err(b, dcn, wire_dtype=wire_dtype,
                                      ici_wire_dtype=ici_wire_dtype,
                                      residual=residual)
    if is_quantized_wire(wire_dtype) and orig.is_floating_point:
        v = b.float()
        if residual is not None:
            v = v + residual
        total, err = quantized_group_sum(v, wire_dtype)
        return total.to(orig), (err if residual is not None else None)
    if residual is not None:
        b = b.float() + residual
    if _compress16(orig, wire_dtype):
        b = b.to(wire_dtype)
    out = all_reduce_sum(b, group).to(orig)
    return out, (None if residual is None
                 else torch.zeros(residual.shape, dtype=torch.float32,
                                  device=residual.device))


def reduce_scatter_bucket(b, residual=None, *, dcn: int = 1, wire_dtype=None,
                          ici_wire_dtype=None):
    """Reduce-scatter one flat ``[dp · cols]`` scatter-layout bucket over
    the world (two-hop when ``dcn > 1``, the 16-bit wire on the dcn hop or
    the single hop, ``ici_wire_dtype`` on the ici hop; a quantized ici
    wire runs `_quantized_matrix_reduce_scatter` there). Returns
    ``(row, error)``: this rank's reduced ``[cols]`` row and the bucket's
    whole f32 untransmitted remainder (None without ``residual``)."""
    from horovod_tpu_torch.parallel import mesh

    orig = b.dtype
    if residual is not None:
        b = b.float() + residual
    err = None
    if dcn <= 1:
        x = b.to(wire_dtype) if _compress16(orig, wire_dtype) else b
        out = reduce_scatter_sum(x).to(orig)
        if residual is not None:
            err = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        return out, err
    n = _check_dcn(dcn)
    ici = n // dcn
    ici_g, dcn_g, _, _ = mesh.hier_groups(dcn)
    cols = b.numel() // n
    # Rows are ordered by global target o·ici + i; hop 1 scatters the ici
    # index, so arrange target-inner-major first.
    t = b.reshape(dcn, ici, cols).transpose(0, 1).reshape(-1)
    if ici > 1:
        if is_quantized_wire(ici_wire_dtype) and orig.is_floating_point:
            mat = t.float().reshape(ici, dcn * cols)
            part, e1 = _quantized_matrix_reduce_scatter(
                mat, ici_wire_dtype, group=ici_g)
            if residual is not None:
                err = e1.reshape(ici, dcn, cols).transpose(0, 1).reshape(-1)
        elif _compress16(orig, ici_wire_dtype):
            part = reduce_scatter_sum(t.to(ici_wire_dtype), ici_g).to(orig)
        else:
            part = reduce_scatter_sum(t, ici_g)
    else:
        part = t
    y = part.to(wire_dtype) if _compress16(orig, wire_dtype) else part
    out = reduce_scatter_sum(y, dcn_g)
    if residual is not None and err is None:
        err = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    return out.to(orig), err


def gather_tail_columns(row, spans):
    """A scatter bucket's tail columns (`bucket_tail_spans`) of this rank's
    reduced ``row``, gathered from every rank: flat ``[dp, tail_cols]``."""
    tail = (row[spans[0][0]:spans[0][0] + spans[0][1]] if len(spans) == 1
            else torch.cat([row[c:c + w] for c, w in spans]))
    return all_gather_tensor(tail).reshape(-1)


class BucketPlan:
    """The bucket layout of a list of leaves (their shapes and dtypes):
    dense (`flatten_buckets`) or, with ``scatter=dp``, the ZeRO-1 scatter
    layout (`flatten_scatter_buckets`), each bucket as the leaf pieces it
    carries so that it can be assembled alone. Under ``scatter`` a
    quantized ``wire_dtype`` on floating leaves keeps the dense layout and
    ``cut`` is set: the reduced leaves are cut to this rank's blocks
    (`slice_zero1_local`)."""

    def __init__(self, shapes, dtypes, bucket_bytes: int | None = None, *,
                 reverse: bool = False, scatter: int | None = None,
                 wire_dtype=None):
        if bucket_bytes is None:
            bucket_bytes = DEFAULT_BUCKET_BYTES
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self.dtypes = tuple(dtypes)
        scatter = int(scatter) if scatter is not None and int(scatter) > 1 \
            else None
        self.cut = None
        if scatter and is_quantized_wire(wire_dtype) and all(
                d.is_floating_point for d in self.dtypes):
            scatter, self.cut = None, scatter
        self.scatter = scatter
        metas = [torch.empty(s, dtype=d, device="meta")
                 for s, d in zip(self.shapes, self.dtypes)]
        if scatter:
            metas_b, self.spec = flatten_scatter_buckets(
                metas, scatter, bucket_bytes, reverse=reverse)
            self.pieces = scatter_bucket_pieces(self.spec)
            self.spans = bucket_tail_spans(self.spec)
            self.sdims = self.spec[3]
        else:
            metas_b, self.spec = flatten_buckets(metas, bucket_bytes,
                                                 reverse=reverse)
            self.pieces = dense_bucket_pieces(self.spec, int(bucket_bytes))
            self.spans = [()] * len(self.pieces)
        self.numels = [b.numel() for b in metas_b]
        self.bucket_dtypes = [b.dtype for b in metas_b]
        self.leaf_buckets: dict = {}
        for k, pieces in enumerate(self.pieces):
            for i, _, _ in pieces:
                self.leaf_buckets.setdefault(i, set()).add(k)

    def assemble(self, k: int, leaves: list, cache: dict, device):
        """Bucket ``k`` of ``leaves`` (``cache`` keeps each leaf's flat or
        [dp, cols] form between buckets). A dense bucket of one leaf's
        contiguous elements is a view of that leaf."""
        pieces = self.pieces[k]
        for i, _, _ in pieces:
            if i not in cache:
                cache[i] = (_scatter_matrix(leaves[i], self.sdims[i],
                                            self.scatter)
                            if self.scatter else leaves[i].reshape(-1))
        if self.scatter:
            return assemble_scatter_bucket(cache, pieces,
                                           self.bucket_dtypes[k], device)
        parts = [cache[i][lo:hi] for i, lo, hi in pieces]
        if not parts:
            return torch.zeros((0,), dtype=self.bucket_dtypes[k],
                               device=device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class Reduction:
    """One bucketed reduction of ``leaves`` over the world on ``plan``, in
    stages: each bucket is assembled from its own leaves' pieces
    (`assemble`; `leaf_ready` does it as the leaves arrive and issues the
    buckets it completes), reduced into buffers allocated here on
    ``device`` (`issue`, `communicate`), and the reduced buckets unpacked
    to leaves (`unpack`).
    A captured CUDA graph that runs the first or last stage owns every
    buffer the others read or write, at fixed addresses; `communicate`
    reduces every bucket again at each call.

    Each bucket goes through `reduce_dense_bucket` or, in the scatter
    layout, `reduce_scatter_bucket` (tail columns all-gathered back). With
    ``donate`` the leaves may be overwritten: an exact single-hop dense
    bucket without a residual is then summed in place, the bucket being
    its own output (a view of the leaf where it holds one leaf's
    elements), and with ``overlapped`` issue it goes out asynchronously.

    ``residuals`` (error feedback, f32 leaves shaped like ``leaves``) are
    added before quantization; `unpack` then also returns the new
    residual. ``group`` reduces over a subgroup instead of the world (a
    mesh's batch group; dense, single-hop, exact or 16-bit wires)."""

    def __init__(self, plan: BucketPlan, leaves, residuals=None, *, device,
                 dcn: int = 1, wire_dtype=None, ici_wire_dtype=None,
                 donate: bool = False, group=None):
        if group is not None and (plan.scatter or plan.cut
                                  or residuals is not None):
            raise ValueError("a reduction over a subgroup is dense, without "
                             "ZeRO-1 or error feedback")
        if residuals is not None:
            if (tuple(tuple(r.shape) for r in residuals) != plan.shapes
                    or any(r.dtype != d for r, d in zip(residuals,
                                                         plan.dtypes))):
                raise ValueError(
                    "error-feedback residual buckets do not align with the "
                    "gradient buckets — the residual (f32 leaves) must "
                    "bucket identically to the gradient tree; cast the "
                    "gradients to float32 before reduce_gradients")
            if plan.scatter and not is_quantized_wire(ici_wire_dtype):
                raise ValueError(
                    "error-feedback residuals require a quantized wire "
                    "dtype (int8/fp8) on one of the hops; non-quantized "
                    "scatter reductions are lossless and carry no residual")
        self.plan = plan
        self.leaves = list(leaves)
        self.residuals = residuals
        self.dcn, self.wire_dtype = int(dcn), wire_dtype
        self.ici_wire_dtype = ici_wire_dtype
        self.group = group
        self.device = device
        self.in_place = (donate and not plan.scatter and self.dcn <= 1
                         and residuals is None
                         and not is_quantized_wire(wire_dtype))
        n = len(plan.pieces)
        self.buckets = [None] * n
        self.res_buckets = [None] * n
        self.done = [False] * n
        self.pending: dict = {}
        self._cache: dict = {}
        self._res_cache: dict = {}
        dp = plan.scatter or 1
        self.out = [None if self.in_place else
                    torch.empty((m // dp,), dtype=d, device=device)
                    for m, d in zip(plan.numels, plan.bucket_dtypes)]
        self.gathered = [
            torch.empty((dp * sum(w for _, w in sp),), dtype=d,
                        device=device) if sp else None
            for sp, d in zip(plan.spans, plan.bucket_dtypes)]
        self.err = (None if residuals is None else
                    [torch.empty((m,), dtype=torch.float32, device=device)
                     for m in plan.numels])
        self.left = [len({i for i, _, _ in p}) for p in plan.pieces]

    def assemble(self, k: int) -> None:
        if self.buckets[k] is None:
            self.buckets[k] = self.plan.assemble(k, self.leaves, self._cache,
                                                 self.device)
            if self.residuals is not None:
                self.res_buckets[k] = self.plan.assemble(
                    k, self.residuals, self._res_cache, self.device)
            if self.in_place:
                self.out[k] = self.buckets[k]

    def leaf_ready(self, i: int, leaf: torch.Tensor) -> None:
        """Leaf ``i`` is final: every bucket it completes is assembled and
        issued (``overlapped``)."""
        self.leaves[i] = leaf
        for k in sorted(self.plan.leaf_buckets.get(i, ())):
            self.left[k] -= 1
            if self.left[k] == 0:
                self.assemble(k)
                self.issue(k, overlapped=True)

    def issue(self, k: int, overlapped: bool = False) -> None:
        """Reduce bucket ``k`` into its buffers (asynchronously where
        ``overlapped`` and in place; `communicate` collects it)."""
        b, r = self.buckets[k], self.res_buckets[k]
        self.done[k] = True
        kw = dict(dcn=self.dcn, wire_dtype=self.wire_dtype,
                  ici_wire_dtype=self.ici_wire_dtype)
        if self.group is not None:
            kw["group"] = self.group
        if self.in_place:
            w = (b.to(self.wire_dtype) if _compress16(b.dtype, self.wire_dtype)
                 else b)
            wait = allreduce_sum_(w, async_op=overlapped, group=self.group)

            def finish() -> None:
                wait()
                if w is not b:
                    b.copy_(w)

            if overlapped:
                self.pending[k] = finish
            else:
                finish()
            return
        if self.plan.scatter:
            row, err = reduce_scatter_bucket(b, r, **kw)
            self.out[k].copy_(row)
            spans = self.plan.spans[k]
            if spans:
                self.gathered[k].copy_(gather_tail_columns(row, spans))
        else:
            total, err = reduce_dense_bucket(b, r, **kw)
            self.out[k].copy_(total)
        if r is not None:
            self.err[k].copy_(err)

    def communicate(self) -> None:
        """Every bucket not yet issued is reduced (all are assembled by
        now), and the asynchronous ones are collected."""
        for k in range(len(self.buckets)):
            self.assemble(k)
            if not self.done[k]:
                self.issue(k)
        self.wait()
        # A step captured in graphs around this stage replays this
        # reduction: every bucket is reduced again at the next call.
        self.done = [False] * len(self.done)

    def wait(self) -> None:
        """Collect the asynchronous buckets."""
        for k in sorted(self.pending):
            self.pending[k]()
        self.pending.clear()

    def unpack(self, divisor: int = 1):
        """``(leaves, new_residuals)``: the reduced leaves (divided by
        ``divisor``, in place in the reduced buckets; in the scatter layout
        or under ``plan.cut`` a sharded leaf is this rank's block), and the
        new residual leaves (None without residuals)."""
        plan = self.plan
        if divisor != 1:
            for o in self.out + [g for g in self.gathered if g is not None]:
                o.div_(divisor)
        new_res = None
        if plan.scatter:
            local = unflatten_scatter_buckets(
                [(o, g) if g is not None else o
                 for o, g in zip(self.out, self.gathered)], plan.spec)
            if self.residuals is not None:
                new_res = unflatten_scatter_full(self.err, plan.spec)
        else:
            local = unflatten_buckets(self.out, plan.spec)
            if self.residuals is not None:
                new_res = unflatten_buckets(self.err, plan.spec)
            if plan.cut:
                local = slice_zero1_local(local, plan.cut)
        return local, new_res


def reduce_gradients(tree, *, dcn: int = 1, wire_dtype=None,
                     ici_wire_dtype=None, bucket_bytes: int | None = None,
                     reverse: bool = False, residual=None,
                     scatter: int | None = None):
    """The boundary gradient reduction over the world, eagerly: SUM
    semantics (callers divide), bucket-fused, one `Reduction` on a
    `BucketPlan`; ``reverse`` buckets and issues the leaves last-first.
    The leaves of ``tree`` are not written.

    ``residual`` (error feedback, a tree of f32 leaves like ``tree``) is
    added before quantization; the call then returns ``(reduced,
    new_residual)``, the new residual this rank's untransmitted remainder
    summed over the quantized hops (flushed to zeros where none ran).

    ``scatter=dp`` lowers the reduction into the ZeRO-1 layout: leaves
    with a dp-divisible dim come back as this rank's block, the rest whole.
    Exact wires reduce-scatter each scatter-layout bucket
    (`reduce_scatter_bucket`) and all-gather the tail columns; a quantized
    dcn wire keeps the dense layout (the same arithmetic as the replicated
    reduction, residual included) and cuts locally
    (`slice_zero1_local`)."""
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(l) for l in leaves]
    res_leaves = None
    if residual is not None:
        res_leaves = [torch.as_tensor(l) for l in tree_flatten(residual)[0]]
    plan = BucketPlan([l.shape for l in leaves], [l.dtype for l in leaves],
                      bucket_bytes, reverse=reverse, scatter=scatter,
                      wire_dtype=wire_dtype)
    dev = leaves[0].device if leaves else torch.device("cpu")
    red = Reduction(plan, leaves, res_leaves, dcn=dcn, wire_dtype=wire_dtype,
                    ici_wire_dtype=ici_wire_dtype, device=dev)
    red.communicate()
    out, new_res = red.unpack()
    out = tree_unflatten(treedef, out)
    if residual is None:
        return out
    return out, tree_unflatten(treedef, [l.float() for l in new_res])
