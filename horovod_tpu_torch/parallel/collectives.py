"""Host-level collectives over `torch.distributed` — port of the eager
(``axis_name=None``) branch of `horovod_tpu.parallel.collectives`.

Semantics follow the JAX package: ``allreduce`` averages by default (the
Horovod contract), every op is the identity without a process group (a
single process), and trees are nested dicts/lists/tuples of tensors (or
numpy arrays, or a module's ``state_dict``) flattened in JAX's leaf order:
plain-dict keys sorted, ``OrderedDict`` keys in insertion order.

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
    if t.device == _comm_device() and t.is_contiguous():
        torch.distributed.all_reduce(t)
    else:
        staged = _to_comm(t)
        torch.distributed.all_reduce(staged)
        t.copy_(staged)
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
