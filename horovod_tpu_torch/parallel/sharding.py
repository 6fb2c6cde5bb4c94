"""How tensors meet the mesh — port of `horovod_tpu.parallel.sharding`.

The JAX package places arrays with ``NamedSharding``s and lets GSPMD move
them. The port has one process a rank, so a placement ``{dim: axis}`` (a
`models.transformer.param_specs` entry) is a cut: this rank keeps its
coordinate's part of each placed dim (`shard_tensor`), and the parts are
joined back by an all-gather over each axis's subgroup (`gather_tensor`).

The cut is layout-aware where the port fuses projections that JAX keeps
per head. The port's ``qkv`` weight rows run q heads, then k heads, then v
heads, and ``kv_proj``'s (and the seq2seq ``cross_kv``'s) k heads, then v
heads; JAX's kernels are ``[d, H, 3·D]`` and ``[d, H_kv, 2·D]``, split per
head. On the ``model`` axis those
rows are cut per part (`fused_parts`): rank i keeps heads ``[i·H/n,
(i+1)·H/n)`` of each of q, k and v, as JAX's ``model``-sharded head dim
holds. A contiguous narrow would give rank 0 all of q and half of k. On
``fsdp`` (a memory layout, gathered whole before use by a contiguous
all-gather) and for every other parameter the cut is a contiguous
narrow.

The batch layouts: `batch_sharding` is JAX's ``P(("data", "fsdp"))`` with
the other dims unsharded, `chunk_sharding` the same after ``lead``
unsharded stack dims; `shard_batch` cuts a host array to this rank's rows
under them, rows ``[i·n/dp, (i+1)·n/dp)`` at ``i = mesh.data_index``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.mesh import (
    DATA_AXIS, FSDP_AXIS, MODEL_AXIS, P,
)

# Fused projections: the parts of dim 0 that the `model` axis cuts one by
# one (layer name -> number of parts).
_FUSED = {"qkv": 3, "kv_proj": 2, "cross_kv": 2}


class Cut(typing.NamedTuple):
    """One placed dim of a rank's parameter: the subgroup it is cut over
    and the number of fused parts cut one by one."""

    group: object
    parts: int = 1


def fused_parts(name: str, dim: int, axis: str) -> int:
    """How many parts of dim ``dim`` of parameter ``name`` the ``axis``
    cut keeps apart: 3 for ``qkv``'s and 2 for ``kv_proj``'s and
    ``cross_kv``'s rows on ``model``, else 1 (a contiguous narrow)."""
    if axis != MODEL_AXIS or dim != 0:
        return 1
    parts = name.split(".")
    layer = parts[-2] if len(parts) > 1 else ""
    return _FUSED.get(layer, 1)


def cut_dim(t, dim: int, n: int, i: int, parts: int = 1):
    """Part ``i`` of ``n`` of ``t`` along ``dim``; with ``parts`` > 1 the
    dim is ``parts`` equal blocks and part i of each is kept, in order."""
    blocks = t.chunk(parts, dim) if parts > 1 else (t,)
    kept = []
    for b in blocks:
        per = b.shape[dim] // n
        kept.append(b.narrow(dim, per * i, per))
    return kept[0] if parts == 1 else torch.cat(kept, dim)


def join_dim(pieces, dim: int, parts: int = 1):
    """Inverse of `cut_dim`: the ``n`` members' parts, in member order,
    joined along ``dim``."""
    if parts == 1:
        return torch.cat(list(pieces), dim)
    split = [p.chunk(parts, dim) for p in pieces]
    return torch.cat([s[j] for j in range(parts) for s in split], dim)


def shard_tensor(t, name: str, placement: dict, mesh):
    """This rank's part of the whole tensor ``t`` (parameter ``name``)
    under ``placement`` ``{dim: axis}`` on ``mesh``: cut at this rank's
    coordinate along every placed dim whose axis is live. No collective; a
    layout-only mesh will do."""
    for dim, ax in sorted(placement.items()):
        n = mesh.shape[ax]
        if n > 1:
            t = cut_dim(t, dim, n, mesh.coords[ax],
                        fused_parts(name, dim, ax))
    return t


def gather_tensor(t, name: str, placement: dict, mesh):
    """Inverse of `shard_tensor`: ``t`` all-gathered over each placed
    live axis's subgroup (a collective of those groups)."""
    for dim, ax in sorted(placement.items(), reverse=True):
        if mesh.shape[ax] > 1:
            pieces = collectives.all_gather_tensor(t.detach(), mesh.group(ax))
            t = join_dim(pieces.unbind(0), dim, fused_parts(name, dim, ax))
    return t


def rank_cuts(name: str, placement: dict, mesh) -> dict:
    """``placement``'s live dims as `Cut`s over ``mesh``'s subgroups (the
    form `training.optimizer.DistributedOptimizer.placements` takes)."""
    return {dim: Cut(mesh.group(ax), fused_parts(name, dim, ax))
            for dim, ax in placement.items() if mesh.shape[ax] > 1}


def weight(module, leaf: str = "weight"):
    """``module``'s parameter ``leaf``, whole over the ``fsdp`` axis where
    the model cut it there (``module.fsdp_dims``, ``module.fsdp_mesh``):
    gathered at the point of use, its gradient reduce-scattered back
    (`collectives.gather_weight`). A ``model`` cut stays: the layer
    computes on its part."""
    w = getattr(module, leaf)
    dim = getattr(module, "fsdp_dims", {}).get(leaf)
    if dim is None:
        return w
    group = module.fsdp_mesh.group(FSDP_AXIS)
    return collectives.gather_weight(w, dim, group, backward="reduce_scatter")


# -- batch layouts ---------------------------------------------------------------

_BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


def batch_sharding(ndim: int = 0) -> P:
    """A batch split along the combined data axes, the rest unsharded."""
    if ndim == 0:
        return P(_BATCH_AXES)
    return P(_BATCH_AXES, *([None] * (ndim - 1)))


def chunk_sharding(ndim: int, lead: int = 1) -> P:
    """A stack of batches with ``lead`` unsharded leading dims (``[K,
    batch, ...]`` for steps_per_execution, ``[C, K, batch, ...]`` for
    chunked accumulation): the batch dim after them over the data axes."""
    return P(*([None] * lead), _BATCH_AXES,
             *([None] * max(0, ndim - lead - 1)))


def shard_batch(tree, mesh, lead: int = 0):
    """This rank's rows of a host batch (a dict/tuple of arrays leaf by
    leaf) under `chunk_sharding` with ``lead`` stack dims
    (`batch_sharding` at 0): the dim placed on the data axes cut into
    ``mesh.data_shards`` blocks, block ``mesh.data_index`` kept."""
    dp, i = mesh.data_shards, mesh.data_index

    def cut(a):
        a = np.asarray(a)
        spec = (chunk_sharding(a.ndim, lead) if lead
                else batch_sharding(a.ndim))
        dim = spec.index(_BATCH_AXES)
        n = a.shape[dim]
        if n % dp:
            raise ValueError(f"batch dim {dim} ({n}) must divide over the "
                             f"data shards ({dp})")
        per = n // dp
        return a[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]

    return collectives.tree_map(cut, tree)
