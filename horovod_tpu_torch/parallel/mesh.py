"""World-size-reactive hyperparameter helpers and the two-hop topology —
port of the helpers of `horovod_tpu.parallel.mesh`. The port has no device
mesh: each rank drives one device, so the data-parallel size is the number
of ranks, and the data axis's (dcn outer, ici inner) factoring is a
factoring of the ranks into process subgroups (`hier_groups`)."""

from __future__ import annotations

import math
import socket

import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry

#: Overrides the dcn factor (the fake-topology knob for running the two-hop
#: reduction on one host); it must divide the world size.
ENV_DCN_FACTOR = "HVT_DCN_FACTOR"

# Subgroups made by `hier_groups`, by (world size, dcn): every rank makes
# every group, in one order, once per process group.
_groups: dict = {}
_hosts_factor: dict = {}


def dp_size() -> int:
    """Number of data-parallel workers: the ranks of the world."""
    return runtime.size()


def scale_lr(base_lr: float, world_size: int | None = None) -> float:
    """Linear LR scaling, ``base × world_size`` (``Adam(0.001 *
    hvd.size())``); ``world_size`` defaults to `runtime.size`."""
    if world_size is None:
        world_size = runtime.size()
    return base_lr * world_size


def shard_steps(total_steps: int, world_size: int | None = None) -> int:
    """Per-worker steps so global work is constant: ``total // size``
    (``steps_per_epoch=500 // hvd.size()``), at least 1."""
    if world_size is None:
        world_size = runtime.size()
    return max(1, total_steps // world_size)


def shard_epochs(total_epochs: float, world_size: int | None = None) -> int:
    """Per-worker epochs: ``ceil(total / size)`` (``epochs =
    ceil(12 / hvd.size())``), at least 1."""
    if world_size is None:
        world_size = runtime.size()
    return max(1, int(math.ceil(total_epochs / world_size)))


def dcn_factor() -> int:
    """How many slower-linked groups (hosts, the JAX package's slices) the
    ranks span: ``HVT_DCN_FACTOR`` when set (it must divide the world
    size, else `ValueError`); else the number of hosts when the ranks are
    host-major with the same count on every host; else 1 (the flat
    reduction stays right). Asking the hosts is a collective the first
    time in a process group: every rank calls it at one point (the
    `Trainer` does at construction)."""
    size = runtime.size()
    dcn = registry.get_int(ENV_DCN_FACTOR)
    if dcn is not None:
        if dcn < 1 or size % dcn:
            raise ValueError(f"{ENV_DCN_FACTOR}={dcn} must divide the world "
                             f"size ({size})")
        return dcn
    if size <= 1:
        return 1
    key = (id(torch.distributed.group.WORLD), size)
    if key not in _hosts_factor:
        from horovod_tpu_torch.parallel import collectives

        hosts = collectives.allgather_object(socket.gethostname())
        blocks = [hosts[0]]
        for h in hosts[1:]:
            if h != blocks[-1]:
                blocks.append(h)
        per = size // len(blocks)
        host_major = (len(set(blocks)) == len(blocks)
                      and per * len(blocks) == size
                      and all(hosts[i * per:(i + 1) * per] == [b] * per
                              for i, b in enumerate(blocks)))
        _hosts_factor[key] = len(blocks) if host_major else 1
    return _hosts_factor[key]


def hier_index_groups(n: int, dcn: int) -> tuple[list, list]:
    """The rank lists factoring ``n`` ranks as (dcn outer, ici inner): the
    ici groups hold a fixed outer index d, the dcn groups a fixed inner
    index i (the JAX package's ``_hier_groups``)."""
    ici = n // dcn
    ici_groups = [[d * ici + i for i in range(ici)] for d in range(dcn)]
    dcn_groups = [[d * ici + i for d in range(dcn)] for i in range(ici)]
    return ici_groups, dcn_groups


def hier_groups(dcn: int):
    """``(ici_group, dcn_group, ici_position, dcn_position)`` of this rank
    for the world factored by ``dcn``: process subgroups (None for the
    trivial ones of a world without a process group) and this rank's
    index in each. The subgroups are made once per process group, every
    rank making every group in the same order."""
    n = runtime.size()
    if n % dcn:
        raise ValueError(f"dcn factor {dcn} does not divide the world size "
                         f"{n}")
    r = runtime.rank()
    ici = n // dcn
    if not runtime.is_distributed():
        return None, None, 0, 0
    key = (id(torch.distributed.group.WORLD), n, dcn)
    if key not in _groups:
        ici_lists, dcn_lists = hier_index_groups(n, dcn)
        made = [torch.distributed.new_group(ranks)
                for ranks in ici_lists + dcn_lists]
        _groups[key] = (made[:dcn], made[dcn:])
    ici_made, dcn_made = _groups[key]
    return ici_made[r // ici], dcn_made[r % ici], r % ici, r // ici
