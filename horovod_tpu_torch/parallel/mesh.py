"""Device meshes as rank subgroups, world-size-reactive hyperparameter
helpers and the two-hop topology — port of `horovod_tpu.parallel.mesh`.

The port has no device array: each rank drives one device, so a mesh is a
factoring of the ranks. `build_mesh` lays the ranks out row-major over
`AXES` (``expert`` innermost) — the JAX package's flat
``devices.reshape(shape)`` order, so an expert group is adjacent ranks on
one host — and gives each rank its coordinate on every axis and one
`torch.distributed` subgroup per live axis (the ranks that differ from it
only on that axis), plus the **batch group**: the ranks that differ only on
``data``/``fsdp``, over which metrics reduce and the feeding and dropout
seeds are cut, the **gradient group**: the ranks that differ on
``data``, ``fsdp`` or ``seq``, over which a replicated parameter's gradient
sums when tokens are sharded on ``seq`` (never ``model``: under Megatron's
operators every rank of a ``model`` group holds the same replicated
gradient), and the **shard gradient group**: the ranks that differ on
``data`` or ``seq`` only, over which an ``fsdp`` shard's gradient sums
after its reduce-scatter over ``fsdp``. A pipelined model's stages are
the ranks that differ on ``pipe`` only (`Mesh.stage`, the ``pipe``
subgroup), over which its activations cross from stage to stage. On a
pure-data mesh the first two
are the world itself (None to the collectives), so every data-parallel
path keeps its arithmetic. `P` is the JAX ``PartitionSpec`` form of a
batch layout (``Trainer(batch_specs=...)``). The data axis's (dcn outer,
ici inner) factoring for the two-hop reduction is `hier_groups`.

Axis names, as in the JAX package:

* ``data``   — batch sharding; the gradient reduction rides it;
* ``fsdp``   — parameter sharding across the data group;
* ``pipe``   — pipeline stages;
* ``seq``    — sequence parallelism;
* ``model``  — tensor parallelism;
* ``expert`` — expert parallelism for MoE layers.
"""

from __future__ import annotations

import dataclasses
import math
import socket

import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry

# Canonical axis order, outermost first (the JAX package's `AXES`).
AXES = ("data", "fsdp", "pipe", "seq", "model", "expert")

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"

#: Overrides the dcn factor (the fake-topology knob for running the two-hop
#: reduction on one host); it must divide the world size.
ENV_DCN_FACTOR = "HVT_DCN_FACTOR"

# Subgroups made by `hier_groups`, by (world size, dcn), and by
# `build_mesh`, by (world size, mesh shape): every rank makes every group,
# in one order, once per process group.
_groups: dict = {}
_mesh_groups: dict = {}
_hosts_factor: dict = {}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. -1 means "absorb all remaining ranks".
    ``MeshSpec()`` is the pure data-parallel world."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    seq: int = 1
    model: int = 1
    expert: int = 1

    @classmethod
    def from_string(cls, spec: str | None) -> "MeshSpec":
        """Parse the ``HVT_MESH`` grammar: ``"data=2,seq=4"`` (axis=size
        pairs, missing axes default). None/empty = pure DP."""
        if not spec:
            return cls()
        try:
            sizes = dict(kv.split("=") for kv in spec.split(","))
            return cls(**{k: int(v) for k, v in sizes.items()})
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad mesh spec {spec!r} (want 'axis=N,axis=N' with axes "
                f"from {AXES}): {e}"
            ) from None

    @classmethod
    def from_env(cls) -> "MeshSpec":
        """The spec ``HVT_MESH`` names (`from_string`)."""
        return cls.from_string(registry.get_raw("HVT_MESH"))

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = [ax for ax, s in sizes.items() if s != -1]
        free = [ax for ax, s in sizes.items() if s == -1]
        if len(free) > 1:
            raise ValueError(f"At most one -1 axis allowed, got {free}")
        prod = math.prod(sizes[ax] for ax in fixed)
        if free:
            if n_devices % prod != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[free[0]] = n_devices // prod
        elif prod != n_devices:
            raise ValueError(f"Mesh {sizes} wants {prod} devices, have {n_devices}")
        return sizes


class P(tuple):
    """A partition spec in the JAX form, one entry per array dim: an axis
    name, a tuple of axis names, or None (unsharded) —
    ``P(("data", "fsdp"), "seq", None)`` shards dim 0 over the batch axes
    and dim 1 over ``seq``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


#: The axes a gradient sums over when a replicated parameter meets tokens
#: sharded on them.
GRAD_AXES = (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)
#: The axes an ``fsdp`` shard's gradient sums over once the reduce-scatter
#: over ``fsdp`` has summed it there.
SHARD_GRAD_AXES = (DATA_AXIS, SEQ_AXIS)


def axis_rank_lists(shape: dict, axes) -> list[list[int]]:
    """The rank lists of the groups along ``axes`` (one axis, or several
    taken together): the ranks that share every other coordinate, in the
    row-major layout over `AXES`, groups in row-major order of the other
    coordinates."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    dims = tuple(shape[ax] for ax in AXES)
    ids = np.arange(math.prod(dims)).reshape(dims)
    pos = [AXES.index(ax) for ax in axes]
    moved = np.moveaxis(ids, pos, list(range(len(dims) - len(pos), len(dims))))
    return moved.reshape(-1, math.prod(shape[ax] for ax in axes)).tolist()


class Mesh:
    """This rank's view of a mesh: ``shape`` (axis → size, in `AXES`
    order), ``coords`` (axis → this rank's coordinate), ``size``, and the
    subgroups `group` and `batch_group`. A mesh built for another world
    than the running one (``build_mesh(..., n_ranks=, rank=)``) is a
    layout only: it has coordinates and no subgroups."""

    def __init__(self, shape: dict, rank: int, groups: dict | None):
        self.shape = {ax: int(shape[ax]) for ax in AXES}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords = {ax: int(i) for ax, i in zip(AXES, idx)}
        self._groups = groups

    def __deepcopy__(self, memo) -> "Mesh":
        return self  # a view of the process group, shared by copies

    def __repr__(self) -> str:
        live = {ax: n for ax, n in self.shape.items() if n > 1}
        return f"Mesh({live or {'data': 1}}, rank={self.rank})"

    @property
    def layout_only(self) -> bool:
        return self._groups is None

    def _group(self, key, n: int):
        from horovod_tpu_torch.parallel import collectives

        if n == 1:
            return collectives.SELF
        if self._groups is None:
            raise RuntimeError(
                f"{self!r} was built for another world than this process "
                "group's: it is a layout, with no subgroups")
        return self._groups[key]

    def group(self, axis: str):
        """The subgroup of the ranks that differ from this one only on
        ``axis`` (`collectives.SELF` for an axis of size 1)."""
        return self._group(axis, self.shape[axis])

    @property
    def batch_group(self):
        """The ranks that differ from this one only on ``data``/``fsdp``:
        None (the world) on a mesh whose other axes are all 1,
        `collectives.SELF` when the batch is not sharded."""
        if self.data_shards == self.size and self._groups is not None:
            return None
        return self._group("batch", self.data_shards)

    @property
    def grad_group(self):
        """The ranks that differ from this one on ``data``, ``fsdp`` or
        ``seq``: what a replicated parameter's gradient sums over. None
        (the world) where those axes span the mesh, `collectives.SELF`
        when they are all 1; the batch group without a live ``seq``."""
        if self.shape[SEQ_AXIS] == 1:
            return self.batch_group
        n = self.data_shards * self.shape[SEQ_AXIS]
        if n == self.size and self._groups is not None:
            return None
        return self._group("grad", n)

    @property
    def shard_grad_group(self):
        """The ranks that share this one's coordinates but on ``data`` and
        ``seq``: what an ``fsdp`` shard's gradient sums over after its
        reduce-scatter over ``fsdp``, and the ranks that hold the same
        ``fsdp`` shard. None (the world) where those axes span the mesh,
        `collectives.SELF` when they are both 1; the gradient group
        without a live ``fsdp`` axis."""
        if self.shape[FSDP_AXIS] == 1:
            return self.grad_group
        n = self.shape[DATA_AXIS] * self.shape[SEQ_AXIS]
        if n == self.size and self._groups is not None:
            return None
        return self._group("shard_grad", n)

    @property
    def seq_shards(self) -> int:
        """The size of the ``seq`` axis."""
        return self.shape[SEQ_AXIS]

    @property
    def seq_index(self) -> int:
        """This rank's sequence shard: its coordinate on ``seq``."""
        return self.coords[SEQ_AXIS]

    @property
    def stage(self) -> int:
        """This rank's pipeline stage: its coordinate on ``pipe``. The
        ranks of one stage differ on the other axes; a stage's layer
        stacks sum their gradients over the gradient group, which leaves
        ``pipe`` out."""
        return self.coords[PIPE_AXIS]

    @property
    def data_shards(self) -> int:
        """The number of batch shards, ``data × fsdp`` (`dp_size`)."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def data_index(self) -> int:
        """This rank's batch shard: its position in the batch group."""
        return (self.coords[DATA_AXIS] * self.shape[FSDP_AXIS]
                + self.coords[FSDP_AXIS])


def _make_groups(shape: dict, rank: int) -> dict:
    """This rank's subgroup of every live axis and its batch group. Every
    rank makes every group of the mesh, in one order, once per process
    group and shape."""
    key = (id(torch.distributed.group.WORLD), tuple(shape.values()))
    if key not in _mesh_groups:
        mine: dict = {}
        plan = [(ax, ax) for ax in AXES if shape[ax] > 1]
        dp = shape[DATA_AXIS] * shape[FSDP_AXIS]
        if 1 < dp < math.prod(shape.values()):
            plan.append(("batch", (DATA_AXIS, FSDP_AXIS)))
        grad = dp * shape[SEQ_AXIS]
        if shape[SEQ_AXIS] > 1 and 1 < grad < math.prod(shape.values()):
            plan.append(("grad", GRAD_AXES))
        shard = shape[DATA_AXIS] * shape[SEQ_AXIS]
        if shape[FSDP_AXIS] > 1 and 1 < shard < math.prod(shape.values()):
            plan.append(("shard_grad", SHARD_GRAD_AXES))
        for name, axes in plan:
            for ranks in axis_rank_lists(shape, axes):
                g = torch.distributed.new_group(ranks)
                if rank in ranks:
                    mine[name] = g
        _mesh_groups[key] = mine
    return _mesh_groups[key]


def build_mesh(spec: MeshSpec | None = None, n_ranks: int | None = None,
               rank: int | None = None) -> Mesh:
    """The mesh ``spec`` (default: pure data parallelism) over the world's
    ranks, laid out row-major over `AXES` — the JAX package's flat order;
    ``HVT_MESH_ORDER`` is checked as there, and both of its values give
    this layout (each rank is one process, so there is no device torus to
    map). Size-1 axes are kept. Every rank of a process group must call it
    at the same point (it makes the subgroups). ``n_ranks``/``rank``
    describe another world: the mesh is then a layout only, for
    placements and coordinates (`Mesh.layout_only`)."""
    order = registry.get_str("HVT_MESH_ORDER")
    if order not in ("auto", "flat"):
        raise ValueError(
            f"HVT_MESH_ORDER must be 'auto' or 'flat', got {order!r}"
        )
    spec = spec or MeshSpec()
    layout = n_ranks is not None or rank is not None
    n = runtime.size() if n_ranks is None else int(n_ranks)
    r = runtime.rank() if rank is None else int(rank)
    shape = spec.resolve(n)
    if not 0 <= r < n:
        raise ValueError(f"rank {r} outside a mesh of {n} ranks")
    if layout and not (n == runtime.size() and r == runtime.rank()):
        return Mesh(shape, r, None)
    groups = (_make_groups(shape, r) if runtime.is_distributed()
              and runtime.size() > 1 else {})
    return Mesh(shape, r, groups)


def data_parallel_mesh() -> Mesh:
    """The reference topology: every rank on the ``data`` axis."""
    return build_mesh(MeshSpec())


def dp_size(mesh: Mesh | None = None) -> int:
    """Number of data-parallel workers (batch shards): ``data × fsdp`` of
    ``mesh``; without one, the ranks of the world."""
    if mesh is None:
        return runtime.size()
    return mesh.shape[DATA_AXIS] * mesh.shape[FSDP_AXIS]


def has_live_model_axes(mesh: Mesh) -> bool:
    """True when any non-data axis (pipe/seq/model/expert) is larger than
    1."""
    return any(mesh.shape.get(ax, 1) > 1
               for ax in (PIPE_AXIS, SEQ_AXIS, MODEL_AXIS, EXPERT_AXIS))


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
