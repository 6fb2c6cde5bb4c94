"""Process bootstrap, topology queries, device resolution and seeds — port
of `horovod_tpu.runtime` over `torch.distributed`.

``init()`` reads the rendezvous that the launcher (`horovod_tpu_torch.
launch`) puts in each child's environment — the same ``HVT_*`` names as
the JAX package — and starts one process group: NCCL on CUDA, gloo on the
CPU. With no coordinator it is a single process, ``size() == 1``, no
process group, and every collective is the identity: the bare ``python
script.py`` mode.

Unlike the JAX package, which drives every chip of a host from one
process, the port runs one process per device and pins it, as Horovod
does: rank ``local_rank`` takes ``cuda:local_rank``. A host with more
ranks than cards is refused, since one card cannot host two NCCL ranks,
unless the caller names the backend (``init(backend="gloo")`` or
``HVT_BACKEND=gloo``): ranks then share cards (``local_rank`` modulo the
cards present) and every collective goes through the host. ``size()`` is
the number of ranks, each with one device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import numpy as np
import torch

from horovod_tpu_torch.analysis import registry

ENV_COORDINATOR = "HVT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "HVT_NUM_PROCESSES"
ENV_PROCESS_ID = "HVT_PROCESS_ID"
ENV_LOCAL_RANK = "HVT_LOCAL_RANK"
# The process group's backend, when the caller names it (``nccl``/``gloo``).
ENV_BACKEND = "HVT_BACKEND"
# Liveness contract with the restart supervisor (launch/supervisor.py):
# when set, fit() auto-installs callbacks.HeartbeatCallback, which touches
# $HVT_HEARTBEAT_DIR/rank-<rank> through training; the supervisor kills
# and relaunches a fleet whose newest beat goes stale.
ENV_HEARTBEAT_DIR = "HVT_HEARTBEAT_DIR"

# A collective that waits longer than this for a peer fails instead of
# hanging the job (the launcher then stops the other ranks).
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)

# What init() set up: None until it ran (and again after shutdown()).
_world: dict | None = None


def env_flag(name: str) -> bool:
    """Shared boolean env-var contract: unset/''/'0'/'false'/'no' are off
    (case-insensitive), anything else is on — the contract itself lives in
    `analysis.registry.flag_like`."""
    return registry.flag_like(os.environ.get(name))


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a `torch.device`, refusing a CUDA request on a host
    without CUDA. Entry points default to ``"cuda"`` and never carry on
    quietly on the CPU: the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available — "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def derive_seed(*keys: int) -> int:
    """A 63-bit seed mixed from integer keys (numpy's `SeedSequence`) — the
    port's ``jax.random.fold_in``: one seed per (step, layer, site) that
    depends on nothing but its keys, never on a generator's state."""
    words = [int(k) & (2**64 - 1) for k in keys]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


@dataclasses.dataclass(frozen=True)
class World:
    """Snapshot of the distributed topology after init()."""

    process_rank: int
    process_count: int
    local_rank: int
    device_count: int
    local_device_count: int
    hostname: str
    platform: str
    backend: str | None

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1


def _place(device_type: str, lrank: int, n_cards: int,
           backend: str | None = None) -> tuple[str, int | None]:
    """``(backend, card)`` for the rank with local rank ``lrank`` on a host
    with ``n_cards`` cards: NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one. A CUDA rank takes card ``lrank``; where the host
    has no such card, ranks share cards (``lrank % n_cards``) only under a
    backend named gloo, and anything else raises."""
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs device='cuda'")
        return "gloo", None
    if lrank < n_cards:
        return backend or "nccl", lrank
    if backend == "gloo":
        return backend, lrank % n_cards
    raise RuntimeError(
        f"local rank {lrank} has no card of its own ({n_cards} on this "
        "host) and one card cannot host two NCCL ranks: launch at most "
        f"{n_cards} ranks per host, or share the cards over gloo with "
        f"init(backend='gloo') or {ENV_BACKEND}=gloo (every collective then "
        "goes through the host)"
    )


def init(coordinator_address: str | None = None,
         num_processes: int | None = None, process_id: int | None = None,
         *, device="cuda", backend: str | None = None) -> World:
    """Initialize the distributed runtime. Idempotent, like ``hvd.init()``.

    Each of ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` resolves as: explicit argument → ``HVT_*`` env var →
    unset. With no coordinator the run is one process and no process group
    is made. ``device`` (default ``"cuda"``; raises without CUDA unless
    ``"cpu"``) is pinned as ``cuda:local_rank``. ``backend`` (argument →
    ``HVT_BACKEND`` → unset) defaults to NCCL on CUDA and gloo on the CPU;
    see `_place` for ranks that outnumber the cards."""
    global _world
    if _world is not None:
        return world()
    dev = resolve_device(device)
    backend, card = _place(
        dev.type, local_rank(),
        torch.cuda.device_count() if dev.type == "cuda" else 0,
        backend or registry.get_str(ENV_BACKEND))
    if card is not None:
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
    coordinator_address = (coordinator_address
                           or registry.get_str(ENV_COORDINATOR))
    if num_processes is None:
        num_processes = registry.get_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = registry.get_int(ENV_PROCESS_ID)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"a coordinator ({coordinator_address}) needs the world size "
                f"and this process's id ({ENV_NUM_PROCESSES}, "
                f"{ENV_PROCESS_ID})"
            )
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=COLLECTIVE_TIMEOUT,
        )
    else:
        backend = None
    _world = {"device": dev, "backend": backend}
    return world()


def shutdown() -> None:
    """Tear down the process group (no-op single-process). Every rank must
    call it at the same point: it is a barrier."""
    global _world
    if _world is None:
        return
    try:
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
    finally:
        _world = None


def is_initialized() -> bool:
    return _world is not None


def is_distributed() -> bool:
    """Whether a process group is live (even of one rank): collectives
    then really communicate."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def backend() -> str | None:
    """The process group's backend (``"nccl"``/``"gloo"``), None without
    one."""
    return torch.distributed.get_backend() if is_distributed() else None


def device() -> torch.device:
    """The device init() pinned for this rank (raises before init)."""
    if _world is None:
        raise RuntimeError("call horovod_tpu_torch.init() first")
    return _world["device"]


def world() -> World:
    dev = _world["device"] if _world is not None else torch.device("cpu")
    return World(
        process_rank=rank(), process_count=size(), local_rank=local_rank(),
        device_count=size(), local_device_count=local_size(),
        hostname=socket.gethostname(), platform=dev.type, backend=backend(),
    )


# --- Horovod-parity topology queries ----------------------------------------


def rank() -> int:
    """Global rank for single-writer gating (≈ ``hvd.rank()``): exactly one
    process returns 0."""
    return torch.distributed.get_rank() if is_distributed() else 0


def size() -> int:
    """World size for LR scaling and work division (≈ ``hvd.size()``): the
    number of ranks, each driving one device."""
    return torch.distributed.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """Ordinal of this process among those on its host (≈
    ``hvd.local_rank()``), from ``HVT_LOCAL_RANK`` (0 unlaunched) — the
    card it pins."""
    return registry.get_int(ENV_LOCAL_RANK)


def local_size() -> int:
    """Devices driven by this process (≈ the JAX package's
    ``local_device_count``): always 1 in the port."""
    return 1


def process_rank() -> int:
    return rank()


def process_count() -> int:
    return size()


def is_primary() -> bool:
    """True on exactly one process — the single writer for checkpoints,
    logs and exports."""
    return rank() == 0
