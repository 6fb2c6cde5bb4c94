"""World-size-reactive hyperparameter helpers — port of the helpers of
`horovod_tpu.parallel.mesh`. The port has no device mesh: each rank drives
one device, so the data-parallel size is the number of ranks."""

from __future__ import annotations

import math

from horovod_tpu_torch import runtime


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
