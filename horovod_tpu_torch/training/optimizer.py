"""DistributedOptimizer — gradient-averaging wrap of a torch optimizer;
port of `horovod_tpu.training.optimizer`.

After the backward, each rank packs its gradients into dtype-homogeneous
buckets of at most ``HVT_BUCKET_BYTES`` (default 64 MB, the JAX layout of
`collectives.flatten_buckets`), casts f32 buckets to the wire dtype
(``bf16``/``fp16``), sums each bucket over the ranks in that dtype with one
all-reduce, casts back, divides by the world size (and by K with
``average_aggregated_gradients``), and unpacks — the JAX trainer's explicit
boundary reduction. A single process without a process group runs the
same arithmetic over a world of 1 (the wire round-trip included).

Gradient accumulation (``backward_passes_per_step=K``) follows the JAX
Trainer's contract: the `Trainer` runs K microbatch backwards into the f32
``.grad`` (a local sum), then one reduction and one optimizer step; the K
gradients are summed (Horovod's default) or averaged
(``average_aggregated_gradients=True``).

`adam`, `adadelta` and `adamw` are optax's factories with optax's defaults
stated: torch's `Adam`/`Adadelta`/`AdamW` apply the same updates (eps
outside the square root for the Adams; Adadelta's rho and eps inside both
roots).
"""

from __future__ import annotations

import functools
import os

import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.mesh import scale_lr  # noqa: F401 (re-export)

_WIRES = {
    "none": None,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}
_QUANTIZED_WIRES = ("int8", "fp8")


class Compression:
    """Horovod's ``hvd.Compression`` enum: the string knobs
    `DistributedOptimizer` accepts (``int8``/``fp8`` are not ported)."""

    none = "none"
    fp16 = "fp16"
    bf16 = "bf16"
    int8 = "int8"
    fp8 = "fp8"


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam`` as a factory ``params -> Adam``, bound by
    `DistributedOptimizer` at `Trainer.build`."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(b1, b2), eps=eps)


def adadelta(learning_rate: float, rho: float = 0.9, eps: float = 1e-6):
    """``optax.adadelta`` as a factory ``params -> Adadelta``."""
    return functools.partial(torch.optim.Adadelta, lr=learning_rate,
                             rho=rho, eps=eps)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` as a factory ``params -> AdamW`` (torch's own
    weight-decay default is 1e-2, optax's 1e-4)."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


def _not_ported_wire(knob: str, value: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} is not ported yet — ROADMAP queue A item 11 "
        "(quantized wires with error feedback, the two-hop ICI wire)"
    )


class DistributedOptimizer:
    """Wrap ``optimizer`` so updates consume cross-rank-averaged gradients.

    Args:
      optimizer: a `torch.optim.Optimizer`, or a factory ``params ->
        Optimizer`` (such as `adam`) bound at `bind`.
      average: mean (True, Horovod's default) or sum over the ranks.
      backward_passes_per_step: K microbatch backwards per optimizer step
        (the `Trainer` runs them); one reduction per K.
      average_aggregated_gradients: average the K accumulated gradients
        instead of summing them (Horovod's default is the sum).
      compression: ``"none"`` | ``"bf16"`` | ``"fp16"`` — the all-reduce's
        wire dtype for f32 gradients. ``"int8"``/``"fp8"`` raise.
      compression_ici: the JAX package's second-hop wire; only ``"none"``.

    The fusion-bucket size is ``HVT_BUCKET_BYTES`` (default 64 MB), or the
    `Trainer`'s ``bucket_bytes=``, which sets ``self.bucket_bytes``.
    """

    def __init__(self, optimizer, average: bool = True,
                 backward_passes_per_step: int = 1,
                 average_aggregated_gradients: bool = False,
                 compression: str = "none", compression_ici: str = "none"):
        for knob, value in (("compression", compression),
                            ("compression_ici", compression_ici)):
            if value in _QUANTIZED_WIRES:
                raise _not_ported_wire(knob, value)
            if value not in _WIRES:
                raise ValueError(
                    f"unknown {knob} {value!r}; expected one of "
                    f"{sorted(_WIRES) + list(_QUANTIZED_WIRES)}"
                )
        if compression_ici != "none":
            raise _not_ported_wire("compression_ici", compression_ici)
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.average = average
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.average_aggregated_gradients = bool(average_aggregated_gradients)
        self.wire_dtype = _WIRES[compression]
        self.bucket_bytes = int(
            os.environ.get("HVT_BUCKET_BYTES")
            or collectives.DEFAULT_BUCKET_BYTES
        )
        self._factory = None
        self.optimizer = None
        if isinstance(optimizer, torch.optim.Optimizer):
            self._set(optimizer)
        elif callable(optimizer):
            self._factory = optimizer
        else:
            raise TypeError(
                "optimizer must be a torch.optim.Optimizer or a factory "
                f"params -> Optimizer, got {type(optimizer).__name__}"
            )

    def _set(self, optimizer) -> None:
        self.optimizer = optimizer
        self._base_lrs = [g["lr"] for g in optimizer.param_groups]

    def bind(self, params) -> torch.optim.Optimizer:
        """The wrapped optimizer, built over ``params`` if it was given as
        a factory (an optimizer built already keeps its own)."""
        if self.optimizer is None:
            self._set(self._factory(list(params)))
        return self.optimizer

    def _params(self):
        for group in self.optimizer.param_groups:
            yield from group["params"]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Replace every ``.grad`` by its sum over the ranks (through the
        wire dtype), divided by the world size when averaging and by K when
        averaging the accumulated passes."""
        live = runtime.is_distributed()
        divisor = (runtime.size() if self.average else 1) * (
            self.backward_passes_per_step
            if self.average_aggregated_gradients else 1)
        if not live and self.wire_dtype is None and divisor == 1:
            return  # a world of 1 with nothing to round or divide
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        buckets, spec = collectives.flatten_buckets(grads, self.bucket_bytes)
        for b in buckets:
            # Each bucket is private to this call (or a view of the one
            # gradient it holds), so every op below runs in place.
            wire = self.wire_dtype is not None and b.dtype == torch.float32
            w = b.to(self.wire_dtype) if wire else b
            if live:
                collectives.allreduce_(w, average=False)
            if wire:
                b.copy_(w)
            if divisor != 1:
                b.div_(divisor)
        torch._foreach_copy_(grads,
                             collectives.unflatten_buckets(buckets, spec))

    def step(self, scale: float = 1.0) -> None:
        """Reduce, then one optimizer step with every group's learning rate
        multiplied by ``scale`` — JAX's ``update_scale``, which multiplies
        the whole update (for AdamW the decay term too)."""
        if self.optimizer is None:
            raise RuntimeError("bind() the optimizer to parameters first")
        self.reduce_gradients()
        for group, base in zip(self.optimizer.param_groups, self._base_lrs):
            group["lr"] = base * scale
        try:
            self.optimizer.step()
        finally:
            for group, base in zip(self.optimizer.param_groups,
                                   self._base_lrs):
                group["lr"] = base
