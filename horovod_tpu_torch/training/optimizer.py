"""DistributedOptimizer — gradient-averaging wrap of a torch optimizer;
port of `horovod_tpu.training.optimizer` (the one-process part).

The JAX version wraps an optax transformation and leaves the cross-worker
average to XLA's SPMD reduction. Here one process drives one card, so the
average is over a world of 1: gradients go through the requested 16-bit
wire dtype and back (what a 1-rank reduction on that wire would return)
and are otherwise untouched. Multi-rank reduction over `torch.distributed`
is ROADMAP queue A items 1-2; until then a live group of more than one rank
raises rather than training each rank on its own.

`adamw` is the port of ``optax.adamw``: `torch.optim.AdamW` with optax's
defaults stated (torch's own weight-decay default is 1e-2, optax's 1e-4).
The two apply the same update, p ← p − lr·(m̂ / (√v̂ + eps) + wd·p), with
eps outside the square root and decay on every parameter.
"""

from __future__ import annotations

import functools

import torch

_WIRES = {
    "none": None,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}
_QUANTIZED_WIRES = ("int8", "fp8")


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _refuse_multi_rank() -> None:
    if _world_size() > 1:
        raise NotImplementedError(
            f"a torch.distributed group of {_world_size()} ranks is live: "
            "multi-rank gradient averaging is not ported yet — ROADMAP "
            "queue A items 1-2 (runtime + collectives)"
        )


def scale_lr(base_lr: float, world_size: int | None = None) -> float:
    """Linear LR scaling, ``base × world_size``; ``world_size`` defaults
    to the live `torch.distributed` world (1 without one)."""
    if world_size is None:
        world_size = _world_size()
    return base_lr * world_size


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw``'s defaults as a factory ``params -> AdamW``, for
    `DistributedOptimizer` to bind at `Trainer.build` (the model's
    parameters do not exist when the optimizer is written down)."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


class DistributedOptimizer:
    """Wrap ``optimizer`` so updates consume averaged gradients.

    Args:
      optimizer: a `torch.optim.Optimizer`, or a factory ``params ->
        Optimizer`` (such as `adamw`) bound at `bind`.
      average: mean (True, Horovod's default) or sum of the workers'
        gradients — the same over a world of 1.
      compression: ``"none"`` | ``"bf16"`` | ``"fp16"`` — the wire dtype of
        the reduction; each f32 gradient is rounded through it.
        ``"int8"``/``"fp8"`` (quantized wires with error feedback) are
        ROADMAP queue A item 11 and raise.
      backward_passes_per_step: gradient accumulation, ROADMAP queue A
        item 4; only 1 is ported.
    """

    def __init__(self, optimizer, average: bool = True,
                 compression: str = "none",
                 backward_passes_per_step: int = 1):
        if compression in _QUANTIZED_WIRES:
            raise NotImplementedError(
                f"compression={compression!r} (quantized wire with error "
                "feedback) is not ported yet — ROADMAP queue A item 11"
            )
        if compression not in _WIRES:
            raise ValueError(
                f"unknown compression {compression!r}; expected one of "
                f"{sorted(_WIRES) + list(_QUANTIZED_WIRES)}"
            )
        if backward_passes_per_step != 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 (gradient accumulation) is not "
                "ported yet — ROADMAP queue A item 4"
            )
        _refuse_multi_rank()
        self.average = average
        self.wire_dtype = _WIRES[compression]
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

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Average the gradients over the world (of 1), through the wire
        dtype."""
        _refuse_multi_rank()
        for p in self._params():
            if (p.grad is not None and self.wire_dtype is not None
                    and p.grad.dtype == torch.float32):
                p.grad.copy_(p.grad.to(self.wire_dtype))

    def step(self, scale: float = 1.0) -> None:
        """Reduce, then one optimizer step with every group's learning rate
        multiplied by ``scale`` — JAX's ``update_scale``, which multiplies
        the whole update (for AdamW that is the decay term too)."""
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
