"""TrainState and the Trainer's loss/metric/callback helpers — port of
`horovod_tpu.training.train_state`."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.runtime import derive_seed


@dataclasses.dataclass
class TrainState:
    """What one training run carries: the step count, the model (its
    parameters), the optimizer (its state) and ``rng``, the root seed of
    the per-step randomness. JAX's ``fold_in(state.rng, state.step)`` is
    `step_seed`; the model draws its dropout masks from it."""

    step: int
    model: nn.Module
    optimizer: object
    rng: int

    def step_seed(self, step: int | None = None) -> int:
        """The seed of optimizer step ``step`` (default: the next one)."""
        return derive_seed(self.rng, self.step if step is None else step)


def _resolve_loss(loss) -> Callable | None:
    """Keras-style loss names → per-example (or per-token) loss functions
    on f32 logits; ``"module"`` → None: the module computes its own loss,
    ``module(x, labels=y)`` returning ``(per_token_loss,
    per_token_correct)`` (the fused chunked-CE head's contract)."""
    if callable(loss):
        return loss
    if loss == "module":
        return None
    if loss in ("sparse_categorical_crossentropy", "sparse_ce"):
        def sparse_ce(logits, labels):
            lf = logits.float()
            return F.cross_entropy(
                lf.reshape(-1, lf.shape[-1]), labels.reshape(-1).long(),
                reduction="none",
            ).view(labels.shape)
        return sparse_ce
    if loss in ("categorical_crossentropy", "ce"):
        def ce(logits, labels):
            return -(labels.float()
                     * torch.log_softmax(logits.float(), dim=-1)).sum(-1)
        return ce
    raise ValueError(f"unknown loss {loss!r}")


def _correct(logits, labels):
    """Per-example (or per-token) ``argmax == label`` as f32; one-hot
    labels are reduced by argmax first."""
    pred = logits.argmax(dim=-1)
    if labels.dim() == logits.dim():  # one-hot
        labels = labels.argmax(dim=-1)
    return (pred == labels).float()


def _accuracy(logits, labels):
    return _correct(logits, labels).mean()


def _run_train_end(callbacks) -> None:
    """on_train_end on the success path: every hook runs even when an
    earlier one raises (writers must still flush and close); the first
    exception propagates after all ran."""
    first: BaseException | None = None
    for cb in callbacks:
        try:
            cb.on_train_end()
        except BaseException as e:
            if first is None:
                first = e
    if first is not None:
        raise first


def _teardown_callbacks(callbacks) -> None:
    """Best-effort on_train_end while a training error unwinds: teardown
    hooks still run, and their own failures do not mask the original
    error (the caller re-raises it)."""
    for cb in callbacks:
        try:
            cb.on_train_end()
        except BaseException:  # noqa: BLE001 — the training error wins
            pass
