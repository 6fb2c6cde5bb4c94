"""TrainState and the Trainer's loss/metric/callback helpers — port of
`horovod_tpu.training.train_state`, with the sown ``losses``/``metrics``
channel of the JAX Trainer (`sow`)."""

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
    # The mesh the model is placed on and its live placements (parameter
    # name -> {dim: axis}; `models.transformer.param_specs`): a parameter
    # placed on a live axis holds this rank's part only.
    mesh: object = None
    placements: dict = dataclasses.field(default_factory=dict)
    _model_snapshot: dict | None = dataclasses.field(default=None,
                                                     repr=False)

    def step_seed(self, step: int | None = None) -> int:
        """The seed of optimizer step ``step`` (default: the next one)."""
        return derive_seed(self.rng, self.step if step is None else step)

    @property
    def model_is_sharded(self) -> bool:
        """Whether the model holds parts of some parameters only."""
        return bool(self.placements)

    def full_model_state(self) -> dict:
        """The model's state dict with every placed parameter whole — a
        collective over the mesh's groups for a sharded model, unless a
        `snapshot_model` taken since the last step holds it."""
        if self._model_snapshot is not None:
            return self._model_snapshot
        sd = dict(self.model.state_dict())
        if self.model_is_sharded:
            from horovod_tpu_torch.models.convert import gather_state_dict

            sd = gather_state_dict(sd, self.mesh, self.placements)
        return sd

    def snapshot_model(self) -> None:
        """Take `full_model_state` now (on every rank, a collective for a
        sharded model) into host memory, until `model_changed`."""
        self._model_snapshot = None
        self._model_snapshot = {k: v.detach().cpu().clone()
                                for k, v in self.full_model_state().items()}

    def model_changed(self) -> None:
        self._model_snapshot = None

    def load_full_model_state(self, state_dict: dict) -> None:
        """Adopt a whole state dict: each placed parameter takes this
        rank's part of it."""
        if self.model_is_sharded:
            from horovod_tpu_torch.models.convert import shard_state_dict

            state_dict = shard_state_dict(state_dict, self.mesh,
                                          self.placements)
        self.model.load_state_dict(state_dict)
        self.model_changed()


# -- sown losses and metrics ----------------------------------------------------
#
# The JAX package's ``losses``/``metrics`` collections: a layer sows values
# during its forward (``self.sow``), the Trainer adds every sown loss to its
# objective and averages the sown metrics into the step metrics and epoch
# logs. In the port a module that sows holds a ``sown`` dict; `sow` writes
# it, and each forward of the Trainer starts from cleared dicts (JAX's
# fresh collections per apply).


def sow(module, collection: str, name: str, value) -> None:
    """Record ``value`` under ``name`` in ``module``'s ``collection``
    (``"losses"`` or ``"metrics"``) for the current forward; the module
    holds a ``sown`` dict."""
    module.sown.setdefault(collection, {})[name] = value


def _sowing(root):
    return [m for m in root.modules() if isinstance(getattr(m, "sown", None),
                                                    dict)]


def sows(root) -> bool:
    """Whether any layer of ``root`` can sow (holds a ``sown`` dict)."""
    return bool(_sowing(root))


def clear_sown(root) -> None:
    for m in _sowing(root):
        m.sown.clear()


def sown_losses(root) -> list:
    """Every loss sown in the last forward, in module order."""
    return [v for m in _sowing(root)
            for v in m.sown.get("losses", {}).values()]


def sown_metrics(root) -> dict:
    """The metrics sown in the last forward, `_aggregate_sown_metrics`."""
    return _aggregate_sown_metrics([m.sown.get("metrics", {})
                                    for m in _sowing(root)])


def _aggregate_sown_metrics(sown: list) -> dict:
    """``{name: scalar}`` from each layer's ``{name: value}``: values that
    share a name (every MoE layer's ``moe_drop_rate``) are averaged, in
    f32."""
    out: dict = {}
    for layer in sown:
        for name, v in layer.items():
            out.setdefault(name, []).append(
                torch.as_tensor(v).float().reshape(()))
    return {k: torch.stack(v).mean() for k, v in out.items()}


def check_metric_names(names) -> tuple:
    """The sorted metric names discovered at build, refusing JAX's reserved
    ones."""
    names = tuple(sorted(names))
    reserved = {"loss", "accuracy"} & set(names)
    if reserved:
        raise ValueError(
            f"module sows 'metrics' entries named {sorted(reserved)}, "
            "which would silently overwrite the Trainer's own "
            "loss/accuracy in every log and sink — rename the sow"
        )
    return names


def check_train_metric_names(sown: dict, discovered: tuple) -> None:
    """A training forward's metric names must be those discovered at
    build: a sow gated on ``train`` cannot be discovered."""
    if tuple(sorted(sown)) != tuple(discovered):
        raise ValueError(
            f"sown 'metrics' names at train time {sorted(sown)} differ "
            f"from those discovered at build() {list(discovered)} — "
            "'metrics' sows must be unconditional (not gated on train)"
        )


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
