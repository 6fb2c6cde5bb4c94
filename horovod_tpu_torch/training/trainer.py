"""Trainer — the core of `horovod_tpu.training.trainer`: build, fit,
evaluate and predict on one device.

The JAX trainer jit-compiles its step over a device mesh. Here a step is
eager PyTorch on one card (or the CPU when asked): forward in train mode
with the step's dropout seed, loss (the module's own under
``loss="module"``, else ``loss_fn(logits, y)``), backward (the flash
attention kernels' backward on the card), then the optimizer step scaled
by ``update_scale``.

Module contract: ``module(x, train=bool, dropout_seed=int)`` returns
logits; with ``loss="module"`` it also takes ``labels=y`` and returns
``(per_token_loss, per_token_correct)``, as the port's `TransformerLM`
does.

Not ported yet, each raising `NotImplementedError` naming its ROADMAP
item: callbacks (queue A item 5; checkpointing rides them, item 6),
gradient accumulation (item 4), meshes and sharded layouts (items 1-2, 11,
12) and multi-step executions (item 5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from horovod_tpu_torch.runtime import derive_seed, resolve_device
from horovod_tpu_torch.training.optimizer import DistributedOptimizer
from horovod_tpu_torch.training.train_state import (
    TrainState, _correct, _resolve_loss,
)

# Trainer options of the JAX package not carried here, with the ROADMAP
# item that ports each.
_NOT_PORTED = {
    "mesh": "queue A items 1-2 (runtime + collectives)",
    "param_specs": "queue A item 12 (sharded layouts)",
    "batch_specs": "queue A item 12 (sharded layouts)",
    "steps_per_execution": "queue A item 5 (trainer)",
    "shard_update": "queue A item 11 (ZeRO-1 reduction)",
    "bucket_bytes": "queue A item 11 (bucketed reduction)",
    "overlap_reduction": "queue A item 11 (bucketed reduction)",
    "bucket_order": "queue A item 11 (bucketed reduction)",
}
_DEFAULTS = {"steps_per_execution": 1}


class Trainer:
    """build + fit + evaluate + predict for a torch module on one device.

    Args:
      module: a `torch.nn.Module` following the contract in the module
        docstring. `build` moves it to ``device``.
      optimizer: a `DistributedOptimizer`, or what one wraps (an optimizer
        or a factory such as `training.optimizer.adamw`).
      loss: Keras-style name, ``"module"``, or ``fn(logits, labels) ->
        per-example loss``.
      seed: the root of the per-step dropout seeds.
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA is never replaced by
        the CPU silently.
    """

    def __init__(self, module, optimizer,
                 loss="sparse_categorical_crossentropy", seed: int = 0,
                 device="cuda", **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value is not None and value is not False \
                    and value != _DEFAULTS.get(name):
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet — ROADMAP "
                    f"{_NOT_PORTED[name]}"
                )
        self.device = resolve_device(device)
        self.module = module
        self.tx = (optimizer if isinstance(optimizer, DistributedOptimizer)
                   else DistributedOptimizer(optimizer))
        self.loss_fn = _resolve_loss(loss)
        self._module_loss = loss == "module"
        self.seed = int(seed)
        self.state: TrainState | None = None
        # Multiplies the optimizer's update (the knob JAX's LR callbacks
        # turn); reset to 1.0 at every epoch begin.
        self.update_scale = 1.0
        self.stop_training = False
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------------

    def build(self, sample_x=None, sample_y=None) -> TrainState:
        """Place the module on the device and bind the optimizer to its
        parameters. The module's parameters exist already (torch builds
        them at construction, from its own seed), so the samples are not
        needed; they are accepted for the JAX call shape."""
        del sample_x, sample_y
        if self.state is None:
            self.module.to(self.device)
            self.tx.bind(self.module.parameters())
            self.state = TrainState(step=0, model=self.module,
                                    optimizer=self.tx, rng=self.seed)
        return self.state

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _loss_and_correct(self, x, y, *, train: bool, seed=None):
        """(per-example/per-token loss, per-example/per-token correct)."""
        if self._module_loss:
            return self.module(x, train=train, labels=y, dropout_seed=seed)
        logits = self.module(x, train=train, dropout_seed=seed)
        return self.loss_fn(logits, y), _correct(logits, y)

    def train_step(self, x, y) -> dict:
        """One optimizer step on the batch ``(x, y)`` (numpy or tensors):
        ``{"loss", "accuracy"}`` as 0-d tensors on the device (no host
        sync). Gradients stay in ``.grad`` until the next step."""
        state = self.build(x, y)
        x, y = self._tensor(x), self._tensor(y)
        self.tx.zero_grad()
        loss_vec, correct = self._loss_and_correct(
            x, y, train=True, seed=state.step_seed())
        loss = loss_vec.mean()
        loss.backward()
        self.tx.step(self.update_scale)
        state.step += 1
        return {"loss": loss.detach(), "accuracy": correct.mean().detach()}

    # -- verbs ---------------------------------------------------------------

    def _array_batches(self, x, y, batch_size: int, steps_per_epoch: int,
                       epochs: int):
        """Full batches of a seeded per-epoch permutation (one
        ``RandomState(derive_seed(seed, epoch))`` shuffle per epoch). The
        JAX `ArrayDataset` order, batch for batch, is ROADMAP queue A item
        6."""
        n = len(x)
        if steps_per_epoch * batch_size > n:
            raise ValueError(
                f"{steps_per_epoch} steps of {batch_size} need "
                f"{steps_per_epoch * batch_size} examples, have {n}"
            )
        for epoch in range(epochs):
            rng = np.random.RandomState(
                derive_seed(self.seed, epoch) % (2**32))
            perm = rng.permutation(n)
            for i in range(steps_per_epoch):
                idx = perm[i * batch_size:(i + 1) * batch_size]
                yield x[idx], y[idx]

    def fit(self, dataset=None, *, x=None, y=None, batch_size: int = 128,
            epochs: int = 1, steps_per_epoch: int | None = None,
            callbacks=(), validation_data=None,
            verbose: int = 0) -> list[dict]:
        """Train for ``epochs`` × ``steps_per_epoch`` steps on ``dataset``
        (an iterable of ``(x, y)`` numpy batches; ``steps_per_epoch``
        required) or on arrays ``x``/``y`` in batches of ``batch_size``
        (``steps_per_epoch`` defaults to the full batches per epoch).

        Returns the history: per epoch the mean ``loss`` and ``accuracy``
        of its steps, ``epoch_time_s`` (host clock, ending with the
        metrics' fetch from the device) and, with ``validation_data``,
        ``val_loss``/``val_accuracy``."""
        if callbacks:
            raise NotImplementedError(
                "Trainer.fit(callbacks=...) is not ported yet — ROADMAP "
                "queue A item 5 (callbacks; checkpointing, item 6)"
            )
        if dataset is None:
            if x is None or y is None:
                raise ValueError("pass either dataset= or x=/y=")
            if steps_per_epoch is None:
                steps_per_epoch = max(1, len(x) // batch_size)
            it = self._array_batches(x, y, batch_size, steps_per_epoch,
                                     epochs)
        elif steps_per_epoch is None:
            raise ValueError("steps_per_epoch is required with a dataset")
        else:
            it = iter(dataset)
        self.stop_training = False
        for epoch in range(epochs):
            if self.stop_training:
                break
            self.update_scale = 1.0
            t0 = time.perf_counter()
            loss_sum = acc_sum = 0.0
            for _ in range(steps_per_epoch):
                m = self.train_step(*next(it))
                loss_sum = loss_sum + m["loss"]
                acc_sum = acc_sum + m["accuracy"]
            logs = {"loss": float(loss_sum) / steps_per_epoch,
                    "accuracy": float(acc_sum) / steps_per_epoch}
            logs["epoch_time_s"] = time.perf_counter() - t0
            if validation_data is not None:
                val = self.evaluate(*validation_data, batch_size=batch_size)
                logs.update({f"val_{k}": v for k, v in val.items()})
            self.history.append(logs)
            if verbose:
                shown = {k: round(v, 4) for k, v in logs.items()}
                print(f"Epoch {epoch + 1}/{epochs} - {shown}")
        return self.history

    def evaluate(self, x, y, batch_size: int = 128,
                 verbose: int = 0) -> dict:
        """Mean loss and accuracy over the whole of ``x``/``y`` (per token
        for sequence models), in eval mode."""
        if self.state is None:
            raise RuntimeError("call fit() or build() first")
        loss_sum = correct_sum = 0.0
        count = 0
        with torch.inference_mode():
            for start in range(0, len(x), batch_size):
                xb = self._tensor(x[start:start + batch_size])
                yb = self._tensor(y[start:start + batch_size])
                loss_vec, correct = self._loss_and_correct(xb, yb,
                                                           train=False)
                loss_sum = loss_sum + loss_vec.float().sum()
                correct_sum = correct_sum + correct.float().sum()
                count += loss_vec.numel()
        result = {"loss": float(loss_sum) / count,
                  "accuracy": float(correct_sum) / count}
        if verbose:
            print(f"eval - {({k: round(v, 4) for k, v in result.items()})}")
        return result

    def predict(self, x, batch_size: int = 128) -> np.ndarray:
        """Class probabilities (softmax of the logits) as a numpy array."""
        if self.state is None:
            raise RuntimeError("call fit() or build() first")
        out = []
        with torch.inference_mode():
            for start in range(0, len(x), batch_size):
                logits = self.module(self._tensor(x[start:start + batch_size]),
                                     train=False)
                out.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
        return np.concatenate(out, axis=0)
