"""Trainer — port of `horovod_tpu.training.trainer` and its feeding paths
(`horovod_tpu.training.feeding`): build, fit, evaluate and predict, one
device per rank, data-parallel over `torch.distributed`.

A step is eager PyTorch: forward in train mode with the step's dropout
seed, loss (the module's own under ``loss="module"``, else ``loss_fn(
logits, y)``), backward, then `DistributedOptimizer.step`, which averages
the gradients over the ranks and applies the update scaled by
``update_scale``. With ``backward_passes_per_step=K`` a step runs K
microbatch backwards (the gradients sum in ``.grad``) before the one
reduction. Each rank's step metrics are over its own batch;
`MetricAverageCallback` averages the epoch logs over the ranks.

Module contract: ``module(x, train=bool, dropout_seed=int)`` returns
logits; with ``loss="module"`` it also takes ``labels=y`` and returns
``(per_token_loss, per_token_correct)``, as the port's `TransformerLM`
does.

``fit(x=, y=)`` feeds ``ArrayDataset((x, y)).shard(rank, size)`` through
the python `training_pipeline` seeded with ``seed``, epoch-anchored, so its
batches are byte-identical to the JAX trainer's python engine. Options not
ported raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.data.loader import ArrayDataset, training_pipeline
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.runtime import derive_seed, resolve_device
from horovod_tpu_torch.training.optimizer import DistributedOptimizer
from horovod_tpu_torch.training.train_state import (
    TrainState, _correct, _resolve_loss, _run_train_end, _teardown_callbacks,
)

# Trainer options of the JAX package not carried here, with the ROADMAP
# item that ports each.
_NOT_PORTED = {
    "mesh": "queue A item 12 (device meshes; the port runs one device per "
            "rank)",
    "param_specs": "queue A item 12 (sharded layouts)",
    "batch_specs": "queue A item 12 (sharded layouts)",
    "steps_per_execution": "queue A item 5 (multi-step executions)",
    "shard_update": "queue A item 11 (ZeRO-1 reduction)",
    "overlap_reduction": "queue A item 11 (bucketed reduction)",
    "bucket_order": "queue A item 11 (bucketed reduction)",
}
_DEFAULTS = {"steps_per_execution": 1}


def _normalize_resume(initial_epoch: int, initial_step: int,
                      steps_per_epoch: int) -> tuple[int, int]:
    """A resume step at or past the epoch's end rolls into the next epoch,
    so callers may hand back exactly what a checkpoint manifest
    recorded."""
    initial_epoch, initial_step = int(initial_epoch), int(initial_step)
    if initial_step < 0:
        raise ValueError(f"initial_step must be >= 0, got {initial_step}")
    if initial_step and steps_per_epoch:
        initial_epoch += initial_step // steps_per_epoch
        initial_step %= steps_per_epoch
    return initial_epoch, initial_step


class Trainer:
    """build + fit + evaluate + predict for a torch module, one device per
    rank.

    Args:
      module: a `torch.nn.Module` following the contract in the module
        docstring. `build` moves it to ``device``.
      optimizer: a `DistributedOptimizer`, or what one wraps (an optimizer
        or a factory such as `training.optimizer.adam`).
      loss: Keras-style name, ``"module"``, or ``fn(logits, labels) ->
        per-example loss``.
      seed: the root of the per-step dropout seeds and of the ``x=``/``y=``
        shuffle.
      bucket_bytes: the gradient fusion-bucket size; default
        ``HVT_BUCKET_BYTES``, else 64 MB (the JAX Trainer's knob).
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA is never replaced by
        the CPU silently.
    """

    def __init__(self, module, optimizer,
                 loss="sparse_categorical_crossentropy", seed: int = 0,
                 device="cuda", bucket_bytes: int | None = None,
                 **not_ported):
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
        if bucket_bytes:
            self.tx.bucket_bytes = int(bucket_bytes)
        self._accum_steps = self.tx.backward_passes_per_step
        self.loss_fn = _resolve_loss(loss)
        self._module_loss = loss == "module"
        self.seed = int(seed)
        self.state: TrainState | None = None
        # Multiplies the optimizer's update (the knob the LR callbacks
        # turn); reset to 1.0 at every epoch begin.
        self.update_scale = 1.0
        self.stop_training = False
        self.history: list[dict] = []
        # Where the current fit resumed, for resume-aware callbacks.
        self._resume_epoch = 0
        self._resume_step = 0

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
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _loss_and_correct(self, x, y, *, train: bool, seed=None):
        """(per-example/per-token loss, per-example/per-token correct)."""
        if self._module_loss:
            return self.module(x, train=train, labels=y, dropout_seed=seed)
        logits = self.module(x, train=train, dropout_seed=seed)
        return self.loss_fn(logits, y), _correct(logits, y)

    def _dropout_seed(self, micro: int) -> int:
        """The step's seed (JAX's ``fold_in(rng, step)``), made distinct per
        rank and, when accumulating, per microbatch."""
        seed = self.state.step_seed()
        if runtime.size() > 1:
            seed = derive_seed(seed, runtime.rank())
        if self._accum_steps > 1:
            seed = derive_seed(seed, micro)
        return seed

    def train_step(self, x, y) -> dict:
        """One optimizer step on the batch ``(x, y)`` (numpy or tensors) —
        with ``backward_passes_per_step=K``, on K microbatches: ``x``/``y``
        are then length-K sequences (or arrays with a leading K axis).
        Returns ``{"loss", "accuracy"}`` (the mean over the microbatches)
        as 0-d tensors on the device, with no host sync. Gradients stay in
        ``.grad`` until the next step."""
        state = self.build(x, y)
        micro = [(x, y)] if self._accum_steps == 1 else list(zip(x, y))
        if len(micro) != self._accum_steps:
            raise ValueError(f"got {len(micro)} microbatches, want "
                             f"backward_passes_per_step={self._accum_steps}")
        self.tx.zero_grad()
        losses, accs = [], []
        for k, (xb, yb) in enumerate(micro):
            loss_vec, correct = self._loss_and_correct(
                self._tensor(xb), self._tensor(yb), train=True,
                seed=self._dropout_seed(k))
            loss = loss_vec.mean()
            loss.backward()
            losses.append(loss.detach())
            accs.append(correct.mean().detach())
        self.tx.step(self.update_scale)
        state.step += 1
        if len(micro) == 1:
            return {"loss": losses[0], "accuracy": accs[0]}
        return {"loss": torch.stack(losses).mean(),
                "accuracy": torch.stack(accs).mean()}

    # -- verbs ---------------------------------------------------------------

    def fit(self, dataset=None, *, x=None, y=None, batch_size: int = 128,
            epochs: int = 1, initial_epoch: int = 0, initial_step: int = 0,
            steps_per_epoch: int | None = None, callbacks=(),
            validation_data=None, shuffle_buffer: int | None = None,
            verbose: int | None = None) -> list[dict]:
        """Train epochs ``initial_epoch .. epochs-1`` of ``steps_per_epoch``
        optimizer steps on ``dataset`` (an `ArrayDataset` — its anchored
        ``batches`` stream — or any iterable of ``(x, y)`` numpy batches;
        ``steps_per_epoch`` required) or on arrays ``x``/``y``, this rank's
        shard in batches of ``batch_size`` (``steps_per_epoch`` defaults to
        the full batches of the shard).

        ``initial_step`` resumes mid-epoch at optimizer step S of
        ``initial_epoch``: the stream is fast-forwarded past S × K batches
        without assembling them (an iterable without that hook draws and
        discards). Callbacks run in list order: ``on_train_begin`` after
        build, then per epoch ``on_epoch_begin``, ``on_batch_end(step,
        metrics)`` once per optimizer step, ``on_epoch_end(epoch, logs)``
        (logs mutable), and ``on_train_end``.

        Returns the history: per epoch the mean ``loss`` and ``accuracy``
        of its steps, ``epoch_time_s`` (host clock, ending with the
        metrics' fetch from the device) and, with ``validation_data``,
        ``val_loss``/``val_accuracy``. ``verbose`` defaults to 1 on the
        primary rank, 0 elsewhere."""
        if verbose is None:
            verbose = 1 if runtime.is_primary() else 0
        for cb in callbacks:
            if not callable(getattr(cb, "set_trainer", None)):
                raise TypeError(f"{cb!r} is not a training.callbacks.Callback")
        K = self._accum_steps
        if dataset is None:
            if x is None or y is None:
                raise ValueError("pass either dataset= or x=/y=")
            if isinstance(x, list):
                x = np.asarray(x)
            ds = ArrayDataset((x, y)).shard(runtime.rank(), runtime.size())
            if steps_per_epoch is None:
                steps_per_epoch = max(1, ds.num_examples // (batch_size * K))
            initial_epoch, initial_step = _normalize_resume(
                initial_epoch, initial_step, steps_per_epoch)
            it, close_input = training_pipeline(
                ds.arrays, batch_size, seed=self.seed,
                shuffle_buffer=shuffle_buffer,
                skip_batches=initial_step * K, start_epoch=initial_epoch,
                batches_per_epoch=steps_per_epoch * K,
            )
        elif steps_per_epoch is None:
            raise ValueError("steps_per_epoch is required with a dataset")
        else:
            initial_epoch, initial_step = _normalize_resume(
                initial_epoch, initial_step, steps_per_epoch)
            skip = initial_step * K
            close_input = lambda: None  # noqa: E731
            if isinstance(dataset, ArrayDataset):
                it = dataset.batches(skip=skip, start_epoch=initial_epoch,
                                     batches_per_epoch=steps_per_epoch * K)
            else:
                it = iter(dataset)
                for _ in range(skip):
                    next(it)
        self._resume_epoch, self._resume_step = initial_epoch, initial_step
        first = next(it)
        self.build(first[0], first[1])
        buffered = [first]

        def next_step():
            batches = [buffered.pop() if buffered else next(it)
                       for _ in range(K)]
            if K == 1:
                return batches[0]
            return [b[0] for b in batches], [b[1] for b in batches]

        callbacks = list(callbacks)
        for cb in callbacks:
            cb.set_trainer(self)
        self.stop_training = False
        try:
            for cb in callbacks:
                cb.on_train_begin()
            for epoch in range(initial_epoch, epochs):
                if self.stop_training:
                    break
                self.update_scale = 1.0
                for cb in callbacks:
                    cb.on_epoch_begin(epoch)
                t0 = time.perf_counter()
                start = initial_step if epoch == initial_epoch else 0
                loss_sum = acc_sum = 0.0
                for step in range(start, steps_per_epoch):
                    m = self.train_step(*next_step())
                    loss_sum = loss_sum + m["loss"]
                    acc_sum = acc_sum + m["accuracy"]
                    for cb in callbacks:
                        cb.on_batch_end(step, m)
                steps = steps_per_epoch - start
                logs = {"loss": float(loss_sum) / steps,
                        "accuracy": float(acc_sum) / steps}
                logs["epoch_time_s"] = time.perf_counter() - t0
                if validation_data is not None:
                    val = self.evaluate(*validation_data,
                                        batch_size=batch_size)
                    logs.update({f"val_{k}": v for k, v in val.items()})
                for cb in callbacks:
                    cb.on_epoch_end(epoch, logs)
                self.history.append(logs)
                if verbose:
                    shown = {k: round(v, 4) for k, v in logs.items()}
                    print(f"Epoch {epoch + 1}/{epochs} - {shown}", flush=True)
        except BaseException:
            close_input()
            _teardown_callbacks(callbacks)
            raise
        close_input()
        _run_train_end(callbacks)
        return self.history

    def evaluate(self, x, y, batch_size: int = 128,
                 verbose: int = 0) -> dict:
        """Mean loss and accuracy over the whole of ``x``/``y`` (per token
        for sequence models), in eval mode. The rows are sharded over the
        ranks (rank r takes rows r, r + size, ...) and the sums reduced, so
        every rank gets the global mean at 1/size of the work."""
        if self.state is None:
            raise RuntimeError("call fit() or build() first")
        r, n = runtime.rank(), runtime.size()
        xs, ys = x[r::n], y[r::n]
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        with torch.inference_mode():
            for start in range(0, len(xs), batch_size):
                xb = self._tensor(xs[start:start + batch_size])
                yb = self._tensor(ys[start:start + batch_size])
                loss_vec, correct = self._loss_and_correct(xb, yb,
                                                           train=False)
                sums[0] += loss_vec.double().sum()
                sums[1] += correct.double().sum()
                sums[2] += loss_vec.numel()
        if n > 1:
            sums = collectives.allreduce(sums.clone(), average=False)
        loss_sum, correct_sum, count = sums.tolist()
        result = {"loss": loss_sum / count, "accuracy": correct_sum / count}
        if verbose and runtime.is_primary():
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
