"""Trainer — port of `horovod_tpu.training.trainer`: build, fit, evaluate
and predict, one device per rank, data-parallel over `torch.distributed`.
The feeding paths are `training.feeding`; the captured step is
`training.graphs`.

A step: forward in train mode with the step's dropout seed, loss (the
module's own under ``loss="module"``, else ``loss_fn(logits, y)``),
backward, then the optimizer, which averages the gradients over the ranks
and applies the update scaled by ``update_scale``. With
``backward_passes_per_step=K`` a step runs K microbatch backwards (the
gradients sum in ``.grad``) before the one reduction. Each rank's step
metrics are over its own batch; `MetricAverageCallback` averages the epoch
logs over the ranks.

Module contract: ``module(x, train=bool, dropout_seed=seed)`` returns
logits, ``seed`` an int or a 0-d int64 tensor; with ``loss="module"`` it
also takes ``labels=y`` and returns ``(per_token_loss,
per_token_correct)``, as the port's `TransformerLM` does.

``fit(x=, y=)`` feeds ``ArrayDataset((x, y)).shard(rank, size)`` through
`training_pipeline` (the native engine where it builds, as in JAX) seeded
with ``seed``, epoch-anchored, so its batches are byte-identical to the
JAX trainer's. Options not ported raise `NotImplementedError` naming their
ROADMAP item.

The boundary reduction is the `DistributedOptimizer`'s: its wire
(``compression``, ``compression_ici``, error feedback), the two-hop factor
(`parallel.mesh.dcn_factor`, ``HVT_DCN_FACTOR``), and the Trainer's
``shard_update`` (ZeRO-1, `training.zero1`), ``overlap_reduction`` and
``bucket_order``, as in the JAX Trainer.
"""

from __future__ import annotations


import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data import stream
from horovod_tpu_torch.parallel import mesh
from horovod_tpu_torch.runtime import derive_seed, resolve_device
from horovod_tpu_torch.training import feeding
from horovod_tpu_torch.training.graphs import StepRunner
from horovod_tpu_torch.training.optimizer import DistributedOptimizer
from horovod_tpu_torch.training.train_state import (
    TrainState, _correct, _resolve_loss,
)

# Trainer options of the JAX package not carried here, with the ROADMAP
# item that ports each.
_NOT_PORTED = {
    "mesh": "queue A item 12 (device meshes; the port runs one device per "
            "rank)",
    "param_specs": "queue A item 12 (sharded layouts)",
    "batch_specs": "queue A item 12 (sharded layouts)",
}


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
      steps_per_execution: Keras's K: the streamed fit runs its steps in
        chunks of K and ``on_batch_end`` fires once per chunk, with the
        chunk's last metrics.
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA is never replaced by
        the CPU silently.
      shard_update: ZeRO-1 (`training.zero1`): the optimizer's state and
        update cut over the ranks, the reduction scattered into that layout
        (a quantized dcn wire reduces dense and cuts locally), the updated
        shards all-gathered back into the replicated parameters. A no-op
        in a world of one.
      overlap_reduction: issue each bucket's reduction from the last
        microbatch's backward as soon as its gradients are final (default
        ``HVT_OVERLAP_REDUCTION``, else on); the arithmetic is the
        serialized form's. Where the collectives sit between captured
        graphs (gloo) it changes nothing.
      bucket_order: ``"reverse"`` (default ``HVT_BUCKET_ORDER``, else
        reverse: the leaves last-first, the order the backward finishes
        them) or ``"forward"``.
    """

    def __init__(self, module, optimizer,
                 loss="sparse_categorical_crossentropy", seed: int = 0,
                 device="cuda", bucket_bytes: int | None = None,
                 steps_per_execution: int = 1, shard_update: bool = False,
                 overlap_reduction: bool | None = None,
                 bucket_order: str | None = None, **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value is not None and value is not False:
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
        if bucket_order is not None:  # else the optimizer's HVT_BUCKET_ORDER
            if bucket_order not in ("reverse", "forward"):
                raise ValueError("bucket_order must be 'reverse' or "
                                 f"'forward', got {bucket_order!r}")
            self.tx.bucket_reverse = bucket_order == "reverse"
        if overlap_reduction is None:
            overlap_reduction = registry.get_flag("HVT_OVERLAP_REDUCTION")
        self.tx.overlap = bool(overlap_reduction)
        self.shard_update = bool(shard_update)
        # The two-hop factor: HVT_DCN_FACTOR (checked here: it must divide
        # the world size), else the hosts, asked at the first step.
        if registry.get_raw(mesh.ENV_DCN_FACTOR):
            self.tx.dcn = mesh.dcn_factor()
        self._accum_steps = self.tx.backward_passes_per_step
        self.loss_fn = _resolve_loss(loss)
        self._module_loss = loss == "module"
        self.seed = int(seed)
        self.steps_per_execution = max(1, int(steps_per_execution))
        self.state: TrainState | None = None
        # Multiplies the optimizer's update (the knob the LR callbacks
        # turn); reset to 1.0 at every epoch begin.
        self.update_scale = 1.0
        self.stop_training = False
        self.history: list[dict] = []
        # Where the current fit resumed, for resume-aware callbacks.
        self._resume_epoch = 0
        self._resume_step = 0
        # The current fit's feed (path, engine, geometry), as JAX records
        # it for its stream cursors.
        self._stream_geometry: dict | None = None
        # Staged eval sets of evaluate(cache="device"), by the host
        # arrays' identity.
        self._eval_cache: dict = {}
        # The last fit's step runner (its capture and replay counts), and
        # the one `train_step` steps eagerly.
        self._runner = None
        self._step_runner = None

    # -- state ---------------------------------------------------------------

    def build(self, sample_x=None, sample_y=None) -> TrainState:
        """Place the module on the device and bind the optimizer to its
        parameters. The module's parameters exist already (torch builds
        them at construction, from its own seed), so the samples are not
        needed; they are accepted for the JAX call shape."""
        del sample_x, sample_y
        if self.state is None:
            self.module.to(self.device)
            self.tx.bind(self.module.parameters(),
                         shard_update=self.shard_update)
            self.state = TrainState(step=0, model=self.module,
                                    optimizer=self.tx, rng=self.seed)
        return self.state

    def stream_cursor(self, epoch: int, step: int) -> dict | None:
        """The stream cursor of training position "``step`` optimizer steps
        into epoch ``epoch``" of the current fit, in the JAX package's
        record form (`data.stream.CURSOR_FORMAT`); None before a fit set a
        feed. Checkpoint callbacks stamp it into the progress manifest,
        where the supervisor reads ``steps_per_epoch``."""
        if self._stream_geometry is None:
            return None
        return {"format": stream.CURSOR_FORMAT, "kind": "fit",
                "seed": int(self.seed), "epoch": int(epoch),
                "step": int(step), "position": dict(self._stream_geometry)}

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

    def _dropout_seed(self, micro: int, step: int | None = None) -> int:
        """The seed of optimizer step ``step`` (default: the next one) —
        JAX's ``fold_in(rng, step)`` — made distinct per rank and, when
        accumulating, per microbatch."""
        seed = self.state.step_seed(step)
        if runtime.size() > 1:
            seed = derive_seed(seed, runtime.rank())
        if self._accum_steps > 1:
            seed = derive_seed(seed, micro)
        return seed

    def train_step(self, x, y) -> dict:
        """One optimizer step on the batch ``(x, y)`` (numpy or tensors),
        eagerly, at ``update_scale`` — with ``backward_passes_per_step=K``,
        on K microbatches of one shape: ``x``/``y`` are then length-K
        sequences (or arrays with a leading K axis). The step is the fit's
        (`graphs.StepRunner`), run without a graph. Returns ``{"loss",
        "accuracy"}`` (the mean over the microbatches) as 0-d tensors on
        the device, with no host sync. Gradients stay in ``.grad`` until
        the next step."""
        self.build(x, y)
        micro = [(x, y)] if self._accum_steps == 1 else list(zip(x, y))
        if len(micro) != self._accum_steps:
            raise ValueError(f"got {len(micro)} microbatches, want "
                             f"backward_passes_per_step={self._accum_steps}")
        xs = [self._tensor(xb) for xb, _ in micro]
        ys = [self._tensor(yb) for _, yb in micro]
        if any(a.shape != xs[0].shape for a in xs) or any(
                b.shape != ys[0].shape for b in ys):
            raise ValueError("the microbatches of a step must share a shape")
        if self._step_runner is None:
            self._step_runner = StepRunner(self, batch_size=len(xs[0]),
                                           max_steps=1, eager=True)
        runner = self._step_runner
        runner.feed(torch.cat(xs), torch.cat(ys), len(xs[0]))
        self.tx.set_scale(self.update_scale)
        runner.run(1)
        if not self.tx.lr_is_tensor:
            self.tx.set_scale(1.0)
        return runner.last

    # -- verbs ---------------------------------------------------------------

    def fit(self, dataset=None, *, x=None, y=None, batch_size: int = 128,
            epochs: int = 1, initial_epoch: int = 0, initial_step: int = 0,
            steps_per_epoch: int | None = None, callbacks=(),
            validation_data=None, shuffle_buffer: int | None = None,
            verbose: int | None = None, cache: str | None = None,
            _eager: bool = False) -> list[dict]:
        """Train epochs ``initial_epoch .. epochs-1`` of ``steps_per_epoch``
        optimizer steps on ``dataset`` (an `ArrayDataset` — its anchored
        ``batches`` stream — or any iterable of ``(x, y)`` numpy batches;
        ``steps_per_epoch`` required) or on arrays ``x``/``y``, this rank's
        shard in batches of ``batch_size`` (``steps_per_epoch`` defaults to
        the full batches of the shard).

        ``cache="device"`` (with ``x``/``y``) stages the data on the card
        once, rank r holding rows ``[r·n/size, (r+1)·n/size)``, and draws
        each epoch's order there from ``(seed, epoch)`` as the JAX trainer
        does; ``on_batch_end`` then fires once an epoch, or every
        ``HVT_EPOCH_CHUNK_STEPS`` steps, and validation runs cached too.
        On the card every step is a replay of one captured CUDA graph
        (`training.graphs`), captured again when a ``dataset=`` batch
        changes shape.

        ``initial_step`` resumes mid-epoch at optimizer step S of
        ``initial_epoch``: the stream is fast-forwarded past S × K batches
        without assembling them (an iterable without that hook draws and
        discards). Callbacks run in list order: ``on_train_begin`` after
        build, then per epoch ``on_epoch_begin``, ``on_batch_end(step,
        metrics)`` once per execution (a step, or a ``steps_per_execution``
        chunk, with its last step's metrics and true step index),
        ``on_epoch_end(epoch, logs)`` (logs mutable), and ``on_train_end``.

        Returns the history: per epoch the mean ``loss`` and ``accuracy``
        of its steps, ``epoch_time_s`` (host clock, ending with the
        metrics' fetch from the device) and, with ``validation_data``,
        ``val_loss``/``val_accuracy``. ``verbose`` defaults to 1 on the
        primary rank, 0 elsewhere."""
        return feeding.run_fit(
            self, dataset, x=x, y=y, batch_size=batch_size, epochs=epochs,
            initial_epoch=initial_epoch, initial_step=initial_step,
            steps_per_epoch=steps_per_epoch, callbacks=callbacks,
            validation_data=validation_data, shuffle_buffer=shuffle_buffer,
            verbose=verbose, cache=cache, eager=_eager)

    def evaluate(self, x, y, batch_size: int = 128, verbose: int = 0,
                 cache: str | None = None) -> dict:
        """Mean loss and accuracy over the whole of ``x``/``y`` (per token
        for sequence models), in eval mode. The rows are sharded over the
        ranks and the sums reduced, so every rank gets the global mean at
        1/size of the work: rank r takes rows r, r + size, ..., or with
        ``cache="device"`` the contiguous shard r of the padded set staged
        on the card (`feeding.evaluate_device_cached`)."""
        return feeding.run_evaluate(self, x, y, batch_size=batch_size,
                                    verbose=verbose, cache=cache)

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
