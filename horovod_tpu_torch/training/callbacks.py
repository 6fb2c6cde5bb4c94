"""Callback protocol — port of `horovod_tpu.training.callbacks` (the
``hvd.callbacks.*`` parity surface plus the rank-0 Keras I/O pair).

* `BroadcastGlobalVariablesCallback` — params AND optimizer state from the
  root rank at train begin.
* `MetricAverageCallback` — epoch-end cross-rank mean of the logs; keep it
  ahead of metric-consuming callbacks (callbacks run in list order).
* `LearningRateWarmupCallback` / `LearningRateScheduleCallback` — scale
  the update by s(e) through ``trainer.update_scale``.
* `ModelCheckpoint` / `ScalarLogger` — rank-0-only checkpoints and scalar
  logs (``events.jsonl`` and TensorBoard event files).
* `ExponentialMovingAverage` — the parameters' EMA (`training.ema`).
* `PreemptionCheckpointCallback` — a signal becomes an agreed save-and-stop
  at the next epoch end.
* `HeartbeatCallback` and `env_callbacks` — what the launcher's
  environment asks for (``HVT_HEARTBEAT_DIR``, ``HVT_FAULT``), appended by
  ``fit()`` on every path.

Not ported yet (ROADMAP queue A item 13.3): the metrics-push callback,
asynchronous and sharded checkpoints.
"""

from __future__ import annotations

import json
import os
import signal
import time

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.parallel import collectives


class Callback:
    """Base callback; hooks mirror the Keras/Horovod set the reference
    uses."""

    trainer = None
    #: Whether the callback saves the training state at epoch ends (the
    #: fit then snapshots an optimizer state that is a collective).
    saves_state = False

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch: int, logs=None):
        pass

    def on_epoch_end(self, epoch: int, logs=None):
        pass

    def on_batch_end(self, batch: int, logs=None):
        pass


def agree_any(flag: bool) -> bool:
    """True on ANY rank → True on EVERY rank (a collective: every rank
    enters it at the same point)."""
    if runtime.size() == 1:
        return bool(flag)
    return any(collectives.allgather_object(bool(flag)))


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the whole training state (params, optimizer state, step)
    from ``root_rank`` at train begin: a consistent start from random
    weights or from a checkpoint the root restored."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        if runtime.size() == 1:
            return
        from horovod_tpu_torch import checkpoint

        self.trainer.state = checkpoint.broadcast_parameters(
            self.trainer.state, self.root_rank)


class MetricAverageCallback(Callback):
    """Epoch-end cross-rank mean of the logged metrics. Each rank's step
    metrics are over its own shard of the batch, so this turns them into
    the global batch's."""

    def on_epoch_end(self, epoch: int, logs=None):
        if logs is None or runtime.size() == 1:
            return
        logs.update(collectives.metric_mean(logs))


class LearningRateWarmupCallback(Callback):
    """Ramp the effective LR from ``base`` to ``base × world_size`` over the
    first ``warmup_epochs`` epochs: the optimizer is built with the scaled
    LR and this multiplies the update by s(e) = (1 + e/W·(size − 1)) /
    size, from 1/size at epoch 0 to 1 from epoch W on."""

    def __init__(self, warmup_epochs: int = 3, world_size: int | None = None,
                 verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.world_size = world_size
        self.verbose = verbose

    def on_epoch_begin(self, epoch: int, logs=None):
        size = self.world_size or runtime.size()
        if epoch >= self.warmup_epochs or size == 1:
            scale = 1.0
        else:
            frac = epoch / self.warmup_epochs
            scale = (1.0 + frac * (size - 1)) / size
        self.trainer.update_scale = scale
        if self.verbose and runtime.is_primary() and epoch <= self.warmup_epochs:
            print(f"LearningRateWarmup: epoch {epoch} lr scale {scale:.4f}",
                  flush=True)


class LearningRateScheduleCallback(Callback):
    """Multiply the update by ``multiplier`` (a float, or ``epoch ->
    float``) within ``[start_epoch, end_epoch)``; composes with the warmup
    in callback-list order (the trainer resets the scale to 1 each
    epoch)."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: int | None = None, verbose: int = 0):
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.verbose = verbose

    def on_epoch_begin(self, epoch: int, logs=None):
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        m = self.multiplier(epoch) if callable(self.multiplier) else self.multiplier
        self.trainer.update_scale *= float(m)
        if self.verbose and runtime.is_primary():
            print(f"LearningRateSchedule: epoch {epoch} "
                  f"lr scale {self.trainer.update_scale:.4f}", flush=True)


def save_state(filepath_template: str, epoch: int, state, *,
               step: int = 0, cursor: dict | None = None) -> str | None:
    """One single-file checkpoint of ``state`` by the primary rank (others
    return None). ``step == 0``: the end of 0-based epoch ``epoch`` — file
    ``checkpoint-{epoch+1}``, manifest ``(epoch+1, 0)``. ``step > 0``: a
    mid-epoch save after ``step`` optimizer steps of epoch ``epoch`` — file
    ``checkpoint-{epoch}`` (advanced in place), manifest ``(epoch,
    step)``. ``cursor`` (`Trainer.stream_cursor`) rides in the
    manifest."""
    from horovod_tpu_torch import checkpoint

    if step and getattr(state.optimizer, "state_is_collective", False):
        state.optimizer.snapshot()
    if step and state.model_is_sharded:
        state.snapshot_model()
    if not runtime.is_primary():
        return None
    completed = epoch + 1 if step == 0 else epoch
    path = filepath_template.format(epoch=completed)
    return checkpoint.save(path, state, progress=(completed, step),
                           cursor=cursor)


def _cursor(trainer, epoch: int, step: int):
    fn = getattr(trainer, "stream_cursor", None)
    return fn(epoch, step) if callable(fn) else None


class ModelCheckpoint(Callback):
    """Per-epoch full-state checkpoint, written by the primary rank only.
    ``filepath`` may hold ``{epoch}`` (``'checkpoint-{epoch}.pt'``).

    ``save_every_steps=N`` also saves every N optimizer steps within an
    epoch (default ``HVT_SAVE_EVERY_STEPS``, else 0 = epoch cadence only),
    counted from the fit's resume step, with an ``(epoch, step)`` manifest
    so a restart resumes at that step. Saves are synchronous.

    An optimizer with per-rank state (ZeRO-1 shards, error-feedback
    residuals) gathers it in a collective: where this callback runs on
    some rank, the fit takes that snapshot on every rank at each epoch
    end, so an epoch-cadence callback may run on the primary alone; with
    ``save_every_steps`` the callback must run on every rank (only the
    primary writes)."""

    saves_state = True

    def __init__(self, filepath: str, async_save: bool = False,
                 save_every_steps: int | None = None):
        if async_save:
            raise NotImplementedError(
                "ModelCheckpoint(async_save=True) is not ported yet — "
                "ROADMAP queue A item 13 (asynchronous checkpoints)"
            )
        self.filepath = filepath
        if save_every_steps is None:
            save_every_steps = registry.get_int("HVT_SAVE_EVERY_STEPS")
        self.save_every_steps = max(0, int(save_every_steps))
        self._epoch = 0
        self._last_save_step = 0

    def on_epoch_begin(self, epoch: int, logs=None):
        self._epoch = epoch
        self._last_save_step = 0
        if self.trainer is not None and epoch == getattr(
                self.trainer, "_resume_epoch", 0):
            self._last_save_step = int(getattr(self.trainer, "_resume_step", 0))

    def on_batch_end(self, batch: int, logs=None):
        if not self.save_every_steps:
            return
        done = batch + 1
        if done - self._last_save_step < self.save_every_steps:
            return
        self._last_save_step = done
        save_state(self.filepath, self._epoch, self.trainer.state, step=done,
                   cursor=_cursor(self.trainer, self._epoch, done))

    def on_epoch_end(self, epoch: int, logs=None):
        save_state(self.filepath, epoch, self.trainer.state,
                   cursor=_cursor(self.trainer, epoch + 1, 0))


class PreemptionCheckpointCallback(Callback):
    """Preemption-graceful training: a scheduler's SIGTERM (grace window,
    then SIGKILL) becomes a clean save-and-stop.

    * the signal handler only sets a flag — all real work happens at the
      next epoch end, outside collectives and graph replays;
    * at every epoch end the flag is agreed across ranks (`agree_any`: any
      rank's signal stops every rank at the same epoch, so none is left in
      a collective);
    * on agreement: one final checkpoint (`save_state`, the primary
      writes), ``trainer.stop_training``, and optionally a distinct exit
      status.

    ``exit_code`` (143 = 128 + SIGTERM is the convention the supervisor
    classifies as ``preemption``): when set, ``on_train_end`` raises
    ``SystemExit`` with it after the save; the trainer runs every
    callback's ``on_train_end`` before propagating it. Default None: fit
    returns with ``callback.preempted == True``. The callback must run on
    every rank (its agreement is a collective), and fit must run on the
    main thread (Python delivers signals there)."""

    saves_state = True

    def __init__(self, filepath: str, signals=(signal.SIGTERM,),
                 exit_code: int | None = None, verbose: int = 1):
        self.filepath = filepath
        self.signals = tuple(signals)
        self.exit_code = exit_code
        self.verbose = verbose
        self.preempted = False
        self._hit = False
        self._old: dict = {}

    def on_train_begin(self, logs=None):
        self._hit = False
        self.preempted = False
        for s in self.signals:
            self._old[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._hit = True

    def on_epoch_end(self, epoch: int, logs=None):
        if not agree_any(self._hit):
            return
        save_state(self.filepath, epoch, self.trainer.state,
                   cursor=_cursor(self.trainer, epoch + 1, 0))
        self.trainer.stop_training = True
        self.preempted = True
        if self.verbose and runtime.is_primary():
            print(f"PreemptionCheckpoint: signal received — epoch "
                  f"{epoch + 1} saved, stopping training", flush=True)

    def on_train_end(self, logs=None):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}
        if self.preempted and self.exit_code is not None:
            raise SystemExit(self.exit_code)


class ScalarLogger(Callback):
    """Rank-0 scalar event log: TensorBoard event files
    (`horovod_tpu_torch.tbevents`) and ``events.jsonl`` (one line per
    record) side by side. ``update_freq="batch"`` also logs every
    ``log_every``-th batch; epoch records are always written. With
    ``metrics.init(sync_tensorboard=True)`` epoch scalars are pushed to the
    metrics sink too.

    Batch records hold device tensors until flushed — reading them each
    step would wait for the device every step — and are flushed when
    ``flush_every`` records pile up or ``flush_secs`` have passed."""

    def __init__(self, log_dir: str, update_freq: str = "epoch",
                 log_every: int = 1, flush_every: int = 100,
                 flush_secs: float = 10.0):
        self.log_dir = log_dir
        self.update_freq = update_freq
        self.log_every = max(1, log_every)
        self.flush_every = max(1, flush_every)
        self.flush_secs = flush_secs
        self._last_flush = time.time()
        self._fh = None
        self._tb_writer = None
        self._step = 0
        self._pending: list[tuple[int, float, dict]] = []

    def _writer(self):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "events.jsonl"), "a")
        return self._fh

    def _tb(self):
        if self._tb_writer is None:
            from horovod_tpu_torch.tbevents import TBEventWriter

            self._tb_writer = TBEventWriter(self.log_dir)
        return self._tb_writer

    def _emit(self, tag_prefix: str, logs: dict, step: int, wall_time=None):
        if not runtime.is_primary() or not logs:
            return
        wall = wall_time or time.time()
        record = {"wall_time": wall, "step": step}
        scalars = {}
        for k, v in logs.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
            record[f"{tag_prefix}{k}"] = scalars[k]
        self._writer().write(json.dumps(record) + "\n")
        if scalars:
            self._tb().scalars(
                {f"{tag_prefix}{k}": v for k, v in scalars.items()},
                step, wall_time=wall)
        if tag_prefix == "epoch/" and scalars:
            from horovod_tpu_torch import metrics

            if metrics.sync_tensorboard_enabled():
                for k, v in scalars.items():
                    metrics.push(k, v, step=step)

    def _flush_pending(self):
        for step, wall, logs in self._pending:
            self._emit("batch/", logs, step, wall_time=wall)
        self._pending = []
        if self._fh:
            self._fh.flush()
        if self._tb_writer is not None:
            self._tb_writer.flush()
        self._last_flush = time.time()

    def on_train_begin(self, logs=None):
        # A resumed run's batch records continue the restored step count.
        if self._step == 0 and getattr(self.trainer, "state", None) is not None:
            self._step = int(self.trainer.state.step)

    def on_batch_end(self, batch: int, logs=None):
        self._step += 1
        if (self.update_freq == "batch" and self._step % self.log_every == 0
                and logs and runtime.is_primary()):
            now = time.time()
            self._pending.append((self._step, now, dict(logs)))
            if (len(self._pending) >= self.flush_every
                    or now - self._last_flush >= self.flush_secs):
                self._flush_pending()

    def on_epoch_end(self, epoch: int, logs=None):
        self._flush_pending()
        self._emit("epoch/", logs or {}, epoch + 1)
        if self._fh:
            self._fh.flush()

    def on_train_end(self, logs=None):
        self._flush_pending()
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None


class HeartbeatCallback(Callback):
    """Touch a per-rank liveness file, ``<directory>/rank-<rank>``, so the
    restart supervisor (`launch/supervisor.py`) can tell a hung fleet from
    a slow one. ``fit()`` installs it when the supervisor exports
    ``HVT_HEARTBEAT_DIR`` (`env_callbacks`).

    Beats land at train and epoch boundaries always and at batch ends
    throttled to ``interval`` seconds, synchronously with the training
    loop (no timer thread, which would keep a wedged main thread looking
    alive), as host work between graph replays. The beat-free span is a
    whole epoch on the device-cached path (its batch callbacks fire once
    an epoch, or once a chunk), and post-fit work does not beat: the
    supervisor's ``heartbeat_timeout`` must exceed both."""

    def __init__(self, directory: str, interval: float = 1.0):
        self.directory = directory
        self.interval = interval
        self._last = 0.0

    def _beat(self, force: bool = False):
        now = time.time()
        if not force and now - self._last < self.interval:
            return
        try:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory, f"rank-{runtime.rank()}")
            with open(path, "a"):
                os.utime(path, None)
        except OSError:
            # A torn-down heartbeat dir must never kill training itself.
            return
        self._last = now

    def on_train_begin(self, logs=None):
        self._beat(force=True)

    def on_epoch_begin(self, epoch: int, logs=None):
        self._beat(force=True)

    def on_batch_end(self, batch: int, logs=None):
        self._beat()

    def on_epoch_end(self, epoch: int, logs=None):
        self._beat(force=True)


def env_callbacks() -> list:
    """Callbacks the environment asks for — appended by ``fit()`` to the
    user's list on every path, so launcher-level machinery reaches into
    training without entry-script changes:

    * ``HVT_HEARTBEAT_DIR`` (set by the supervisor) → `HeartbeatCallback`
    * ``HVT_FAULT`` (the deterministic chaos knob) →
      `testing.faults.FaultInjectionCallback`
    """
    out: list = []
    hb_dir = registry.get_str(runtime.ENV_HEARTBEAT_DIR)
    if hb_dir:
        out.append(HeartbeatCallback(hb_dir))
    if registry.get_str("HVT_FAULT"):
        from horovod_tpu_torch.testing.faults import FaultInjectionCallback

        out.append(FaultInjectionCallback.from_env())
    return out


class MetricsPushCallback(Callback):
    """Push the epoch-end logs to the platform metrics sink
    (`horovod_tpu_torch.metrics`, whose JSONL stream the CI gate reads),
    each scalar at step ``epoch + 1``. Place it after
    `MetricAverageCallback` so the values pushed are the ranks' mean."""

    def on_epoch_end(self, epoch: int, logs=None):
        from horovod_tpu_torch import metrics

        for k, v in (logs or {}).items():
            try:
                metrics.push(k, float(v), step=epoch + 1)
            except (TypeError, ValueError):
                continue


# Keras-name alias: the reference registers this under TensorBoard.
TensorBoard = ScalarLogger


# Split into training/ema.py as in the JAX package; importable from here.
from horovod_tpu_torch.training.ema import (  # noqa: E402,F401
    ExponentialMovingAverage,
)
