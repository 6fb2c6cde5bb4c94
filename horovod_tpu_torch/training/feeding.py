"""The Trainer's feeding and evaluation paths — port of
`horovod_tpu.training.feeding`: the streamed fit (prefetched,
``steps_per_execution`` chunks), the device-cached fit and evaluate (the
dataset staged on the card once), and the epoch bookkeeping they share.
Functions take the `Trainer`; its verbs delegate here.

Every path runs its steps through one `training.graphs.StepRunner`: each
step reads its rows from a device buffer at a device counter, so on CUDA
it is a replay of one captured step. ``fit(dataset=)`` takes any iterable,
whose batches may change shape from one to the next (a last partial
batch, packed rows of another length): a run of steps of one shape is fed
to the runner at a time, and a new shape is captured anew.

On a live ``seq`` axis every rank of a data shard reads the same rows and
keeps its columns of each part its layout shards on ``seq``
(`Trainer.cut`): the streamed fit and `run_evaluate` cut each batch. The
device-cached paths stage dim 0 only, so there (with ``batch_specs``, which
a live ``seq`` axis needs) the fit refuses and the evaluation takes the
streamed path, as in JAX. Evaluation's sums are over the joined per-token
losses, counted in tokens.

The input ``x`` may be a dict or tuple of arrays (a model of several
inputs, such as the seq2seq family's ``{"src", "tgt"}``): the streamed fit
stacks, prefetches and feeds each leaf, evaluate and predict slice and pad
leaf by leaf, and the device-cached paths, which stage one array, refuse
it with JAX's error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from horovod_tpu_torch import random as random_lib
from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data.loader import ArrayDataset, training_pipeline
from horovod_tpu_torch.data.prefetch import DevicePrefetcher
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel.collectives import (
    first_leaf, tree_flatten, tree_map,
)
from horovod_tpu_torch.training.callbacks import agree_any
from horovod_tpu_torch.training.graphs import StepRunner, _host
from horovod_tpu_torch.training.train_state import (
    _run_train_end, _teardown_callbacks,
)

#: Staged eval sets kept per trainer (device memory bound).
EVAL_CACHE_ENTRIES = 4


def normalize_resume(initial_epoch: int, initial_step: int,
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


# -- staging ------------------------------------------------------------------


def stage_sharded(trainer, arr, per_shard: int) -> torch.Tensor:
    """This rank's batch shard r of a host array on the card: rows
    ``[r·per_shard, (r+1)·per_shard)`` (the JAX layout's shard r)."""
    r = trainer.data_index
    part = np.ascontiguousarray(np.asarray(arr)[r * per_shard:
                                                (r + 1) * per_shard])
    return torch.from_numpy(part).to(trainer.device)


def stage_device_dataset(trainer, x, y):
    """Stage ``(x, y)`` on the card, truncated to a multiple of the batch
    shards; the ranks of shard r hold it. Returns ``((x_r, y_r),
    per_shard)``."""
    n_shards = trainer.dp
    n = (len(x) // n_shards) * n_shards
    if n == 0:
        raise ValueError(f"need at least {n_shards} examples")
    per_shard = n // n_shards
    return (stage_sharded(trainer, x, per_shard),
            stage_sharded(trainer, y, per_shard)), per_shard


# -- epochs -------------------------------------------------------------------


def finish_epoch(trainer, epoch, epochs, means, t0, callbacks,
                 validation_data, batch_size, verbose, val_cache=None):
    """Epoch bookkeeping shared by every fit path: the logs (``means``
    fetched once), validation, callbacks, history."""
    logs = dict(means)
    logs["epoch_time_s"] = time.perf_counter() - t0
    state = trainer.state
    if (trainer.tx.state_is_collective or state.model_is_sharded) \
            and agree_any(any(cb.saves_state for cb in callbacks)):
        # A checkpoint callback runs on some rank (often the primary
        # alone): every rank gathers the optimizer state (and a sharded
        # model's parts) here, so that callback reads them without a
        # collective.
        trainer.tx.snapshot()
        if state.model_is_sharded:
            state.snapshot_model()
    if validation_data is not None:
        val = run_evaluate(trainer, validation_data[0], validation_data[1],
                           batch_size=batch_size, cache=val_cache)
        logs.update({f"val_{k}": v for k, v in val.items()})
    for cb in callbacks:
        cb.on_epoch_end(epoch, logs)
    trainer.history.append(logs)
    if verbose:
        shown = {k: round(v, 4) for k, v in logs.items()}
        print(f"Epoch {epoch + 1}/{epochs} - {shown}", flush=True)


def _begin_epoch(trainer, epoch, callbacks) -> None:
    """Fresh scale each epoch: LR callbacks compose into it in list order
    (warmup assigns, schedules multiply); fixed for the epoch."""
    trainer.update_scale = 1.0
    for cb in callbacks:
        cb.on_epoch_begin(epoch)
    trainer.tx.set_scale(trainer.update_scale)


def _check_callbacks(callbacks) -> list:
    for cb in callbacks:
        if not callable(getattr(cb, "set_trainer", None)):
            raise TypeError(f"{cb!r} is not a training.callbacks.Callback")
    return list(callbacks)


def _with_env_callbacks(callbacks) -> list:
    """User callbacks + env-requested ones (heartbeat, fault injection —
    `callbacks.env_callbacks`), appended last so they see the epoch state
    the user's callbacks produced; applied on every fit path, so
    supervised launches need no entry-script changes. A beat or a fault
    is host work between graph replays: nothing of it is captured."""
    from horovod_tpu_torch.training import callbacks as callbacks_lib

    return _check_callbacks(list(callbacks) + callbacks_lib.env_callbacks())


def run_fit(trainer, dataset=None, *, x=None, y=None, batch_size: int = 128,
            epochs: int = 1, initial_epoch: int = 0, initial_step: int = 0,
            steps_per_epoch: int | None = None, callbacks=(),
            validation_data=None, shuffle_buffer: int | None = None,
            verbose: int | None = None, cache: str | None = None,
            eager: bool = False) -> list[dict]:
    """`Trainer.fit` (see there)."""
    if verbose is None:
        verbose = 1 if runtime.is_primary() else 0
    callbacks = _with_env_callbacks(callbacks)
    if isinstance(x, list):
        x = np.asarray(x)
    if cache == "device":
        if x is None or y is None:
            raise ValueError("cache='device' needs x=/y= arrays")
        if isinstance(x, (dict, tuple)):
            raise ValueError(
                "cache='device' stages a single input array; pytree "
                "(dict/tuple) inputs use the streamed fit path")
        if trainer.batch_specs is not None and trainer.mesh is not None \
                and mesh_lib.has_live_model_axes(trainer.mesh):
            raise ValueError(
                "cache='device' supports data-sharded batches only; "
                "use the streamed fit path with batch_specs meshes")
        return fit_device_cached(
            trainer, x, y, batch_size, epochs, initial_epoch,
            steps_per_epoch, callbacks, validation_data, verbose,
            initial_step, eager)
    if cache is not None:
        raise ValueError(f"unknown cache mode {cache!r}")
    K = trainer._accum_steps
    close_input = lambda: None  # noqa: E731
    if dataset is None:
        if x is None or y is None:
            raise ValueError("pass either dataset= or x=/y=")
        ds = ArrayDataset((x, y)).shard(trainer.data_index, trainer.dp)
        if steps_per_epoch is None:
            steps_per_epoch = max(1, ds.num_examples // (batch_size * K))
        initial_epoch, initial_step = normalize_resume(
            initial_epoch, initial_step, steps_per_epoch)
        engine: dict = {}
        it, close_input = training_pipeline(
            ds.arrays, batch_size, seed=trainer.seed,
            shuffle_buffer=shuffle_buffer, structure=ds.structure,
            skip_batches=initial_step * K,
            start_epoch=initial_epoch,
            batches_per_epoch=steps_per_epoch * K, engine_out=engine)
        trainer._stream_geometry = {
            "path": "streamed", "engine": engine["engine"], "accum": K,
            "steps_per_epoch": steps_per_epoch, "batch_size": batch_size,
            "n_examples": ds.num_examples, "shuffle_buffer": shuffle_buffer,
        }
    elif steps_per_epoch is None:
        raise ValueError("steps_per_epoch is required with a dataset")
    else:
        initial_epoch, initial_step = normalize_resume(
            initial_epoch, initial_step, steps_per_epoch)
        skip = initial_step * K
        trainer._stream_geometry = {
            "path": "streamed", "engine": "dataset", "accum": K,
            "steps_per_epoch": steps_per_epoch,
        }
        if isinstance(dataset, ArrayDataset):
            it = dataset.batches(skip=skip, start_epoch=initial_epoch,
                                 batches_per_epoch=steps_per_epoch * K)
        else:
            it = iter(dataset)
            for _ in range(skip):
                next(it)
    if trainer.seq_shards > 1:
        it = map(trainer.cut_batch, it)
    trainer._resume_epoch, trainer._resume_step = initial_epoch, initial_step
    trainer.build()
    runner = StepRunner(trainer, batch_size=batch_size,
                        max_steps=min(trainer.steps_per_execution,
                                      steps_per_epoch), eager=eager)
    trainer._runner = runner
    for cb in callbacks:
        cb.set_trainer(trainer)
    trainer.stop_training = False
    try:
        for cb in callbacks:
            cb.on_train_begin()
        fit_epochs(trainer, it, runner, epochs, initial_epoch,
                   steps_per_epoch, initial_step, callbacks,
                   validation_data, batch_size, verbose)
    except BaseException:
        close_input()
        _teardown_callbacks(callbacks)
        raise
    close_input()
    _run_train_end(callbacks)
    return trainer.history


def fit_epochs(trainer, it, runner, epochs, initial_epoch, steps_per_epoch,
               initial_step, callbacks, validation_data, batch_size,
               verbose) -> None:
    """The streamed path. Each epoch is a plan of execution units — full
    ``steps_per_execution`` chunks plus one remainder chunk; the resume
    epoch covers only its remaining steps — whose host batches a
    `DevicePrefetcher` stages on the card while earlier ones train.
    ``on_batch_end`` fires once per chunk with its last step's metrics and
    the true within-epoch step index (Keras's ``steps_per_execution``
    semantics). A chunk arrives as runs of steps whose batches share a
    shape, each a ``[n·K, B, ...]`` stack that the runner is fed, then
    ``n`` steps of the runner."""
    K = trainer._accum_steps
    spe = min(trainer.steps_per_execution, steps_per_epoch)

    def plan_for(epoch):
        steps = steps_per_epoch - (initial_step if epoch == initial_epoch
                                   else 0)
        return [spe] * (steps // spe) + ([steps % spe] if steps % spe else [])

    def layout(batch):
        leaves, treedef = tree_flatten(tuple(batch[:2]))
        return (repr(treedef),) + tuple(
            (np.shape(a), np.asarray(a).dtype) for a in leaves)

    def stack(*leaves):
        return np.stack([np.asarray(a) for a in leaves])

    def host_chunks():
        for epoch in range(initial_epoch, epochs):
            for k in plan_for(epoch):
                batches = [next(it) for _ in range(k * K)]
                runs = []  # [(layout, batches)], consecutive steps
                for j in range(k):
                    step = batches[j * K:(j + 1) * K]
                    if any(layout(b) != layout(step[0]) for b in step):
                        raise ValueError("the K microbatches of a step must "
                                         "share a shape")
                    if runs and runs[-1][0] == layout(step[0]):
                        runs[-1][1].extend(step)
                    else:
                        runs.append((layout(step[0]), list(step)))
                yield [tuple(tree_map(stack, *[b[i] for b in run])
                             for i in (0, 1)) for _, run in runs]

    prefetcher = DevicePrefetcher(host_chunks(), trainer.device)
    runner.capture_guard = prefetcher.paused
    try:
        for epoch in range(initial_epoch, epochs):
            if trainer.stop_training:
                break
            _begin_epoch(trainer, epoch, callbacks)
            t0 = time.perf_counter()
            start = initial_step if epoch == initial_epoch else 0
            step = start
            runner.zero_metrics()
            for k in plan_for(epoch):
                for sx, sy in next(prefetcher):
                    n_k, rows = first_leaf(sx).shape[:2]
                    runner.feed(tree_map(lambda a: a.flatten(0, 1), sx),
                                tree_map(lambda a: a.flatten(0, 1), sy),
                                rows)
                    runner.run(n_k // K)
                metrics = runner.last_metrics()
                step += k
                for cb in callbacks:
                    cb.on_batch_end(step - 1, metrics)
            finish_epoch(trainer, epoch, epochs,
                         runner.metric_means(steps_per_epoch - start), t0,
                         callbacks, validation_data, batch_size, verbose)
    finally:
        prefetcher.close()
        runner.close()


def fit_device_cached(trainer, x, y, batch_size, epochs, initial_epoch,
                      steps_per_epoch, callbacks, validation_data, verbose,
                      initial_step=0, eager=False) -> list[dict]:
    """``fit(cache="device")``: the dataset is staged on the card once
    (rank r holds shard r); each epoch draws the JAX trainer's permutation
    (`random.epoch_order`, a pure function of ``(seed, epoch)``), gathers
    the rows it will train on into a shuffled copy once, and its steps read
    contiguous slices of that copy. ``HVT_EPOCH_CHUNK_STEPS=C`` fires
    ``on_batch_end(at - 1, metrics)`` every C steps (else once an epoch);
    validation runs on the cached eval path."""
    K = trainer._accum_steps
    (data_x, data_y), per_shard = stage_device_dataset(trainer, x, y)
    max_steps = per_shard // (batch_size * K)
    if max_steps == 0:
        raise ValueError(
            f"per-shard examples ({per_shard}) < per-rank batch "
            f"({batch_size}) x backward_passes_per_step ({K})")
    steps = min(steps_per_epoch or max_steps, max_steps)
    initial_epoch, initial_step = normalize_resume(initial_epoch,
                                                   initial_step, steps)
    trainer._resume_epoch, trainer._resume_step = initial_epoch, initial_step
    trainer._stream_geometry = {"path": "device", "accum": K,
                                "steps_per_epoch": steps,
                                "batch_size": batch_size}
    trainer.build(np.asarray(x[:batch_size]), np.asarray(y[:batch_size]))
    rows = batch_size * K
    shuffled_x = torch.empty((steps * rows,) + tuple(data_x.shape[1:]),
                             dtype=data_x.dtype, device=trainer.device)
    shuffled_y = torch.empty((steps * rows,) + tuple(data_y.shape[1:]),
                             dtype=data_y.dtype, device=trainer.device)
    runner = StepRunner(trainer, shuffled_x, shuffled_y,
                        batch_size=batch_size, max_steps=steps, eager=eager)
    trainer._runner = runner
    chunk = registry.get_int("HVT_EPOCH_CHUNK_STEPS")
    for cb in callbacks:
        cb.set_trainer(trainer)
    trainer.stop_training = False
    try:
        for cb in callbacks:
            cb.on_train_begin()
        for epoch in range(initial_epoch, epochs):
            if trainer.stop_training:
                break
            _begin_epoch(trainer, epoch, callbacks)
            t0 = time.perf_counter()
            start = initial_step if epoch == initial_epoch else 0
            order = random_lib.epoch_order(
                trainer.seed, epoch, (trainer.dp, per_shard))
            window = _host(order[trainer.data_index,
                                 start * rows:steps * rows],
                           trainer.device.type == "cuda").to(
                trainer.device, non_blocking=True)
            n_rows = len(window)
            torch.index_select(data_x, 0, window, out=shuffled_x[:n_rows])
            torch.index_select(data_y, 0, window, out=shuffled_y[:n_rows])
            runner.reset_counter()
            runner.zero_metrics()
            c = chunk if chunk > 0 else steps - start
            at = start
            while at < steps:
                n = min(c, steps - at)
                runner.run(n)
                at += n
                metrics = runner.last_metrics()
                for cb in callbacks:
                    cb.on_batch_end(at - 1, metrics)
            finish_epoch(trainer, epoch, epochs,
                         runner.metric_means(steps - start), t0, callbacks,
                         validation_data, batch_size, verbose,
                         val_cache="device")
    except BaseException:
        _teardown_callbacks(callbacks)
        raise
    finally:
        runner.close()
    _run_train_end(callbacks)
    return trainer.history


# -- evaluation ---------------------------------------------------------------


def slice_pad(part, start: int, global_batch: int):
    """``(rows [start, start + global_batch) of a batch part, padded to
    global_batch by repeating its last row; the true row count)``, leaf by
    leaf (JAX's `slice_pad`, shared by evaluate and predict)."""
    sliced = tree_map(lambda a: np.asarray(a[start:start + global_batch]),
                      part)
    bs = len(first_leaf(sliced))
    if bs < global_batch:
        pad = global_batch - bs
        sliced = tree_map(
            lambda a: np.concatenate([a, np.repeat(a[-1:], pad, 0)]), sliced)
    return sliced, bs


def _eval_batch_sums(trainer, xb, yb, mask, sums) -> None:
    loss_vec, correct = trainer._loss_and_correct(xb, yb, train=False)
    w = mask.reshape(mask.shape + (1,) * (loss_vec.dim() - 1))
    w = w.expand(loss_vec.shape).double()
    sums[0] += (loss_vec.double() * w).sum()
    sums[1] += (correct.double() * w).sum()
    sums[2] += w.sum()


def _reduce_sums(trainer, sums) -> dict:
    """The global means from this shard's sums: reduced over the batch
    shards (the world on a pure-data mesh)."""
    group = trainer.batch_group
    if group is not None:
        sums = collectives.all_reduce_sum(sums, group)
    elif runtime.size() > 1:
        sums = collectives.allreduce(sums.clone(), average=False)
    loss_sum, correct_sum, count = sums.tolist()
    return {"loss": loss_sum / count, "accuracy": correct_sum / count}


def evaluate_device_cached(trainer, x, y, batch_size: int) -> dict:
    """evaluate() over an eval set staged on the card once — padded to
    ``n_shards × per`` rows (``per`` a multiple of the batch) by repeating
    the last real example, the padding masked out — then one pass of
    batches per call and one fetch of three sums. Cached by the host
    arrays' identity (do not mutate them in place while cached), at most
    `EVAL_CACHE_ENTRIES` sets."""
    key = (id(x), id(y), batch_size)
    cache = trainer._eval_cache
    if key not in cache:
        n, n_shards = len(x), trainer.dp
        per = -(-n // (n_shards * batch_size)) * batch_size
        pad_n = per * n_shards
        mask = np.zeros(pad_n, np.float32)
        mask[:n] = 1.0

        def padded(a):
            # A real example in the padded tail: all-zero rows could give
            # non-finite losses, and NaN × 0 is NaN.
            a = np.asarray(a)
            return np.concatenate([a, np.repeat(a[-1:], pad_n - n, axis=0)])

        data = (stage_sharded(trainer, padded(x), per),
                stage_sharded(trainer, padded(y), per),
                stage_sharded(trainer, mask, per))
        # x and y stay referenced so their ids stay unique while cached.
        cache[key] = (data, per, (x, y))
        if len(cache) > EVAL_CACHE_ENTRIES:
            cache.pop(next(iter(cache)))
    (xs, ys, ms), per, _ = cache[key]
    sums = torch.zeros(3, dtype=torch.float64, device=trainer.device)
    with torch.inference_mode():
        for lo in range(0, per, batch_size):
            _eval_batch_sums(trainer, xs[lo:lo + batch_size],
                             ys[lo:lo + batch_size], ms[lo:lo + batch_size],
                             sums)
    return _reduce_sums(trainer, sums)


def run_evaluate(trainer, x, y, batch_size: int = 128, verbose: int = 0,
                 cache: str | None = None) -> dict:
    """`Trainer.evaluate` (see there)."""
    if trainer.state is None:
        raise RuntimeError("call fit() or build() first")
    if isinstance(x, list):
        x = np.asarray(x)
    if (cache == "device" and trainer.batch_specs is not None
            and trainer.mesh is not None
            and mesh_lib.has_live_model_axes(trainer.mesh)):
        # The cached path stages the default layout; custom layouts over
        # live non-data axes take the streamed path (as in JAX).
        cache = None
    if cache == "device":
        if isinstance(x, (dict, tuple)):
            raise ValueError(
                "cache='device' stages a single input array; pytree "
                "(dict/tuple) inputs use the streamed eval path")
        result = evaluate_device_cached(trainer, x, y, batch_size)
    elif cache is not None:
        raise ValueError(f"unknown cache mode {cache!r}")
    else:
        # JAX's global batches of batch_size × dp rows, the last padded by
        # repeating its last row and the padding masked out of the sums;
        # batch shard r takes rows [r·batch_size, (r+1)·batch_size) of
        # each, leaf by leaf for a dict or tuple x.
        n = len(first_leaf(x))
        global_batch = batch_size * trainer.dp
        lo = trainer.data_index * batch_size
        sums = torch.zeros(3, dtype=torch.float64, device=trainer.device)
        with torch.inference_mode():
            for start in range(0, n, global_batch):
                xb, bs = slice_pad(x, start, global_batch)
                yb, _ = slice_pad(y, start, global_batch)
                mask = np.zeros(global_batch, np.float32)
                mask[:bs] = 1.0
                mine = lambda a: a[lo:lo + batch_size]  # noqa: E731
                _eval_batch_sums(
                    trainer, trainer._tensor(trainer.cut(tree_map(mine, xb), 0)),
                    trainer._tensor(trainer.cut(mine(yb), 1)),
                    trainer._tensor(mine(mask)), sums)
        result = _reduce_sums(trainer, sums)
    if verbose and runtime.is_primary():
        print(f"eval - {({k: round(v, 4) for k, v in result.items()})}")
    return result
