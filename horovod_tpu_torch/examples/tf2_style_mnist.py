"""MNIST data-parallel training — the TF2-script capability set on the port.

Twin of the JAX package's ``examples/tf2_style_mnist.py`` (itself a mirror
of the reference's ``tensorflow2_keras_mnist.py``):

* model/checkpoint dirs from ``PS_MODEL_PATH`` (default ``./models``)
* runtime bootstrap (the ``hvd.init()`` role; pins ``cuda:local_rank``)
* per-rank dataset cache path avoiding filesystem races
* infinite shuffled per-rank batches of 128
* the 2-conv CNN (bf16 compute, f32 parameters)
* Adam with lr = 0.001 × world size, gradient-averaging optimizer
* sparse categorical cross-entropy + accuracy
* callbacks: broadcast-from-0, metric averaging, 3-epoch LR warmup
* rank-0-only per-epoch checkpoints + scalar event log, resume
* fit with steps_per_epoch = 500 // size, 24 epochs, rank-0 verbosity

Run it bare (one process, no process group), or under the launcher:

    python -m horovod_tpu_torch.examples.tf2_style_mnist
    python -m horovod_tpu_torch.launch run --nprocs 2 -- \\
        python -m horovod_tpu_torch.examples.tf2_style_mnist

Knobs: ``HVT_DEVICE`` (``cuda``, the default, or ``cpu``),
``HVT_BACKWARD_PASSES``, ``HVT_COMPRESSION`` (``none``/``bf16``/``fp16``,
or the quantized ``int8``/``fp8`` with error feedback, whose residual rows
the checkpoints then carry), ``HVT_COMPRESSION_ICI`` (the two-hop
reduction's ici wire, with ``HVT_DCN_FACTOR``); smoke-test cuts
``DRIVE_STEPS``, ``DRIVE_EPOCHS`` (full reference budget when unset). The
port's twin also prints the world, and ends by printing every rank's state
digest and the peak device memory, which ``chip_smoke.py`` reads.
"""

import os

import numpy as np
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint, metrics
from horovod_tpu_torch.data import datasets
from horovod_tpu_torch.data.loader import ArrayDataset
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.parallel import collectives


def main() -> None:
    model_dir = os.path.join(os.environ.get("PS_MODEL_PATH", "./models"),
                             "horovod-mnist")
    device = os.environ.get("HVT_DEVICE") or "cuda"

    # Bootstrap: one call, idempotent, launched and unlaunched.
    topology = hvt.init(device=device)
    metrics.init(sync_tensorboard=True)
    if hvt.rank() == 0:
        print("World:", topology)

    # Per-rank cache path ('mnist-%d.npz' % hvd.rank()).
    (x_train, y_train), _ = datasets.mnist(path=f"mnist-{hvt.rank()}.npz")
    x_train = (x_train.astype(np.float32) / 255.0)[..., None]
    y_train = y_train.astype(np.int64)

    # This rank's shard → repeat → shuffle(10000) → per-rank batch of 128.
    world = hvt.process_count()
    per_process_batch = 128 * hvt.size() // world
    dataset = (
        ArrayDataset((x_train, y_train))
        .shard(hvt.process_rank(), world)
        .repeat()
        .shuffle(10000, seed=hvt.process_rank())
        .batch(per_process_batch)
    )

    backward_passes = int(os.environ.get("HVT_BACKWARD_PASSES") or 1)
    compression = os.environ.get("HVT_COMPRESSION") or "none"
    compression_ici = os.environ.get("HVT_COMPRESSION_ICI") or "none"
    trainer = hvt.Trainer(
        MnistCNN(compute_dtype=torch.bfloat16, device=device),
        # Adam(0.001 × size) wrapped for gradient averaging.
        hvt.DistributedOptimizer(
            hvt.adam(hvt.scale_lr(0.001)),
            backward_passes_per_step=backward_passes,
            compression=compression,
            compression_ici=compression_ici,
        ),
        loss="sparse_categorical_crossentropy",
        device=device,
    )

    callbacks = [
        hvt.callbacks.BroadcastGlobalVariablesCallback(0),
        hvt.callbacks.MetricAverageCallback(),
        hvt.callbacks.LearningRateWarmupCallback(warmup_epochs=3, verbose=1),
    ]
    # Rank-0-only artifacts; other workers would corrupt them.
    if hvt.rank() == 0:
        callbacks.append(hvt.callbacks.ModelCheckpoint(
            os.path.join(model_dir, "checkpoint-{epoch}.pt")))
        callbacks.append(hvt.callbacks.ScalarLogger(model_dir,
                                                    update_freq="batch"))

    steps_per_epoch = (int(os.environ.get("DRIVE_STEPS", 0))
                       or hvt.shard_steps(500))
    epochs = int(os.environ.get("DRIVE_EPOCHS", 0)) or 24

    # Resume at step granularity: the primary restores the newest
    # checkpoint, every rank adopts it, fit fast-forwards the data.
    trainer.build(x_train[:1])
    trainer.state, done_epochs, done_steps = (
        checkpoint.restore_latest_and_broadcast(
            model_dir, trainer.state, with_step=True))
    if (done_epochs or done_steps) and hvt.rank() == 0:
        print(f"Resuming from checkpoint epoch {done_epochs}"
              + (f" step {done_steps}" if done_steps else ""))

    trainer.fit(
        dataset,
        steps_per_epoch=steps_per_epoch,
        epochs=epochs,
        initial_epoch=done_epochs,
        initial_step=done_steps,
        callbacks=callbacks,
        verbose=1 if hvt.rank() == 0 else 0,
    )

    digests = collectives.allgather_object(checkpoint.state_digest(trainer.state))
    if hvt.rank() == 0:
        print("State digests:", " ".join(digests))
        if torch.cuda.is_available() and trainer.device.type == "cuda":
            print("Peak device memory (bytes):",
                  torch.cuda.max_memory_allocated())
    hvt.shutdown()


if __name__ == "__main__":
    main()
