"""CIFAR-10 ResNet-20 data-parallel training — the heavier-gradients
configuration (BASELINE.json config 4) on the port.

Twin of the JAX package's ``examples/cifar10_resnet.py``: the capability
set of the TF2 MNIST script (bootstrap, sharded data, gradient-averaging
optimizer, broadcast / metric-average / warmup callbacks, rank-0 I/O) with
a model whose ~270k parameters over 20 layers exercise the all-reduce the
way real workloads do. BatchNorm takes the statistics of the global batch:
each layer all-reduces its moments over the ranks, as the JAX step's SPMD
program does over its chips. ``ARCH=vit`` swaps in the conv-free ViT
through the same training path.

    python -m horovod_tpu_torch.examples.cifar10_resnet
    python -m horovod_tpu_torch.launch run --nprocs 2 -- \\
        python -m horovod_tpu_torch.examples.cifar10_resnet

Knobs: ``ARCH`` (``resnet``, the default, or ``vit``), ``HVT_DEVICE``
(``cuda``, the default, or ``cpu``); smoke-test cuts ``DRIVE_STEPS``,
``DRIVE_EPOCHS``, ``DRIVE_EVAL_N`` (the reference budget when unset). The
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
from horovod_tpu_torch.models.resnet import ResNetCIFAR
from horovod_tpu_torch.models.vit import ViT
from horovod_tpu_torch.parallel import collectives


def main() -> None:
    model_dir = os.path.join(os.environ.get("PS_MODEL_PATH", "./models"),
                             "horovod-cifar")
    device = os.environ.get("HVT_DEVICE") or "cuda"

    topology = hvt.init(device=device)
    metrics.init(sync_tensorboard=True)
    if hvt.rank() == 0:
        print("World:", topology)

    (x_train, y_train), (x_test, y_test) = datasets.cifar10(
        path=f"cifar10-{hvt.rank()}.npz")
    x_train = x_train.astype(np.float32) / 255.0
    x_test = x_test.astype(np.float32) / 255.0
    y_train = y_train.astype(np.int64)
    y_test = y_test.astype(np.int64)
    if os.environ.get("DRIVE_EVAL_N"):
        n = int(os.environ["DRIVE_EVAL_N"])
        x_test, y_test = x_test[:n], y_test[:n]

    world = hvt.process_count()
    per_process_batch = 128 * hvt.size() // world
    dataset = (
        ArrayDataset((x_train, y_train))
        .shard(hvt.process_rank(), world)
        .repeat()
        .shuffle(10000, seed=hvt.process_rank())
        .batch(per_process_batch)
    )

    # ARCH=vit swaps the conv model for the conv-free ViT through the
    # identical training path: architecture is a swappable leaf.
    if os.environ.get("ARCH", "resnet") == "vit":
        module = ViT(patch_size=4, d_model=256, n_heads=8, n_layers=6,
                     compute_dtype=torch.bfloat16, device=device)
    else:
        module = ResNetCIFAR(depth=20, compute_dtype=torch.bfloat16,
                             device=device)
    trainer = hvt.Trainer(
        module,
        hvt.DistributedOptimizer(hvt.adam(hvt.scale_lr(0.001))),
        loss="sparse_categorical_crossentropy",
        device=device,
    )

    callbacks = [
        hvt.callbacks.BroadcastGlobalVariablesCallback(0),
        hvt.callbacks.MetricAverageCallback(),
        hvt.callbacks.LearningRateWarmupCallback(warmup_epochs=3, verbose=1),
    ]
    # Epoch scalars reach the platform sink via sync_tensorboard
    # (metrics.init above).
    if hvt.rank() == 0:
        callbacks.append(hvt.callbacks.ModelCheckpoint(
            os.path.join(model_dir, "checkpoint-{epoch}.pt")))
        callbacks.append(hvt.callbacks.ScalarLogger(model_dir))

    steps_per_epoch = (int(os.environ.get("DRIVE_STEPS", 0))
                       or hvt.shard_steps(390))
    epochs = int(os.environ.get("DRIVE_EPOCHS", 0)) or 24

    trainer.fit(
        dataset,
        steps_per_epoch=steps_per_epoch,
        epochs=epochs,
        callbacks=callbacks,
        verbose=1 if hvt.rank() == 0 else 0,
    )

    score = trainer.evaluate(x_test, y_test, batch_size=128)
    metrics.push("loss", score["loss"])
    metrics.push("accuracy", score["accuracy"])
    digests = collectives.allgather_object(
        checkpoint.state_digest(trainer.state))
    if hvt.rank() == 0:
        print("Test loss:", score["loss"])
        print("Test accuracy:", score["accuracy"])
        print("State digests:", " ".join(digests))
        if torch.cuda.is_available() and trainer.device.type == "cuda":
            print("Peak device memory (bytes):",
                  torch.cuda.max_memory_allocated())
    hvt.shutdown()


if __name__ == "__main__":
    main()
