"""MNIST train → eval → serving export — the TF1-script capability set on
the port.

Twin of the JAX package's ``examples/tf1_style_mnist.py`` (a mirror of the
reference's ``mnist_keras.py``): platform metrics init, runtime bootstrap,
epoch-count work division ``ceil(12 / size)``, full-dataset normalize +
one-hot labels, the same CNN (f32), Adadelta with lr = 1.0 × size wrapped
for gradient averaging, categorical cross-entropy, the broadcast-from-0
callback only, rank-0 checkpoints + event log, per-epoch validation and a
final all-rank evaluate, and the rank-0 export tail: save the final model,
reload it, export a serving bundle with an ``input → prob`` signature into
a timestamped directory, print test loss/accuracy (the CI gate's input).

    python -m horovod_tpu_torch.examples.tf1_style_mnist
    python -m horovod_tpu_torch.launch run --nprocs 2 -- \\
        python -m horovod_tpu_torch.examples.tf1_style_mnist

Knobs: ``HVT_DEVICE`` (``cuda``, the default, or ``cpu``),
``HVT_DEVICE_CACHE=1`` (the reference CI job's setting: the dataset staged
on the card once, ``fit(cache="device")``), ``HVT_EXPORT_FORMAT``;
smoke-test cuts ``DRIVE_EPOCHS``, ``DRIVE_TRAIN_N``, ``DRIVE_EVAL_N``. The
port's twin also prints the world, the fit's feed (path and input engine),
the serving bundle's path, every rank's state digest and the peak device
memory, which ``chip_smoke.py`` reads.
"""

import json
import os

import numpy as np
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch import checkpoint, metrics
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data import datasets
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.parallel import collectives


def main() -> None:
    model_path = os.environ.get("PS_MODEL_PATH", "./models")
    model_dir = os.path.join(model_path, "horovod-mnist")
    export_dir = os.path.join(model_path, "horovod-mnist-export")
    device = registry.get_str("HVT_DEVICE")

    metrics.init(sync_tensorboard=True)
    topology = hvt.init(device=device)
    if hvt.rank() == 0:
        print("World:", topology)

    batch_size = 128
    num_classes = 10
    # Work division idiom #2: epoch count ÷ world size.
    epochs = int(os.environ.get("DRIVE_EPOCHS", 0)) or hvt.shard_epochs(12)

    (x_train, y_train), (x_test, y_test) = datasets.mnist()
    x_train = (x_train.astype(np.float32) / 255.0)[..., None]
    x_test = (x_test.astype(np.float32) / 255.0)[..., None]
    if os.environ.get("DRIVE_TRAIN_N"):
        n = int(os.environ["DRIVE_TRAIN_N"])
        x_train, y_train = x_train[:n], y_train[:n]
    if os.environ.get("DRIVE_EVAL_N"):
        n = int(os.environ["DRIVE_EVAL_N"])
        x_test, y_test = x_test[:n], y_test[:n]
    # One-hot labels + categorical CE, the reference pairing.
    y_train_oh = np.eye(num_classes, dtype=np.float32)[y_train]
    y_test_oh = np.eye(num_classes, dtype=np.float32)[y_test]

    trainer = hvt.Trainer(
        MnistCNN(num_classes=num_classes, device=device),
        # Adadelta(1.0 × size) + gradient averaging.
        hvt.DistributedOptimizer(hvt.adadelta(hvt.scale_lr(1.0))),
        loss="categorical_crossentropy",
        device=device,
    )

    # Broadcast only, like the reference; epoch scalars reach the metrics
    # sink through sync_tensorboard.
    callbacks = [hvt.callbacks.BroadcastGlobalVariablesCallback(0)]
    if hvt.rank() == 0:
        callbacks.append(hvt.callbacks.ModelCheckpoint(
            os.path.join(model_dir, "checkpoint-{epoch}.pt")))
        callbacks.append(hvt.callbacks.ScalarLogger(
            os.path.join(model_dir, "eval"), update_freq="batch"))

    # Resume from the newest checkpoint, continuing the epoch numbering.
    trainer.build(x_train[:1])
    trainer.state, done_epochs = checkpoint.restore_latest_and_broadcast(
        model_dir, trainer.state)
    if done_epochs and hvt.rank() == 0:
        print(f"Resuming from checkpoint epoch {done_epochs}")

    # HVT_DEVICE_CACHE=1: stage the dataset on the card once and train and
    # validate from there (Trainer.fit cache='device'). Off by default, as
    # the reference streams.
    fit_kwargs = (
        {"cache": "device"} if registry.get_flag("HVT_DEVICE_CACHE") else {}
    )
    trainer.fit(
        x=x_train,
        y=y_train_oh,
        batch_size=batch_size,
        epochs=epochs,
        initial_epoch=done_epochs,
        callbacks=callbacks,
        validation_data=(x_test, y_test_oh),
        verbose=1 if hvt.rank() == 0 else 0,
        **fit_kwargs,
    )
    if hvt.rank() == 0:
        print("Feed:", json.dumps(trainer._stream_geometry))

    score = trainer.evaluate(x_test, y_test_oh, batch_size=batch_size)

    if hvt.rank() == 0:
        # Final model save → reload round trip.
        final_path = os.path.join(model_dir, "keras-sample-model.pt")
        checkpoint.save(final_path, trainer.state)
        restored = checkpoint.restore(final_path, trainer.state)
        # Serving export: timestamped dir, input → prob signature.
        bundle = checkpoint.export_serving(
            export_dir, restored.model, input_shape=(1, 28, 28, 1),
            format=registry.get_str("HVT_EXPORT_FORMAT"),
        )
        print("Exported serving bundle:", bundle)

    metrics.push("loss", score["loss"])
    metrics.push("accuracy", score["accuracy"])
    print("Test loss:", score["loss"])
    print("Test accuracy:", score["accuracy"])

    digests = collectives.allgather_object(checkpoint.state_digest(trainer.state))
    if hvt.rank() == 0:
        print("State digests:", " ".join(digests))
        if torch.cuda.is_available() and trainer.device.type == "cuda":
            print("Peak device memory (bytes):",
                  torch.cuda.max_memory_allocated())
    hvt.shutdown()


if __name__ == "__main__":
    main()
