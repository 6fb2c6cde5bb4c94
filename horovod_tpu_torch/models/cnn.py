"""The reference MNIST CNN — port of `horovod_tpu.models.cnn.MnistCNN`.

Conv2D(32, 3×3, relu) → Conv2D(64, 3×3, relu) → MaxPool(2×2) → Dropout(.25)
→ Flatten → Dense(128, relu) → Dropout(.5) → Dense(10), VALID padding, on
NHWC input like the flax model, returning f32 logits.

* Integer (uint8) pixels are turned to f32 / 255 on the device, then cast
  to the compute dtype; parameters stay f32 and are cast per use (flax's
  ``dtype=`` with f32 ``param_dtype``).
* Flatten order: the pooled activations are permuted back to NHWC before
  the flatten, so ``Dense(128)``'s input order is flax's and its weight is
  the flax kernel transposed (`models.convert.cnn_params_from_flax`).
* Dropout masks come from ``dropout_seed`` (the trainer's per-step seed,
  an int or a 0-d int64 tensor), sites 0 and 1, never from torch's global
  RNG (`ops.dropout`: a CUDA kernel on the card); the bits cannot equal
  JAX's threefry bits.
* Convolutions and dense layers are library calls (cuDNN and cuBLAS on
  the card): the JAX model runs no Pallas kernel either.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.transformer import _dtype
from horovod_tpu_torch.ops.dropout import dropout
from horovod_tpu_torch.runtime import resolve_device


@torch.no_grad()
def init_flax_style(named_parameters, seed: int) -> None:
    """flax's default initializers for ``named_parameters`` (in order, from
    a CPU generator seeded with ``seed``): a ``bias`` is zero, any other
    tensor a kernel, lecun-normal (truncated at 2σ, fan-in scaled; the
    fan-in of a torch weight ``[out, in, ...]`` is the product of its
    trailing dimensions)."""
    g = torch.Generator().manual_seed(seed)
    for name, p in named_parameters:
        if name.endswith("bias"):
            p.zero_()
            continue
        fan_in = math.prod(p.shape[1:])
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        p.copy_(w)


class MnistCNN(nn.Module):
    """``[B, 28, 28, 1]`` images (uint8 or float) → ``[B, num_classes]``
    f32 logits. Weights are flax's initializers (lecun-normal kernels, zero
    biases) from a generator seeded with ``seed``."""

    def __init__(self, num_classes: int = 10, compute_dtype=torch.float32,
                 *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.compute_dtype = _dtype(compute_dtype)
        self.conv1 = nn.Conv2d(1, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.dense1 = nn.Linear(12 * 12 * 64, 128)
        self.dense2 = nn.Linear(128, num_classes)
        self.reset_parameters(seed)
        self.to(dev)

    def reset_parameters(self, seed: int = 0) -> None:
        """lecun-normal kernels and zero biases, flax's defaults, from a
        seeded CPU generator."""
        init_flax_style(self.named_parameters(), seed)

    def forward(self, x, *, train: bool = False,
                dropout_seed: int | None = None):
        if train and dropout_seed is None:
            raise ValueError("train=True needs dropout_seed (the trainer "
                             "passes its per-step seed)")
        if not torch.is_floating_point(x):
            x = x.float() / 255.0
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)  # NHWC → NCHW
        for conv in (self.conv1, self.conv2):
            x = F.relu(F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd)))
        x = F.max_pool2d(x, 2)
        if train:
            x = dropout(x, 0.25, dropout_seed, 0)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten
        x = F.relu(F.linear(x, self.dense1.weight.to(cd),
                            self.dense1.bias.to(cd)))
        if train:
            x = dropout(x, 0.5, dropout_seed, 1)
        x = F.linear(x, self.dense2.weight.to(cd), self.dense2.bias.to(cd))
        return x.float()
