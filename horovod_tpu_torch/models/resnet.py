"""The CIFAR ResNet — port of `horovod_tpu.models.resnet` (BASELINE.json
config 4: ResNet-20, depth 6n+2, three stages of n basic blocks at
16/32/64 channels, 1×1 projection shortcuts, global average pool).

The flax model's semantics, carried over where torch's layers differ:

* NHWC images in (uint8 is divided by 255 on the device), NCHW inside,
  f32 logits out; compute in ``compute_dtype`` (bf16 or f32) with f32
  parameters cast per use.
* flax's "SAME" padding: stride 1 pads (1, 1), but a 3×3 stride-2 conv on
  an even side pads (0, 1) — ``nn.Conv2d(padding=1)`` would give the
  right shape over shifted windows — so stride-2 convs pad explicitly.
  The 1×1 stride-2 projection pads nothing.
* `BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
  torch's: f32 statistics even for bf16 input, the variance E[x²] − E[x]²
  clipped at 0, the running variance biased, and in train mode the
  statistics of the **global** batch — the JAX step computes them inside
  its SPMD program over every chip's rows, so the port all-reduces each
  layer's moments over the ranks (forward and backward,
  `collectives.allreduce_mean_differentiable`). Eval mode normalizes with
  the running statistics and communicates nothing.
* Convolutions and the dense layer are library calls (cuDNN, cuBLAS): the
  JAX model runs no Pallas kernel either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch import runtime
from horovod_tpu_torch.models.cnn import init_flax_style
from horovod_tpu_torch.models.transformer import _dtype
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.runtime import resolve_device

#: flax ``nn.BatchNorm``'s settings at every BN site of the JAX model.
MOMENTUM, EPS = 0.9, 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype)`` over the
    channels of an NCHW tensor. ``weight``/``bias`` are flax's
    ``scale``/``bias``; the buffers ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var`` (initially 0 and 1), updated in place
    in train mode as ``MOMENTUM · running + (1 − MOMENTUM) · batch``."""

    #: The forward communicates across ranks in train mode (`graphs`
    #: reads this: such a step cannot sit in a graph under gloo).
    reduces_over_ranks = True

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = _dtype(dtype)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, *, train: bool = False):
        # f32 statistics (f64 for an f64 input, so a float64 reference
        # runs the same code in full precision).
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            # [mean, mean of squares] stacked, as flax stacks them for its
            # cross-replica mean: one all-reduce a layer.
            moments = torch.stack([xf.mean(dim=(0, 2, 3)),
                                   (xf * xf).mean(dim=(0, 2, 3))])
            if runtime.size() > 1:
                moments = collectives.allreduce_mean_differentiable(moments)
            mean = moments[0]
            var = (moments[1] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def _conv(x, conv: nn.Conv2d, stride: int, dtype):
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` at ``stride``: the
    output side is ceil(side / stride) and the padding it needs goes low
    half first, the odd one high — (0, 1) for a 3×3 stride-2 conv on an
    even side, which torch's symmetric ``padding=`` cannot express."""
    k, side = conv.weight.shape[-1], x.shape[-1]
    total = max((-(-side // stride) - 1) * stride + k - side, 0)
    lo = total // 2
    if total - lo != lo:
        x = F.pad(x, (lo, total - lo, lo, total - lo))
        lo = 0
    return F.conv2d(x, conv.weight.to(dtype), None, stride, lo)


class BasicBlock(nn.Module):
    """conv3×3(stride) → BN → relu → conv3×3 → BN, plus the shortcut (a
    1×1 conv + BN where the shape changes), then relu. flax's names:
    ``Conv_0/1`` and ``BatchNorm_0/1``, the projection ``Conv_2`` and
    ``BatchNorm_2``."""

    def __init__(self, in_features: int, filters: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Conv2d(in_features, filters, 3, bias=False)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.projects = in_features != filters or stride != 1
        if self.projects:
            self.proj_conv = nn.Conv2d(in_features, filters, 1, bias=False)
            self.proj_bn = BatchNorm(filters, dtype=dtype)

    def forward(self, x, *, train: bool = False):
        cd = self.dtype
        y = F.relu(self.bn1(_conv(x, self.conv1, self.stride, cd),
                            train=train))
        y = self.bn2(_conv(y, self.conv2, 1, cd), train=train)
        shortcut = x
        if self.projects:
            shortcut = self.proj_bn(
                _conv(x, self.proj_conv, self.stride, cd), train=train)
        return F.relu(y + shortcut)


class ResNetCIFAR(nn.Module):
    """``[B, H, W, 3]`` images (uint8 or float) → ``[B, num_classes]`` f32
    logits; depth 6n+2 (20 → n = 3). Kernels lecun-normal, the dense bias
    zero, BN scale 1 and bias 0, from a CPU generator seeded with
    ``seed``."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 compute_dtype=torch.float32, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError(f"depth must be 6n+2, got {depth}")
        dev = resolve_device(device)
        n = (depth - 2) // 6
        self.depth, self.num_classes = depth, num_classes
        cd = self.compute_dtype = _dtype(compute_dtype)
        self.conv = nn.Conv2d(3, 16, 3, bias=False)
        self.bn = BatchNorm(16, dtype=cd)
        blocks, width = [], 16
        for filters, stride in ((16, 1), (32, 2), (64, 2)):
            for i in range(n):
                blocks.append(BasicBlock(width, filters,
                                         stride if i == 0 else 1, cd))
                width = filters
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(64, num_classes)
        self.reset_parameters(seed)
        self.to(dev)

    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers: lecun-normal conv and dense kernels, zero
        dense bias (`cnn.init_flax_style`); BN scale 1, bias 0, running
        mean 0 and variance 1."""
        init_flax_style(((n, p) for n, p in self.named_parameters()
                         if "bn" not in n), seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

    def forward(self, x, *, train: bool = False, dropout_seed=None):
        del dropout_seed  # no dropout in this model
        if not torch.is_floating_point(x):
            x = x.float() / 255.0
        cd = self.compute_dtype
        x = x.to(cd).permute(0, 3, 1, 2)  # NHWC → NCHW
        x = F.relu(self.bn(_conv(x, self.conv, 1, cd), train=train))
        for block in self.blocks:
            x = block(x, train=train)
        x = x.mean(dim=(2, 3))  # global average pool
        x = F.linear(x, self.fc.weight.to(cd), self.fc.bias.to(cd))
        return x.float()
