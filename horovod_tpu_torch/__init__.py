"""horovod_tpu_torch — the PyTorch/CUDA port of `horovod_tpu`.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` nor anything of ``horovod_tpu``. Module names and public
tensor layouts follow the JAX package (attention tensors ``[B, T, H, D]``,
the KV cache ``[B, L, H_kv, D]``, the decode state ``(cache, last_tok,
rng, done)``) so each port module sits beside its reference.

It serves the `TransformerLM` on one GPU (bundle → continuous batching
engine → HTTP ``/v1/generate`` → prefill + decode loop) and trains it
(`Trainer` → forward with the fused chunked-CE head → backward →
`DistributedOptimizer`). Attention runs the hand-written CUDA
flash-attention kernels: the forward ``ops/csrc/flash_fwd.cu`` and the
backward ``ops/csrc/flash_bwd.cu``. Every entry point takes ``device`` and
defaults to ``"cuda"``; without CUDA it raises unless the caller asks for
``"cpu"``.
"""

from horovod_tpu_torch.runtime import env_flag, resolve_device
from horovod_tpu_torch.training.optimizer import (
    DistributedOptimizer, adamw, scale_lr,
)
from horovod_tpu_torch.training.train_state import TrainState
from horovod_tpu_torch.training.trainer import Trainer

__all__ = ["DistributedOptimizer", "TrainState", "Trainer", "adamw",
           "env_flag", "resolve_device", "scale_lr"]
