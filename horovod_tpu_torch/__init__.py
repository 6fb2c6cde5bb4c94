"""horovod_tpu_torch — the PyTorch/CUDA port of `horovod_tpu`.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` nor anything of ``horovod_tpu``. Module names and public
tensor layouts follow the JAX package (attention tensors ``[B, T, H, D]``,
the KV cache ``[B, L, H_kv, D]``, the decode state ``(cache, last_tok,
rng, done)``, NHWC images) so each port module sits beside its reference.

It trains the reference MNIST CNN data-parallel (`init` over
`torch.distributed`, `Trainer` → `DistributedOptimizer`'s bucketed
gradient all-reduce, `callbacks`, `checkpoint`, the launcher
``python -m horovod_tpu_torch.launch run --nprocs N -- ...`` and the
``examples`` twins of both MNIST scripts; ``fit(cache="device")`` stages
the data on the card, and on CUDA the trainer's own feeds run each step as
a replay of one captured CUDA graph), trains the CIFAR-10 ResNet-20 with
global-batch BatchNorm and its ViT branch the same way, serves the
`TransformerLM` on one GPU (bundle → continuous batching engine → HTTP ``/v1/generate`` →
prefill + decode loop) and trains it (forward with the fused chunked-CE
head → backward). Attention runs hand-written CUDA flash-attention kernels
on one of two routes: the tensor-core kernels ``ops/csrc/flash_fwd_sm90.cu``,
``flash_bwd_dq_sm90.cu`` and ``flash_bwd_dkv_sm90.cu`` for bf16 (every bf16
main path), the CUDA-core ``flash_fwd.cu`` and ``flash_bwd.cu`` for f32 or
head dims past 128. Every entry point takes ``device`` and defaults to
``"cuda"``; without CUDA it raises unless the caller asks for ``"cpu"``.
"""

from horovod_tpu_torch.parallel.mesh import scale_lr, shard_epochs, shard_steps
from horovod_tpu_torch.runtime import (
    World, env_flag, init, is_initialized, is_primary, local_rank,
    local_size, process_count, process_rank, rank, resolve_device, shutdown,
    size,
)
from horovod_tpu_torch.training import callbacks
from horovod_tpu_torch.training.optimizer import (
    Compression, DistributedOptimizer, adadelta, adam, adamw,
)
from horovod_tpu_torch.training.train_state import TrainState
from horovod_tpu_torch.training.trainer import Trainer

__all__ = [
    "Compression", "DistributedOptimizer", "TrainState", "Trainer", "World",
    "adadelta", "adam", "adamw", "callbacks", "env_flag", "init",
    "is_initialized", "is_primary", "local_rank", "local_size",
    "process_count", "process_rank", "rank", "resolve_device", "scale_lr",
    "shard_epochs", "shard_steps", "shutdown", "size",
]
