"""horovod_tpu_torch — the PyTorch/CUDA port of `horovod_tpu`.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` nor anything of ``horovod_tpu``. Module names and public
tensor layouts follow the JAX package (attention tensors ``[B, T, H, D]``,
the KV cache ``[B, L, H_kv, D]``, the decode state ``(cache, last_tok,
rng, done)``) so each port module sits beside its reference.

This slice serves the `TransformerLM` on one GPU: bundle → continuous
batching engine → HTTP ``/v1/generate`` → prefill (the hand-written CUDA
flash-attention forward, ``ops/csrc/flash_fwd.cu``) + decode loop. Every
entry point takes ``device`` and defaults to ``"cuda"``; without CUDA it
raises unless the caller asks for ``"cpu"``.
"""

from horovod_tpu_torch.runtime import env_flag, resolve_device

__all__ = ["env_flag", "resolve_device"]
