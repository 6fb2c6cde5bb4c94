"""Device resolution, seed derivation and the shared boolean env contract.

Single process only: the distributed surface of `horovod_tpu.runtime`
(init/rank/size over a mesh) is ROADMAP queue A items 1-2.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def env_flag(name: str) -> bool:
    """Shared boolean env-var contract: unset/''/'0'/'false'/'no' are off
    (case-insensitive), anything else is on — the same spellings as the
    JAX package's knob registry accepts."""
    return (os.environ.get(name) or "").lower() not in ("", "0", "false", "no")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a `torch.device`, refusing a CUDA request on a host
    without CUDA. Entry points default to ``"cuda"`` and never carry on
    quietly on the CPU: the CPU runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available — "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def derive_seed(*keys: int) -> int:
    """A 63-bit seed mixed from integer keys (numpy's `SeedSequence`) — the
    port's ``jax.random.fold_in``: one seed per (step, layer, site) that
    depends on nothing but its keys, never on a generator's state."""
    words = [int(k) & (2**64 - 1) for k in keys]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))
