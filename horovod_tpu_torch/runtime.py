"""Device resolution and the shared boolean env contract.

Single process only in this slice: the distributed surface of
`horovod_tpu.runtime` (init/rank/size over a mesh) arrives with the
training slice.
"""

from __future__ import annotations

import os

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
