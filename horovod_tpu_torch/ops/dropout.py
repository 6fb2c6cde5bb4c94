"""Dropout whose mask is a counter-based hash — the wrapper around the
hand-written CUDA kernel ``csrc/dropout.cu`` and its plain PyTorch version.

flax's ``nn.Dropout``, which the JAX models call (no Pallas kernel), keeps
each element with probability 1 − rate and scales it by 1 / (1 − rate),
drawing the mask from ``jax.random`` inside the compiled program. The
port draws it from no generator: element i of site ``site`` under
``seed`` is kept when the top 24 bits of a hash of (the site's seed,
i) reach ``round(rate · 2^24)``, and a kept element is ``x · scale`` with
``scale`` = 1 / (1 − rate) rounded to f32, the product in f32, rounded to
x's dtype. ``seed`` is an int or a 0-d int64 tensor on the device (what a
captured CUDA graph reads at each replay); both give the same mask, so an
eager step and a replayed one, and a remat recompute, draw the same one.
The bits cannot equal JAX's threefry bits.

Device policy: a CPU tensor takes the plain version (`dropout_reference`:
int64 tensor ops, 32-bit words with every product masked back to 32 bits,
so nothing reaches 2^63); a CUDA tensor launches the kernel (forward and
backward — the backward is the same function of the gradient) or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from horovod_tpu_torch.ops import _build

launches = 0

_M32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fn = None


def _mix32(h):
    """MurmurHash3's 32-bit finalizer on words held in int64 tensors or
    Python ints (the same operators, the same values): every multiplier is
    below 2^31 and every product is masked back to 32 bits."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def _seed_words(seed):
    """``seed`` (an int or a 0-d int64 tensor) as two words: its low 32
    bits and the 31 above them."""
    if not isinstance(seed, torch.Tensor):
        seed = int(seed) & (2**63 - 1)
    return seed & _M32, (seed >> 32) & 0x7FFFFFFF


def fold_seed(seed, k: int):
    """The seed of site ``k`` under ``seed``: a 63-bit int for an int seed,
    a 0-d int64 tensor on the seed's device for a tensor seed — equal
    values either way."""
    lo, hi = _seed_words(seed)
    kk = _mix32((int(k) & _M32) ^ 0x3C6EF372)
    lo = _mix32(lo ^ kk)
    hi = _mix32(hi ^ lo ^ 0x1B873593) & 0x7FFFFFFF
    return (hi << 32) | lo


def _threshold(rate: float) -> int:
    return int(round(rate * 2**24))


def dropout_reference(x, rate: float, seed, site: int = 0):
    """The kernel's function in plain PyTorch (``0 < rate < 1``)."""
    lo, hi = _seed_words(fold_seed(seed, site))
    a = _mix32(lo ^ 0x243F6A88)
    b = _mix32(hi ^ a)
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    h = _mix32(_mix32((idx & _M32) ^ a) ^ b).view(x.shape)
    keep = (h >> 8) >= _threshold(rate)
    kept = (x.float() * (1.0 / (1.0 - rate))).to(x.dtype)
    return torch.where(keep, kept, 0.0)


def _kernel():
    global _fn
    if _fn is None:
        ptr = ctypes.c_void_p
        fn = _build.library("dropout").hvt_dropout
        fn.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x, rate: float, seed, site: int):
    """The kernel on a CUDA tensor: a new contiguous tensor like ``x``."""
    global launches
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dropout kernel takes one of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {x.dtype}")
    if isinstance(seed, torch.Tensor):
        if seed.device != x.device or seed.dtype != torch.int64 \
                or seed.numel() != 1:
            raise ValueError(f"a seed tensor must be one int64 on "
                             f"{x.device}, got {seed.dtype} {tuple(seed.shape)}"
                             f" on {seed.device}")
        seed_ptr, seed_val = seed.data_ptr(), 0
    else:
        seed_ptr, seed_val = None, int(seed) & (2**63 - 1)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), out.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
            seed_ptr, seed_val, int(site) & _M32, _threshold(rate),
            1.0 / (1.0 - rate),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err}")
    launches += 1
    return out


class _Dropout(torch.autograd.Function):
    """The kernel forward and backward: d out / d x is the same mask and
    scale, so the backward runs the kernel on the gradient."""

    @staticmethod
    def forward(ctx, x, rate, seed, site):
        ctx.args = (rate, seed, site)
        return _launch(x, rate, seed, site)

    @staticmethod
    def backward(ctx, grad):
        return _launch(grad, *ctx.args), None, None, None


def dropout(x, rate: float, seed, site: int = 0):
    """flax ``nn.Dropout`` in train mode with the mask of (``seed``,
    ``site``): the kernel on a CUDA tensor, `dropout_reference` on a CPU
    one."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if x.device.type == "cpu":
        return dropout_reference(x, rate, seed, site)
    if x.device.type != "cuda":
        raise ValueError(f"dropout runs on cuda or cpu, got {x.device}")
    return _Dropout.apply(x, rate, seed, site)
