"""ctypes binding of the native batch-assembly engine — port of
`horovod_tpu.data.native_loader`, over the port's own copy of its C++
source, ``data/csrc/hvt_data.cc``.

A C++ producer thread permutes, gathers and stages training batches into a
ring of reusable host buffers while the device runs the previous step.
`NativeBatchLoader` yields the same byte stream as the JAX package's
loader of the same name: each pass's permutation is a pure function of
``(seed, epoch, pass)`` (splitmix64 seed mixing, xorshift128+), epochs are
anchored at ``start_epoch`` and cut at ``batches_per_epoch``.

The library is built with ``g++ -O3 -std=c++17 -fPIC -pthread -shared`` at
first use, into ``build/horovod_tpu_torch/`` under a name that hashes the
source and the flags (as ``ops/_build.py`` names the CUDA libraries).
`available()` is False under ``HVT_NO_NATIVE=1``, without a C++ compiler,
or when the library does not build or load: callers then take the python
engine (`data.loader.training_pipeline`).

Each yielded array is an owned copy by default; ``copy=False`` yields
views of the ring's slot, valid until the next ``__next__`` and while the
loader is alive.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Sequence

import numpy as np

from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "hvt_data.cc")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
ABI_VERSION = 2

_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> str:
    """Where the library built from ``SOURCE`` lives: its name hashes the
    source and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhvt_data-{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    """The built library's path (building it if needed), None when there
    is no compiler or it fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build beside the target and rename: a concurrent or cut-off build
    # never leaves a torn library under the final name.
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def _load():
    """The loaded library, or None when the native engine is unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if registry.get_flag("HVT_NO_NATIVE"):
            _load_failed = True
            return None
        so = _build()
        try:
            lib = ctypes.CDLL(so) if so else None
        except OSError:
            lib = None
        # ABI handshake, as the JAX binding does: a library of another
        # stream contract must not produce batches.
        if lib is None or not hasattr(lib, "hvt_loader_abi_version") \
                or lib.hvt_loader_abi_version() != ABI_VERSION:
            _load_failed = True
            return None
        lib.hvt_loader_create.restype = ctypes.c_void_p
        lib.hvt_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.hvt_loader_next.restype = ctypes.c_int
        lib.hvt_loader_next.argtypes = [ctypes.c_void_p]
        lib.hvt_loader_slot_ptr.restype = ctypes.c_void_p
        lib.hvt_loader_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
        lib.hvt_loader_release.restype = None
        lib.hvt_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.hvt_loader_destroy.restype = None
        lib.hvt_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native engine can run here (builds on first call)."""
    return _load() is not None


class NativeBatchLoader:
    """Infinite iterator of ``(arr_0[batch], arr_1[batch], ...)`` tuples
    assembled off-thread in C++: a fresh full permutation per pass,
    batches never straddle a pass's remainder.

    ``start_epoch`` anchors the stream's first epoch; ``batches_per_epoch``
    > 0 cuts each epoch at exactly that many batches (passes roll within a
    longer epoch), 0 keeps one pass per epoch."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 seed: int = 0, shuffle: bool = True, n_slots: int = 4,
                 copy: bool = True, start_epoch: int = 0,
                 batches_per_epoch: int = 0):
        self._handle = None
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native loader unavailable (no C++ compiler, HVT_NO_NATIVE "
                f"set, or {SOURCE} did not build)")
        self._lib = lib
        self.copy = copy
        # The library borrows these base pointers: keep C-contiguous
        # copies alive for the loader's lifetime.
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        n = self._arrays[0].shape[0]
        if any(a.shape[0] != n for a in self._arrays):
            raise ValueError("all arrays must share the leading dimension")
        if not 0 < batch_size <= n:
            raise ValueError(f"batch_size {batch_size} not in [1, {n}]")
        if int(n_slots) < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.batch_size = int(batch_size)
        self._shapes = [(self.batch_size,) + a.shape[1:] for a in self._arrays]
        self._dtypes = [a.dtype for a in self._arrays]
        ptrs = (ctypes.c_void_p * len(self._arrays))(
            *[a.ctypes.data for a in self._arrays])
        row_bytes = (ctypes.c_int64 * len(self._arrays))(
            *[a.strides[0] if a.ndim else a.itemsize for a in self._arrays])
        self._handle = lib.hvt_loader_create(
            ptrs, row_bytes, len(self._arrays), n, self.batch_size,
            int(n_slots), int(seed) & 0xFFFFFFFFFFFFFFFF, 1 if shuffle else 0,
            int(start_epoch), int(batches_per_epoch))
        if not self._handle:
            raise RuntimeError("hvt_loader_create failed")
        self._held_slot = -1

    def __iter__(self):
        return self

    def _release_held(self) -> None:
        if self._held_slot >= 0:
            self._lib.hvt_loader_release(self._handle, self._held_slot)
            self._held_slot = -1

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        # The previous batch's slot is recycled now (the views' lifetime).
        self._release_held()
        slot = self._lib.hvt_loader_next(self._handle)
        if slot < 0:
            raise StopIteration
        self._held_slot = slot
        out = []
        for idx, (shape, dtype) in enumerate(zip(self._shapes, self._dtypes)):
            ptr = self._lib.hvt_loader_slot_ptr(self._handle, slot, idx)
            size = int(np.prod(shape)) * dtype.itemsize
            buf = (ctypes.c_char * size).from_address(ptr)
            arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
            out.append(arr.copy() if self.copy else arr)
        return tuple(out)

    def skip(self, n_batches: int) -> None:
        """Fast-forward past ``n_batches`` batches with no host copy: each
        slot is taken and released unread."""
        if self._handle is None:
            raise RuntimeError("loader is closed")
        self._release_held()
        for _ in range(int(n_batches)):
            slot = self._lib.hvt_loader_next(self._handle)
            if slot < 0:
                raise RuntimeError("native loader stream ended during skip")
            self._lib.hvt_loader_release(self._handle, slot)

    def close(self) -> None:
        """Stop the producer thread and free the ring (idempotent)."""
        if self._handle is not None:
            self._lib.hvt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
