"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/horovod_tpu_torch/``
at the repository root (listed in ``.gitignore``). The library name carries
a hash of the source, every ``csrc/*.cuh`` header it may include, and the
flags, so an edited source or header rebuilds and an unchanged one loads
the library already built. Sources come from this
checkout only. Nothing here runs at import: the CPU tests import every
module on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "horovod_tpu_torch",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills
]

_lock = threading.Lock()  # guards _name_locks
# One lock per library: different sources build in parallel (one nvcc
# each), while two threads asking for the same one build it once.
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 = found built).
build_seconds: dict[str, float] = {}
# What nvcc printed (ptxas -v) for each library built in this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str, csrc: str = CSRC) -> str:
    """Where the library built from ``<csrc>/<name>.cu`` lives: its name
    hashes the source, every ``<csrc>/*.cuh`` (sorted) and the flags."""
    h = hashlib.sha256()
    with open(os.path.join(csrc, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    for header in sorted(n for n in os.listdir(csrc) if n.endswith(".cuh")):
        h.update(header.encode())
        with open(os.path.join(csrc, header), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        so = library_path(name)
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        if not os.path.exists(so):
            # Build beside the target and rename: a concurrent or cut-off
            # build never leaves a torn library under the final name.
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o",
                 tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
            build_logs[name] = proc.stdout + proc.stderr
        build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib
