"""Local multi-process launcher — port of the local part of
`horovod_tpu.launch.launcher` (the ``mpirun -np N`` role).

Each child gets the rendezvous in its environment (``HVT_COORDINATOR_
ADDRESS``, ``HVT_NUM_PROCESSES``, ``HVT_PROCESS_ID``, ``HVT_LOCAL_RANK``),
which `runtime.init` reads. Unlike the JAX launcher, one process gets the
rendezvous too: a launched world of one rank has a process group, so its
gradient averaging is a real all-reduce (bare, unlaunched runs have none).
Output is prefixed ``[rank i]``; the first child to fail stops the rest
(MPI's fail-stop).

    python -m horovod_tpu_torch.launch run --nprocs 2 -- python -m \\
        horovod_tpu_torch.examples.tf2_style_mnist
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.runtime import (
    ENV_COORDINATOR,
    ENV_LOCAL_RANK,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
)


def pick_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """Handle on a launched set of processes; `wait` is fail-stop."""

    def __init__(self, procs: list[subprocess.Popen], pumps=()):
        self.procs = list(procs)
        self.pumps = list(pumps)

    def running(self) -> list[subprocess.Popen]:
        return [p for p in self.procs if p.poll() is None]

    def first_failure(self) -> int | None:
        """First nonzero exit code observed so far, None if none yet."""
        return next((p.returncode for p in self.procs
                     if p.returncode not in (None, 0)), None)

    def terminate(self, term_timeout: float = 10.0) -> None:
        """SIGTERM every survivor, SIGKILL after ``term_timeout``."""
        running = self.running()
        for p in running:
            p.terminate()
        for p in running:
            try:
                p.wait(timeout=term_timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def wait(self, grace_seconds: float = 30.0) -> int:
        """Wait for every process. When one exits nonzero, the others get
        ``grace_seconds`` to finish (they may be blocked in a collective
        with the dead rank) and are then terminated. Returns the first
        nonzero exit code, 0 if all succeeded."""
        first_failure = None
        deadline = None
        try:
            while self.running():
                if first_failure is None:
                    first_failure = self.first_failure()
                    if first_failure is not None:
                        deadline = time.monotonic() + grace_seconds
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            self.terminate()
            for t in self.pumps:
                t.join(timeout=5)
        if first_failure is None:
            first_failure = self.first_failure()
        return first_failure or 0


def _pump(proc: subprocess.Popen, tag: str) -> threading.Thread:
    """Prefix-tag a child's merged output, like mpirun's rank tagging."""

    def pump():
        for line in proc.stdout:
            sys.stdout.write(f"[{tag}] {line}")
            sys.stdout.flush()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def start_local(nprocs: int, argv: list[str],
                env: dict[str, str] | None = None) -> Fleet:
    """Launch ``argv`` as ``nprocs`` ranks on this host, the coordinator on
    a free local port; returns the running `Fleet` (``wait()`` it)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    port = pick_free_port()
    base_env = dict(os.environ)
    base_env.update(env or {})
    procs = []
    for i in range(nprocs):
        child_env = dict(base_env)
        child_env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        child_env[ENV_NUM_PROCESSES] = str(nprocs)
        child_env[ENV_PROCESS_ID] = str(i)
        child_env[ENV_LOCAL_RANK] = str(i)
        procs.append(subprocess.Popen(
            argv, env=child_env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    return Fleet(procs, [_pump(p, f"rank {i}") for i, p in enumerate(procs)])


def run_local(nprocs: int, argv: list[str],
              env: dict[str, str] | None = None) -> int:
    """`start_local` + fail-stop `Fleet.wait`."""
    return start_local(nprocs, argv, env=env).wait()


def main(argv: list[str] | None = None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    command: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, command = argv[:split], argv[split + 1:]
    parser = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.launch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="N coordinated processes on this host")
    p_run.add_argument("--nprocs", type=int, required=True)
    p_run.add_argument("--env", action="append", default=[], metavar="K=V")
    args = parser.parse_args(argv)
    if not command:
        parser.error("run needs a command after `--`")
    env = dict(kv.split("=", 1) for kv in args.env)
    return run_local(args.nprocs, command, env=env)
