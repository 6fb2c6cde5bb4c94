"""Process launchers: local multi-process and ssh multi-host — port of
`horovod_tpu.launch.launcher` (the ``mpirun`` role).

Each child gets the rendezvous in its environment (``HVT_COORDINATOR_
ADDRESS``, ``HVT_NUM_PROCESSES``, ``HVT_PROCESS_ID``, ``HVT_LOCAL_RANK``),
which `runtime.init` reads. Two differences from the JAX launcher, both
from the port running one process per card (`runtime`):

* one process gets the rendezvous too: a launched world of one rank has a
  process group, so its gradient averaging is a real all-reduce (bare,
  unlaunched runs have none);
* `start_hosts` / ``pod`` start ``nprocs_per_host`` ranks on each host
  (``--nprocs-per-host``, default 1, where JAX starts one process a host),
  with local ranks 0..K-1 and process ids host-major (``h*K + j``), so
  `parallel.mesh.dcn_factor` finds the host count.

Output is prefixed ``[rank i]`` (``[host rank i]`` over ssh); the first
child to fail stops the rest after a grace window (MPI's fail-stop).

CLI::

    python -m horovod_tpu_torch.launch run --nprocs 2 -- python -m \\
        horovod_tpu_torch.examples.tf2_style_mnist
    python -m horovod_tpu_torch.launch run --nprocs 1 --max-restarts 3 \\
        --heartbeat-timeout 300 -- python train.py
    python -m horovod_tpu_torch.launch pod --hosts h0,h1 \\
        --nprocs-per-host 8 -- python train.py
    python -m horovod_tpu_torch.launch gate --metrics m.jsonl \\
        --check loss=0.0..0.3
    python -m horovod_tpu_torch.launch job \\
        horovod_tpu_torch/launch/jobs/mnist-ci.yaml
"""

from __future__ import annotations

import os
import shlex
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

# What the refused CLI surfaces name (ROADMAP queue A item 13).
_REFUSED_SUBCOMMANDS = {
    "lint": "ROADMAP queue A item 13 (the analyzer beyond the knob "
            "registry)",
    "serve": "ROADMAP queue A item 13.8 (the serving fleet; one server is "
             "`python -m horovod_tpu_torch.launch.serve`)",
    "fleet": "ROADMAP queue A item 13.6 (the multi-job control plane)",
}


def pick_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """Handle on a launched set of processes. `wait` is fail-stop; the
    supervisor (`launch/supervisor.py`) also drives ``wait(abort=...)`` to
    kill a fleet whose heartbeats went stale (a hung collective is
    invisible to exit codes)."""

    def __init__(self, procs: list[subprocess.Popen], pumps=()):
        self.procs = list(procs)
        self.pumps = list(pumps)
        # True when wait(abort=...) tore the fleet down itself — the
        # supervisor's hang marker.
        self.aborted = False

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

    def wait(self, grace_seconds: float = 30.0, abort=None) -> int:
        """Wait for every process. When one exits nonzero, the others get
        ``grace_seconds`` to finish (they may be blocked in a collective
        with the dead rank) and are then terminated. Returns the first
        nonzero exit code, 0 if all succeeded.

        ``abort``: optional zero-arg callable polled while the fleet is
        healthy; returning True terminates the whole fleet at once and
        sets ``self.aborted`` (the supervisor's stale-heartbeat kill)."""
        first_failure = None
        deadline = None
        try:
            while self.running():
                if first_failure is None:
                    first_failure = self.first_failure()
                    if first_failure is not None:
                        deadline = time.monotonic() + grace_seconds
                if (first_failure is None and abort is not None
                        and abort()):
                    self.aborted = True
                    break
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


def _wait_fail_stop(procs: list[subprocess.Popen],
                    grace_seconds: float = 30.0) -> int:
    """Fail-stop wait over bare Popens (see `Fleet.wait`)."""
    return Fleet(procs).wait(grace_seconds)


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
                env: dict[str, str] | None = None,
                coordinator_port: int | None = None,
                tag_output: bool = True) -> Fleet:
    """Launch ``argv`` as ``nprocs`` ranks on this host, the coordinator on
    ``coordinator_port`` (a free local port by default); returns the
    running `Fleet` (``wait()`` it, or let the supervisor monitor it)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    port = coordinator_port or pick_free_port()
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
            argv, env=child_env,
            stdout=subprocess.PIPE if tag_output else None,
            stderr=subprocess.STDOUT if tag_output else None,
            text=tag_output,
        ))
    pumps = ([_pump(p, f"rank {i}") for i, p in enumerate(procs)]
             if tag_output else [])
    return Fleet(procs, pumps)


def run_local(nprocs: int, argv: list[str],
              env: dict[str, str] | None = None,
              coordinator_port: int | None = None,
              tag_output: bool = True) -> int:
    """`start_local` + fail-stop `Fleet.wait`."""
    return start_local(nprocs, argv, env=env,
                       coordinator_port=coordinator_port,
                       tag_output=tag_output).wait()


def start_hosts(hosts: list[str], argv: list[str],
                env: dict[str, str] | None = None,
                coordinator_port: int = 9981,
                ssh_args: tuple[str, ...] = ("-o",
                                             "StrictHostKeyChecking=no"),
                workdir: str | None = None,
                nprocs_per_host: int = 1) -> Fleet:
    """Launch ``argv`` as ``nprocs_per_host`` ranks on each host over ssh
    and return the running `Fleet`.

    Host 0 is the coordinator every rank dials (its bare name: ``user@host``
    → ``host``); the env is propagated as ``K=V`` exports in the remote
    command (the ``mpirun -x`` role), after ``cd workdir``. Rank ``j`` of
    host ``h`` is process ``h * nprocs_per_host + j`` with local rank
    ``j``."""
    if nprocs_per_host < 1:
        raise ValueError(f"nprocs_per_host must be >= 1, got "
                         f"{nprocs_per_host}")
    coord = f"{hosts[0].rsplit('@', 1)[-1]}:{coordinator_port}"
    world = len(hosts) * nprocs_per_host
    procs, tags = [], []
    for h, host in enumerate(hosts):
        for j in range(nprocs_per_host):
            pid = h * nprocs_per_host + j
            remote_env = {
                ENV_COORDINATOR: coord,
                ENV_NUM_PROCESSES: str(world),
                ENV_PROCESS_ID: str(pid),
                ENV_LOCAL_RANK: str(j),
                **(env or {}),
            }
            exports = " ".join(f"{k}={shlex.quote(v)}"
                               for k, v in remote_env.items())
            cd = f"cd {shlex.quote(workdir)} && " if workdir else ""
            remote_cmd = (f"{cd}{exports} "
                          f"{' '.join(shlex.quote(a) for a in argv)}")
            procs.append(subprocess.Popen(
                ["ssh", *ssh_args, host, remote_cmd],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            tags.append(f"{host} rank {pid}")
    return Fleet(procs, [_pump(p, t) for p, t in zip(procs, tags)])


def run_hosts(hosts: list[str], argv: list[str],
              env: dict[str, str] | None = None,
              coordinator_port: int = 9981,
              ssh_args: tuple[str, ...] = ("-o", "StrictHostKeyChecking=no"),
              workdir: str | None = None,
              nprocs_per_host: int = 1) -> int:
    """`start_hosts` + fail-stop `Fleet.wait` (the blocking pod launch)."""
    return start_hosts(hosts, argv, env=env,
                       coordinator_port=coordinator_port, ssh_args=ssh_args,
                       workdir=workdir,
                       nprocs_per_host=nprocs_per_host).wait()


def _refuse_unported_flags(parser, a) -> None:
    """The JAX CLI's flags that the port does not have yet: parsed, then
    refused before anything runs, naming their ROADMAP item."""
    refused = (
        (a.elastic or a.min_ranks is not None or a.max_ranks is not None,
         "--elastic/--min-ranks/--max-ranks",
         "ROADMAP queue A item 13.4 (elastic supervision)"),
        (a.policy is not None or a.spares is not None, "--policy/--spares",
         "ROADMAP queue A item 13.6 (the supervisor policy engine)"),
        (a.tune is not None, "--tune",
         "ROADMAP queue A item 13.9 (the autotuner)"),
        (a.metrics_port is not None, "--metrics-port",
         "ROADMAP queue A item 13.5 (the trainer-side exporters)"),
    )
    for given, flags, item in refused:
        if given:
            parser.error(f"{flags} is not ported yet — {item}")


def main(argv: list[str] | None = None) -> int:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    # Everything after `--` is the launched command (run/pod only); the head
    # is parsed strictly so typo'd flags error instead of being ignored.
    command: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, command = argv[:split], argv[split + 1:]
    parser = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.launch")
    if argv and argv[0] in _REFUSED_SUBCOMMANDS:
        parser.error(f"{argv[0]} is not ported yet — "
                     f"{_REFUSED_SUBCOMMANDS[argv[0]]}")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="N coordinated processes on this host")
    p_run.add_argument("--nprocs", type=int, required=True)
    p_run.add_argument("--env", action="append", default=[], metavar="K=V")

    p_pod = sub.add_parser("pod", help="K ranks a host over ssh")
    p_pod.add_argument("--hostfile", help="file with one host per line")
    p_pod.add_argument("--hosts", help="comma-separated host list")
    p_pod.add_argument("--nprocs-per-host", type=int, default=1,
                       metavar="K", help="ranks started on each host, one "
                       "card each (default 1)")
    p_pod.add_argument("--port", type=int, default=9981)
    p_pod.add_argument("--workdir")
    p_pod.add_argument("--env", action="append", default=[], metavar="K=V")

    for p in (p_run, p_pod):
        # Supervision (launch/supervisor.py): any of these flags turns the
        # fail-stop launch into a supervised fail-restart launch.
        p.add_argument(
            "--max-restarts", type=int, default=None, metavar="N",
            help="restart the fleet on failure, up to N consecutive "
            "no-progress restarts (progress = a new checkpoint under "
            "PS_MODEL_PATH)")
        p.add_argument(
            "--backoff", type=float, default=None, metavar="SECONDS",
            help="initial restart backoff (doubles per no-progress restart)")
        p.add_argument(
            "--heartbeat-timeout", type=float, default=None,
            metavar="SECONDS",
            help="kill+restart the fleet when the newest rank heartbeat is "
            "older than this (hang detection; sets HVT_HEARTBEAT_DIR for "
            "the ranks)")
        p.add_argument(
            "--status-port", type=int, default=None, metavar="N",
            help="serve the supervisor's status over HTTP on this port (0: "
            "a free one, printed): GET /status, /journal, /healthz, "
            "/metrics. Needs a supervised launch")
        p.add_argument(
            "--restart-log", default=None, metavar="PATH",
            help="JSONL restart journal (default: "
            "$PS_MODEL_PATH/restarts.jsonl; gateable — `gate --metrics "
            "<log> --check restarts=0..N --aggregate count`)")
        # The JAX CLI's other flags: parsed so that they are refused with
        # their ROADMAP item instead of being unknown.
        p.add_argument("--metrics-port", type=int, default=None,
                       help=argparse.SUPPRESS)
        p.add_argument("--elastic", action="store_true",
                       help=argparse.SUPPRESS)
        p.add_argument("--min-ranks", type=int, default=None,
                       help=argparse.SUPPRESS)
        p.add_argument("--max-ranks", type=int, default=None,
                       help=argparse.SUPPRESS)
        p.add_argument("--policy", default=None, help=argparse.SUPPRESS)
        p.add_argument("--spares", type=int, default=None,
                       help=argparse.SUPPRESS)
        p.add_argument("--tune", default=None, help=argparse.SUPPRESS)

    p_gate = sub.add_parser("gate", help="CI metric range check")
    p_gate.add_argument("--metrics", required=True, help="metrics.jsonl path")
    p_gate.add_argument("--check", action="append", required=True,
                        metavar="NAME=LO..HI")
    p_gate.add_argument("--aggregate", default="mean",
                        choices=["mean", "last", "min", "max", "count"])

    p_job = sub.add_parser("job", help="run a YAML job spec")
    p_job.add_argument("spec")

    args = parser.parse_args(argv)
    if args.cmd in ("run", "pod"):
        if not command:
            parser.error(f"{args.cmd} needs a command after `--`")
        _refuse_unported_flags(parser, args)
    elif command:
        parser.error(f"{args.cmd} takes no trailing command")

    def restart_policy(a):
        """None unless a supervision flag was given — any of the four."""
        if (a.max_restarts is None and a.heartbeat_timeout is None
                and a.backoff is None and a.restart_log is None):
            return None
        from horovod_tpu_torch.launch import supervisor

        return supervisor.RestartPolicy.from_mapping({
            "max_restarts": a.max_restarts,
            "backoff": a.backoff,
            "heartbeat_timeout": a.heartbeat_timeout,
        })

    def unsupervised_status_port(a):
        if a.status_port is not None:
            parser.error("--status-port needs a supervised launch: add a "
                         "restart flag (--max-restarts/--backoff/"
                         "--heartbeat-timeout/--restart-log)")

    if args.cmd in ("run", "pod"):
        from horovod_tpu_torch.launch import supervisor

        env = dict(kv.split("=", 1) for kv in args.env)
        try:
            supervisor.refuse_unported_env(env)
        except NotImplementedError as e:
            parser.error(str(e))
        policy = restart_policy(args)
    if args.cmd == "run":
        if policy is not None:
            return supervisor.supervise_local(
                args.nprocs, command, env=env, policy=policy,
                log_path=args.restart_log, status_port=args.status_port,
            )
        unsupervised_status_port(args)
        return run_local(args.nprocs, command, env=env)
    if args.cmd == "pod":
        if args.hostfile:
            with open(args.hostfile) as f:
                hosts = [h.strip() for h in f
                         if h.strip() and not h.strip().startswith("#")]
        elif args.hosts:
            hosts = args.hosts.split(",")
        else:
            parser.error("pod needs --hostfile or --hosts")
        if args.heartbeat_timeout is not None and not (
                env.get("PS_MODEL_PATH") or os.environ.get("PS_MODEL_PATH")):
            # A launcher-local tmpdir heartbeat dir can never observe
            # remote ranks' beats: hang detection would never fire.
            parser.error(
                "pod --heartbeat-timeout needs a shared filesystem for "
                "heartbeats: set PS_MODEL_PATH to a mount shared with "
                "every host (NFS/GCS-fuse)")
        if policy is not None:
            return supervisor.supervise_hosts(
                hosts, command, env=env, policy=policy,
                coordinator_port=args.port,
                nprocs_per_host=args.nprocs_per_host, workdir=args.workdir,
                log_path=args.restart_log, status_port=args.status_port,
            )
        unsupervised_status_port(args)
        return run_hosts(hosts, command, env=env, coordinator_port=args.port,
                         workdir=args.workdir,
                         nprocs_per_host=args.nprocs_per_host)
    if args.cmd == "gate":
        from horovod_tpu_torch.launch.ci_gate import run_checks

        checks = {}
        for spec in args.check:
            name, target = spec.split("=", 1)
            checks[name] = {"target": target, "aggregate": args.aggregate}
        return 0 if run_checks(args.metrics, checks) else 1
    if args.cmd == "job":
        from horovod_tpu_torch.launch.job import run_job

        return run_job(args.spec)
    return 2
