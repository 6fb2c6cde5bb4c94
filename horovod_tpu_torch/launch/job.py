"""Job specs — port of `horovod_tpu.launch.job` (the `.ps_project/` role).

A spec binds a command, a topology (local ``nprocs``, or ``hosts`` with
``nprocs_per_host`` ranks each), env and post-run checks, mirroring what
`distributed-keras-sample.yaml` (the experiment) + `config.yaml` (the
workflow with its checks) express for the reference. See
`horovod_tpu_torch/launch/jobs/mnist-ci.yaml` for the shape.

Specs are read by `launch.specfile` (the YAML subset job specs use), never
by PyYAML. Keys: ``command``, ``nprocs``, ``nprocs_per_host`` (port-only:
the port runs one rank a card), ``hosts``, ``coordinator_port``,
``workdir``, ``env``, ``fresh``, ``restart:``, ``status_port`` under
``job:``; ``metrics``, ``checks``, ``journal_checks`` and
``metrics_checks`` at the top. ``elastic:``, ``policy:``, ``tune:`` and
``serve:`` are refused by `validate_spec`, naming their ROADMAP item.
"""

from __future__ import annotations

import os
import shlex
import subprocess

from horovod_tpu_torch.launch import ci_gate, launcher, specfile, supervisor

# The JAX job blocks the port does not run yet, and the item each waits for.
_REFUSED_BLOCKS = {
    "elastic": "ROADMAP queue A item 13.4 (elastic supervision)",
    "policy": "ROADMAP queue A item 13.6 (the supervisor policy engine)",
    "tune": "ROADMAP queue A item 13.9 (the autotuner)",
    "serve": "ROADMAP queue A item 13.8 (the serving fleet)",
}


def validate_spec(spec) -> list:
    """Validate a parsed job spec BEFORE any side effect (fresh-dir wipe,
    metrics reset, process spawn). Returns a list of error strings — empty
    means the spec is launchable. The ``restart:`` block is dry-built
    through `RestartPolicy.from_mapping`, the constructor the launch uses,
    so a typo'd key fails here with its message."""
    errors: list = []
    if not isinstance(spec, dict):
        return [f"spec must be a mapping, got {type(spec).__name__}"]
    job = spec.get("job")
    if not isinstance(job, dict):
        return [f"job: must be a mapping, got {job!r}"]
    for key, item in _REFUSED_BLOCKS.items():
        if key in job:
            errors.append(f"job {key}: is not ported yet — {item}")
    if "serve" not in job and not job.get("command"):
        errors.append("job command: is required")
    if "restart" in job:
        block = job["restart"] or {}
        if not isinstance(block, dict):
            errors.append(f"job restart: must be a mapping, got {block!r}")
        else:
            try:
                supervisor.RestartPolicy.from_mapping(
                    {k: v for k, v in block.items() if k != "log"})
            except (TypeError, ValueError) as e:
                errors.append(f"job restart: {e}")
    return errors


def run_job(spec_path: str) -> int:
    """Execute a job spec: launch, then gate. Returns a shell exit code."""
    spec = specfile.load(spec_path)
    problems = validate_spec(spec)
    if problems:
        for p in problems:
            print(f"{spec_path}: {p}")
        return 1

    job = spec.get("job", {})
    command = job.get("command")
    argv = command if isinstance(command, list) else shlex.split(command)
    env = {str(k): str(v) for k, v in (job.get("env") or {}).items()}
    try:
        supervisor.refuse_unported_env(env)
    except NotImplementedError as e:
        print(f"{spec_path}: {e}")
        return 1

    checks = spec.get("checks") or {}
    metrics_path = spec.get(
        "metrics",
        os.path.join(env.get("PS_MODEL_PATH", "./models"), "metrics.jsonl"),
    )
    # The sink appends; a leftover stream from a previous run must not feed
    # this run's gate (a regressed run could pass on old values).
    if checks and os.path.exists(metrics_path):
        os.remove(metrics_path)

    hosts = job.get("hosts")
    per_host = int(job.get("nprocs_per_host", 1))
    port = int(job.get("coordinator_port", 9981))
    # `fresh: true`: wipe the job-owned model dir before launching — a
    # gated convergence run must train from scratch, not resume a finished
    # run (which would push no metrics and fail the gate on an empty
    # stream). The wipe happens where the entry script will look: on
    # hosts[0] (the single writer), a relative path resolved against the
    # job's workdir, exactly like the remote command itself.
    if job.get("fresh"):
        raw = env.get("PS_MODEL_PATH", "./models")
        if hosts:
            target = raw if os.path.isabs(raw) else os.path.join(
                job.get("workdir") or ".", raw)
        else:
            target = os.path.abspath(raw)
        norm = os.path.normpath(target)
        if norm in ("/", ".", os.path.expanduser("~")) or (
                os.path.isabs(norm) and norm.count(os.sep) < 2):
            print(f"refusing to wipe suspicious fresh dir {norm}")
            return 1
        if hosts:
            code = _remote_rm(
                hosts[0], norm, recursive=True,
                why="a stale checkpoint would make the run resume instead "
                "of train — refusing to gate")
            if code != 0:
                return code
        else:
            import shutil

            shutil.rmtree(norm, ignore_errors=True)
    if hosts and checks:
        # The sink appends on the coordinator host: reset it there too. A
        # failed reset is fatal — gating a possibly-stale stream could PASS
        # a broken run.
        code = _remote_rm(hosts[0], metrics_path, recursive=False,
                          why="refusing to gate against a possibly-stale "
                          "stream")
        if code != 0:
            return code
    # `restart:` block — supervised fail-restart launch (supervisor.py):
    #   restart:
    #     max_restarts: 3         # consecutive no-progress budget
    #     backoff: 1.0            # seconds, doubles per no-progress restart
    #     heartbeat_timeout: 300  # omit to disable hang detection
    #     log: path/restarts.jsonl  # default $PS_MODEL_PATH/restarts.jsonl
    # A top-level `status_port: N` under job: serves the supervisor's own
    # HTTP status (/status, /journal, /healthz, /metrics) for the run.
    log_path = None  # set by the supervised branch; journal_checks need it
    status_port = (int(job["status_port"])
                   if job.get("status_port") is not None else None)
    if status_port is not None and "restart" not in job:
        # As the CLI's --status-port: the server is the supervisor's.
        print("job status_port: needs a supervised launch — add a "
              "restart: block")
        return 1
    if "restart" in job:
        # `restart:` with every knob commented out means "supervise with
        # defaults", as any supervision flag does on the CLI.
        restart = job["restart"] or {}
        policy = supervisor.RestartPolicy.from_mapping(
            {k: v for k, v in restart.items() if k != "log"})
        log_path = restart.get("log") or supervisor.default_log_path(env)
        # A previous run's journal and metrics dump must not feed this
        # run's gates.
        _reset_journal(log_path, supervisor.default_model_dir(env))
        if hosts:
            code = supervisor.supervise_hosts(
                list(hosts), argv, env=env, policy=policy,
                coordinator_port=port, nprocs_per_host=per_host,
                workdir=job.get("workdir"), log_path=log_path,
                status_port=status_port)
        else:
            code = supervisor.supervise_local(
                int(job.get("nprocs", 1)), argv, env=env, policy=policy,
                log_path=log_path, status_port=status_port)
    elif hosts:
        code = launcher.run_hosts(list(hosts), argv, env=env,
                                  coordinator_port=port,
                                  workdir=job.get("workdir"),
                                  nprocs_per_host=per_host)
    else:
        code = launcher.run_local(int(job.get("nprocs", 1)), argv, env=env)
    if code != 0:
        print(f"job failed with exit code {code}")
        return code

    # `journal_checks:` — the `checks:` grammar over the supervisor's
    # restart JOURNAL (e.g. `restarts: {target: "0..1", aggregate: count}`).
    # Without a supervised launch there is no journal: fail loudly.
    journal_checks = spec.get("journal_checks") or {}
    if journal_checks:
        if not log_path:
            print("journal_checks: needs a restart: block (no restart "
                  "journal was written)")
            return 1
        if not ci_gate.run_checks(log_path, journal_checks):
            return 1
    # `metrics_checks:` — gate the supervisor's final Prometheus scrape
    # (<PS_MODEL_PATH>/metrics.prom, the series GET /metrics serves live):
    #   metrics_checks:
    #     hvt_committed_step: {target: "1..1000000"}
    #     hvt_restarts_total: {target: "0..0"}
    metrics_checks = spec.get("metrics_checks") or {}
    if metrics_checks:
        if not log_path:
            print("metrics_checks: needs a restart: block (no supervisor "
                  "metrics dump was written)")
            return 1
        prom_path = supervisor.default_metrics_dump_path(
            supervisor.default_model_dir(env), log_path)
        if not ci_gate.run_prom_checks(prom_path, metrics_checks):
            return 1

    if not checks:
        return 0
    if hosts:
        # Rank 0 on hosts[0] wrote the stream there; without shared
        # storage it must be fetched before gating.
        metrics_path = _fetch_remote_metrics(hosts[0], metrics_path)
    return 0 if ci_gate.run_checks(metrics_path, checks) else 1


def _reset_journal(log_path: str | None, model_dir: str | None = None) -> None:
    """Remove a previous run's restart journal, its rotated ``.1``
    predecessor (the gate reads across the rotation) and the supervisor's
    final metrics dump."""
    if not log_path:
        return
    paths = [log_path, log_path + ".1"]
    prom = supervisor.default_metrics_dump_path(model_dir, log_path)
    if prom:
        paths.append(prom)
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def _remote_rm(host: str, path: str, recursive: bool, why: str) -> int:
    """Remove a path on a remote host over ssh; nonzero (with a message) on
    failure — callers treat failure as fatal for gating correctness."""
    flag = "-rf" if recursive else "-f"
    res = subprocess.run(
        ["ssh", "-o", "StrictHostKeyChecking=no", host,
         f"rm {flag} {shlex.quote(path)}"],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        print(f"cannot remove {path} on {host} ({res.stderr.strip()}); {why}")
        return res.returncode or 1
    return 0


def _fetch_remote_metrics(host: str, remote_path: str) -> str:
    """scp the metrics stream from the coordinator host; on failure fall
    back to the local path (the shared-filesystem deployment)."""
    import tempfile

    local = os.path.join(tempfile.mkdtemp(prefix="hvt-gate-"),
                         "metrics.jsonl")
    res = subprocess.run(
        ["scp", "-o", "StrictHostKeyChecking=no", f"{host}:{remote_path}",
         local],
        capture_output=True,
    )
    return local if res.returncode == 0 else remote_path
