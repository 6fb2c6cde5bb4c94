"""Restart supervisor — port of the non-elastic part of
`horovod_tpu.launch.supervisor`: fail-*restart* semantics around the
fail-stop launchers (SURVEY.md §5.3, the layer the reference leaves to a
human).

The reference's fault model ends at fail-stop: any rank failure kills the
MPI job (`launcher.Fleet.wait`) and recovery is *manual* — an operator
reruns the command and `checkpoint.restore_latest_and_broadcast` resumes
from the newest checkpoint. `supervise()` closes that loop:

* **Failure classification.** Exit 143 / SIGTERM is a *preemption* (the
  `PreemptionCheckpointCallback(exit_code=143)` convention); 137 / SIGKILL
  an *oom-kill*; anything else nonzero a *crash*; a fleet the supervisor
  itself killed for stale heartbeats a *hang*.
* **Progress-aware restart budget.** The budget decrements only when a
  launch made *no progress* (the newest checkpoint under ``model_dir``
  unchanged since the previous launch); backoff doubles between
  no-progress restarts and resets on progress. A deterministic crash loop
  burns ``max_restarts`` and exits with the original exit code.
* **Hang detection.** Each rank touches ``<heartbeat_dir>/rank-<i>`` from
  `callbacks.HeartbeatCallback` (auto-installed by ``fit()`` when the
  supervisor exports ``HVT_HEARTBEAT_DIR``); when the newest beat stops
  changing for ``heartbeat_timeout`` seconds the supervisor kills the
  fleet and relaunches it.

Every decision is appended to a JSONL journal whose records are
metric-shaped (``{"name": "restarts", "value": <total so far>, ...}``), so
the CI gate reads it unchanged::

    python -m horovod_tpu_torch.launch gate --metrics restarts.jsonl \\
        --check restarts=1..1 --aggregate count

``--status-port`` serves the supervisor's own ``/status``, ``/journal``,
``/healthz`` and ``/metrics`` (`start_status_server`); at teardown the last
scrape lands in ``metrics.prom`` (`dump_metrics`), which a job spec's
``metrics_checks:`` gates.

Not ported, and refused when asked for: elastic supervision
(``ElasticPolicy``, ``supervise_elastic*``: ROADMAP queue A item 13.4),
the policy engine (``policy_config``, ``HVT_POLICY``: 13.6), the flight
recorder (``HVT_FLIGHT_RECORD``) and the fleet rollup (``/fleet``,
``HVT_METRICS_PORT``: 13.5).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import tempfile
import time

from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.launch import launcher
from horovod_tpu_torch.obs import core as obs_core
from horovod_tpu_torch.obs import prom as obs_prom
from horovod_tpu_torch.runtime import ENV_HEARTBEAT_DIR

# Any file named like a checkpoint artifact counts as progress, matched
# against the basename, extension-agnostic like checkpoint.latest_checkpoint.
_CHECKPOINT_RE = re.compile(r"checkpoint-(\d+)")

ITEM_ELASTIC = "ROADMAP queue A item 13.4 (elastic supervision)"
ITEM_FLIGHT = "ROADMAP queue A item 13.5 (flight recorder, fleet rollup)"
ITEM_POLICY = "ROADMAP queue A item 13.6 (the supervisor policy engine)"


def refuse_unported_env(env=None) -> None:
    """Raise `NotImplementedError` when the job env (overlaid on this
    process's environment) asks for a supervisor feature the port does not
    have: the flight recorder, the trainer metrics exporters behind the
    fleet rollup, or the policy engine. Called before any process spawns."""
    environ = dict(os.environ)
    environ.update(env or {})
    if registry.get_str("HVT_FLIGHT_RECORD", environ=environ):
        raise NotImplementedError(
            f"HVT_FLIGHT_RECORD is not ported yet — {ITEM_FLIGHT}")
    if registry.get_raw("HVT_METRICS_PORT", environ=environ) is not None:
        raise NotImplementedError(
            "HVT_METRICS_PORT (the trainer-side exporters and the "
            f"supervisor's /fleet rollup) is not ported yet — {ITEM_FLIGHT}")
    if registry.get_str("HVT_POLICY", environ=environ) != "off":
        raise NotImplementedError(
            f"HVT_POLICY is not ported yet — {ITEM_POLICY}")


def _refuse_policy(policy_config) -> None:
    if policy_config is not None:
        raise NotImplementedError(
            f"policy_config is not ported yet — {ITEM_POLICY}")


@dataclasses.dataclass
class RestartPolicy:
    """Knobs for `supervise` (CLI: --max-restarts/--backoff/
    --heartbeat-timeout; YAML: the job's ``restart:`` block).

    ``max_restarts`` bounds *consecutive no-progress* restarts, not total
    restarts. ``heartbeat_timeout=None`` disables hang detection; size it
    above the longest legitimate beat-free span (compile + first capture,
    a whole epoch on the device-cached path where batch callbacks fire
    once an epoch or a chunk, post-fit export/eval work).
    ``startup_timeout`` bounds time-to-FIRST-beat (default ``None`` = 10 ×
    ``heartbeat_timeout``). ``oom_kill_budget``: consecutive no-progress
    oom-kill restarts before giving up (None shares ``max_restarts``)."""

    max_restarts: int = 3
    backoff: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    heartbeat_timeout: float | None = None
    startup_timeout: float | None = None
    grace_seconds: float = 30.0
    oom_kill_budget: int | None = None

    @classmethod
    def from_mapping(cls, mapping) -> "RestartPolicy":
        """Build a policy from a partial dict — the single constructor both
        front-ends (CLI flags, the YAML ``restart:`` block) funnel through.
        Unknown keys are rejected loudly. ``None`` values mean 'keep the
        default' (unset CLI flags)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(mapping) - fields
        if unknown:
            raise ValueError(
                f"unknown restart policy keys {sorted(unknown)}; "
                f"valid: {sorted(fields)}"
            )
        policy = cls()
        for key, value in mapping.items():
            if value is None:
                continue
            setattr(
                policy, key,
                int(value) if key in ("max_restarts", "oom_kill_budget")
                else float(value),
            )
        return policy


def classify(exit_code: int, hang: bool = False) -> str:
    """Map a fleet outcome to a restart-log kind: ``hang``, ``preemption``
    (143 or a SIGTERM death), ``oom-kill`` (137 or a SIGKILL death) or
    ``crash``."""
    if hang:
        return "hang"
    if exit_code in (143, -signal.SIGTERM):
        return "preemption"
    if exit_code in (137, -signal.SIGKILL):
        return "oom-kill"
    return "crash"


def shell_code(exit_code: int) -> int:
    """Popen returncodes are negative for signal deaths; shells speak
    128+sig. Positive codes pass through untouched."""
    if exit_code > 0:
        return exit_code
    if exit_code < 0:
        return 128 - exit_code
    return 0


def newest_checkpoint_marker(model_dir: str | None):
    """Identity of the newest checkpoint-like file under ``model_dir``
    (recursive), as a comparable ``(path, mtime_ns, size)`` tuple; None
    when there are none. Two calls comparing unequal == progress was made
    in between."""
    if not model_dir or not os.path.isdir(model_dir):
        return None
    newest = None
    for root, _, files in os.walk(model_dir):
        for name in files:
            if not _CHECKPOINT_RE.search(name) and not _CHECKPOINT_RE.search(
                os.path.basename(root)
            ):
                continue
            full = os.path.join(root, name)
            try:
                st = os.stat(full)
            except OSError:
                continue  # racing a writer's atomic rename
            key = (st.st_mtime_ns, full)
            if newest is None or key > newest[0]:
                newest = (key, (full, st.st_mtime_ns, st.st_size))
    return newest[1] if newest else None


def _reset_heartbeats(heartbeat_dir: str) -> None:
    """Clear stale beats before a (re)launch — a leftover rank file from the
    previous attempt would read as instantly-stale."""
    os.makedirs(heartbeat_dir, exist_ok=True)
    for name in os.listdir(heartbeat_dir):
        if name.startswith("rank-"):
            try:
                os.remove(os.path.join(heartbeat_dir, name))
            except OSError:
                pass


def newest_beat(heartbeat_dir: str) -> float | None:
    """Wall-clock mtime of the freshest ``rank-*`` beat, None if none."""
    try:
        names = os.listdir(heartbeat_dir)
    except OSError:
        return None
    newest = None
    for name in names:
        if not name.startswith("rank-"):
            continue
        try:
            mt = os.stat(os.path.join(heartbeat_dir, name)).st_mtime
        except OSError:
            continue
        newest = mt if newest is None else max(newest, mt)
    return newest


def heartbeats_stale(heartbeat_dir: str, timeout: float,
                     now=None) -> bool:
    """True when heartbeats exist but the newest is older than ``timeout``
    of wall-clock ``now`` (a same-clock convenience check; the supervisor
    itself uses `_throttled_staleness_check`)."""
    newest = newest_beat(heartbeat_dir)
    if newest is None:
        return False
    return (now if now is not None else time.time()) - newest > timeout


def _throttled_staleness_check(heartbeat_dir: str, timeout: float,
                               startup_timeout: float):
    """An abort hook for `Fleet.wait` that stats the heartbeat dir at a
    cadence proportional to the timeout (bounded to [0.5 s, 5 s]).

    Two hang shapes are bounded: beats that STOPPED (the newest beat's
    mtime unchanged for ``timeout`` of the supervisor's monotonic clock —
    immune to clock skew between hosts) and beats that never STARTED (no
    rank file within ``startup_timeout`` of the launch)."""
    interval = max(0.5, min(5.0, timeout / 10.0))
    t0 = time.monotonic()
    state = {"next": 0.0, "stale": False, "beat": None, "changed_at": t0}

    def abort() -> bool:
        now = time.monotonic()
        if now >= state["next"]:
            state["next"] = now + interval
            beat = newest_beat(heartbeat_dir)
            if beat is None:
                state["stale"] = now - t0 > startup_timeout
            else:
                if beat != state["beat"]:
                    state["beat"] = beat
                    state["changed_at"] = now
                state["stale"] = now - state["changed_at"] > timeout
        return state["stale"]

    return abort


class RestartLog:
    """Append-only JSONL restart journal. Records double as CI-gate metrics:
    each carries ``name``/``value`` (value = total restarts so far).

    **Rotation**: past ``max_lines`` or ``max_bytes`` the file is renamed
    to ``<path>.1`` (replacing the previous predecessor) and appending
    continues in a fresh file; readers (`fleet_status`, `journal_records`,
    `ci_gate.read_metric`) read ``.1`` first. Defaults come from
    ``HVT_RESTART_LOG_MAX_LINES`` / ``HVT_RESTART_LOG_MAX_MB`` (100000
    lines / 64 MB; 0 disables that bound)."""

    def __init__(self, path: str | None, max_lines: int | None = None,
                 max_bytes: int | None = None,
                 extra: dict | None = None):
        self.path = path
        self.extra = dict(extra or {})
        if max_lines is None:
            max_lines = registry.get_int("HVT_RESTART_LOG_MAX_LINES")
        if max_bytes is None:
            max_bytes = int(
                registry.get_float("HVT_RESTART_LOG_MAX_MB") * 1024 * 1024
            )
        self.max_lines = max_lines or None
        self.max_bytes = max_bytes or None
        self._lines: int | None = None  # counted lazily on first write

    def touch(self) -> None:
        """Ensure the journal exists even for a zero-restart run: the gate
        fails on a MISSING file, so 'ran supervised, zero restarts' must be
        distinguishable from 'never ran'."""
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a"):
            pass

    def _maybe_rotate(self) -> None:
        if self.max_lines is None and self.max_bytes is None:
            return
        over_lines = (
            self.max_lines is not None
            and self._lines is not None
            and self._lines >= self.max_lines
        )
        over_bytes = False
        if not over_lines and self.max_bytes is not None:
            try:
                over_bytes = os.path.getsize(self.path) >= self.max_bytes
            except OSError:
                pass
        if over_lines or over_bytes:
            try:
                os.replace(self.path, self.path + ".1")
            except OSError:
                return  # rotation is best-effort; keep appending
            self._lines = 0

    def write(self, name: str, value: float, **fields) -> None:
        if not self.path:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._lines is None:
            try:
                with open(self.path) as f:
                    self._lines = sum(1 for _ in f)
            except OSError:
                self._lines = 0
        record = {"name": name, "value": value, "wall_time": time.time(),
                  **self.extra, **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
        self._lines += 1
        self._maybe_rotate()


def supervise(
    start,
    policy: RestartPolicy | None = None,
    *,
    model_dir: str | None = None,
    heartbeat_dir: str | None = None,
    log_path: str | None = None,
    status_port: int | None = None,
    policy_config=None,
    sleep=time.sleep,
    verbose: bool = True,
) -> int:
    """Launch-monitor-relaunch loop. ``start`` is a zero-arg callable
    returning a running `launcher.Fleet` (close over `start_local` /
    `start_hosts` with the env already carrying ``HVT_HEARTBEAT_DIR`` —
    `supervise_local` does this wiring). Returns 0 on fleet success, else
    the final failure's shell exit code once the no-progress budget is
    exhausted. ``status_port`` serves `start_status_server` for the run's
    duration (0 binds an ephemeral port; the bound address is printed)."""
    _refuse_policy(policy_config)
    policy = policy or RestartPolicy()
    log = RestartLog(log_path)
    log.touch()
    # Shared with the status server's /metrics scrape and the final dump.
    budget = {"max": policy.max_restarts, "used": 0}
    status_server = (
        start_status_server(status_port, log_path, budget=budget,
                            model_dir=model_dir)
        if status_port is not None else None
    )
    if status_server is not None and verbose:
        host, port = status_server.server_address[:2]
        print(f"supervisor: status on http://{host}:{port}", flush=True)
    try:
        return _supervise_loop(
            start, policy, log, model_dir, heartbeat_dir, sleep, verbose,
            newest_checkpoint_marker(model_dir), budget,
        )
    finally:
        dump_metrics(log_path, budget, model_dir)
        if status_server is not None:
            status_server.shutdown()
            status_server.server_close()


def _supervise_loop(start, policy, log, model_dir, heartbeat_dir, sleep,
                    verbose, marker, budget) -> int:
    total_restarts = 0  # lifetime count — what the log/gate report
    backoff = policy.backoff
    attempt = 0
    restarts_used = budget["used"]  # consecutive no-progress restarts
    oom_used = 0  # consecutive no-progress oom-kill restarts
    while True:
        attempt += 1
        abort = None
        if heartbeat_dir and policy.heartbeat_timeout is not None:
            _reset_heartbeats(heartbeat_dir)
            abort = _throttled_staleness_check(
                heartbeat_dir, policy.heartbeat_timeout,
                policy.startup_timeout
                if policy.startup_timeout is not None
                else 10.0 * policy.heartbeat_timeout,
            )
        fleet = start()
        code = fleet.wait(policy.grace_seconds, abort=abort)
        if code == 0 and not fleet.aborted:
            if verbose and total_restarts:
                print(f"supervisor: fleet succeeded after "
                      f"{total_restarts} restart(s)", flush=True)
            return 0

        kind = classify(code, hang=fleet.aborted)
        new_marker = newest_checkpoint_marker(model_dir)
        progressed = model_dir is not None and new_marker != marker
        marker = new_marker
        if progressed:
            # Fresh checkpoint since launch: not a deterministic loop —
            # full budget and backoff again.
            restarts_used = 0
            oom_used = 0
            backoff = policy.backoff
        budget["used"] = restarts_used
        oom_exhausted = (
            kind == "oom-kill"
            and policy.oom_kill_budget is not None
            and oom_used >= policy.oom_kill_budget
        )
        if restarts_used >= policy.max_restarts or oom_exhausted:
            log.write(
                "supervisor_gave_up", 1.0, attempt=attempt, kind=kind,
                exit_code=code, restarts=total_restarts,
                **({"budget": "oom-kill"} if oom_exhausted else {}),
            )
            if verbose:
                spent = (
                    f"oom-kill budget ({policy.oom_kill_budget}) spent"
                    if oom_exhausted else
                    f"no progress in the last {restarts_used} restart(s)"
                )
                print(
                    f"supervisor: giving up after {total_restarts} "
                    f"restart(s) — attempt {attempt} {kind} "
                    f"(exit {code}), {spent}", flush=True,
                )
            # `or 1`: a hang-killed rank that trapped SIGTERM and exited 0
            # must still surface as failure.
            return shell_code(code) or 1
        restarts_used += 1
        if kind == "oom-kill":
            oom_used += 1
        budget["used"] = restarts_used
        total_restarts += 1
        log.write(
            "restarts", float(total_restarts), attempt=attempt, kind=kind,
            exit_code=code, progressed=progressed, backoff_s=backoff,
        )
        if verbose:
            print(
                f"supervisor: attempt {attempt} {kind} (exit {code}, "
                f"{'progress' if progressed else 'no progress'}) — "
                f"restart {total_restarts} in {backoff:.1f}s", flush=True,
            )
        sleep(backoff)
        backoff = min(backoff * policy.backoff_factor, policy.backoff_max)


def default_heartbeat_dir(model_dir: str | None) -> str:
    """``<model_dir>/hb`` when the job has a model dir, else a tmpdir."""
    if model_dir:
        return os.path.join(model_dir, "hb")
    return tempfile.mkdtemp(prefix="hvt-hb-")


def default_model_dir(env) -> str | None:
    """The progress-detection root: the job env's PS_MODEL_PATH, falling
    back to the launcher's own environment."""
    return (env or {}).get("PS_MODEL_PATH") or os.environ.get("PS_MODEL_PATH")


def default_log_path(env) -> str | None:
    """Where the restart journal lands by default: beside the checkpoints.
    The single resolver `run_job`'s stale-journal reset shares."""
    model_dir = default_model_dir(env)
    return os.path.join(model_dir, "restarts.jsonl") if model_dir else None


def _resolve_dirs(env, model_dir, heartbeat_dir, log_path, policy):
    """Shared CLI/YAML wiring: model dir from PS_MODEL_PATH, heartbeat dir
    exported to children, restart log defaulted beside the checkpoints."""
    env = dict(env or {})
    model_dir = model_dir or default_model_dir(env)
    if policy.heartbeat_timeout is not None:
        heartbeat_dir = heartbeat_dir or default_heartbeat_dir(model_dir)
        env[ENV_HEARTBEAT_DIR] = heartbeat_dir
    else:
        heartbeat_dir = None
    if log_path is None:
        log_path = default_log_path(env)
    return env, model_dir, heartbeat_dir, log_path


def supervise_local(
    nprocs: int,
    argv: list[str],
    env: dict[str, str] | None = None,
    policy: RestartPolicy | None = None,
    *,
    model_dir: str | None = None,
    heartbeat_dir: str | None = None,
    log_path: str | None = None,
    status_port: int | None = None,
    policy_config=None,
    tag_output: bool = True,
    sleep=time.sleep,
) -> int:
    """`launcher.start_local` under supervision (the ``launch run
    --max-restarts`` path)."""
    _refuse_policy(policy_config)
    refuse_unported_env(env)
    policy = policy or RestartPolicy()
    env, model_dir, heartbeat_dir, log_path = _resolve_dirs(
        env, model_dir, heartbeat_dir, log_path, policy
    )
    return supervise(
        lambda: launcher.start_local(
            nprocs, argv, env=env, tag_output=tag_output
        ),
        policy,
        model_dir=model_dir,
        heartbeat_dir=heartbeat_dir,
        log_path=log_path,
        status_port=status_port,
        sleep=sleep,
    )


def supervise_hosts(
    hosts: list[str],
    argv: list[str],
    env: dict[str, str] | None = None,
    policy: RestartPolicy | None = None,
    *,
    coordinator_port: int = 9981,
    nprocs_per_host: int = 1,
    workdir: str | None = None,
    model_dir: str | None = None,
    heartbeat_dir: str | None = None,
    log_path: str | None = None,
    status_port: int | None = None,
    policy_config=None,
    sleep=time.sleep,
) -> int:
    """`launcher.start_hosts` under supervision (the ``launch pod
    --max-restarts`` path).

    Multi-host caveats (each wants a filesystem shared with every host at
    the same paths): hang detection reads ``heartbeat_dir`` and progress
    detection walks ``model_dir`` on the LAUNCHER's filesystem; hang
    teardown reaches only the local ssh clients, so each relaunch dials a
    ROTATED coordinator port (base + attempt) — an orphan holding the old
    port cannot wedge every later attempt."""
    _refuse_policy(policy_config)
    refuse_unported_env(env)
    policy = policy or RestartPolicy()
    if (
        policy.heartbeat_timeout is not None
        and heartbeat_dir is None
        and default_model_dir(env) is None
    ):
        raise ValueError(
            "pod-mode hang detection (--heartbeat-timeout) needs a "
            "heartbeat dir on a filesystem shared with every host: set "
            "PS_MODEL_PATH to a shared mount (NFS/GCS-fuse) or pass "
            "heartbeat_dir= explicitly"
        )
    env, model_dir, heartbeat_dir, log_path = _resolve_dirs(
        env, model_dir, heartbeat_dir, log_path, policy
    )
    launches = {"n": 0}

    def start():
        port = coordinator_port + launches["n"]
        launches["n"] += 1
        return launcher.start_hosts(
            hosts, argv, env=env, coordinator_port=port, workdir=workdir,
            nprocs_per_host=nprocs_per_host,
        )

    return supervise(
        start,
        policy,
        model_dir=model_dir,
        heartbeat_dir=heartbeat_dir,
        log_path=log_path,
        status_port=status_port,
        sleep=sleep,
    )


def journal_records(journal_path: str | None) -> list:
    """Every parseable record of a supervisor journal, rotated ``.1``
    predecessor first. Torn tail lines are skipped; missing files read as
    an empty journal."""
    records: list = []
    if not journal_path:
        return records
    for part in (journal_path + ".1", journal_path):
        if not os.path.exists(part):
            continue
        with open(part) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail mid-append
    return records


def manifest_progress(model_dir: str | None) -> tuple:
    """Best committed ``(epoch, step, cumulative_step, steps_per_epoch)``
    readable from the checkpoint progress manifests under ``model_dir``
    (the port's ``.meta.json`` files, `checkpoint.save`).

    ``cumulative_step`` is ``epoch × steps_per_epoch + step`` when the
    manifest's stream cursor carries the epoch geometry, the raw
    within-epoch ``step`` otherwise. ``(-1, -1, -1, None)`` when nothing
    is readable. Per-file parses are memoized by stat signature
    (manifests are write-once via atomic rename)."""
    best = (-1, -1, -1, None)
    if not model_dir or not os.path.isdir(model_dir):
        return best
    seen = set()
    for root, _, files in os.walk(model_dir):
        for name in files:
            if not (name.endswith(".meta.json") or name == "index.json"):
                continue
            full = os.path.join(root, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            sig = (st.st_mtime_ns, st.st_size)
            seen.add(full)
            cached = _manifest_cache.get(full)
            if cached is not None and cached[0] == sig:
                parsed = cached[1]
            else:
                parsed = _parse_manifest(full, name)
                _manifest_cache[full] = (sig, parsed)
            if parsed is not None and parsed[:2] > best[:2]:
                best = parsed
    for stale in set(_manifest_cache) - seen:
        del _manifest_cache[stale]
    return best


# path -> ((mtime_ns, size), parsed tuple | None) — see manifest_progress.
_manifest_cache: dict = {}


def _parse_manifest(full: str, name: str):
    """(epoch, step, cumulative, steps_per_epoch) of one progress
    manifest, or None when unreadable/progress-free."""
    try:
        with open(full) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # torn manifest mid-write — skip, never crash
    prog = rec.get("progress")
    if isinstance(prog, dict):   # the JAX package's sharded index.json
        epoch, step = prog.get("epoch"), prog.get("step")
    elif name.endswith(".meta.json"):
        epoch, step = rec.get("epoch"), rec.get("step")
    else:
        return None
    if epoch is None or step is None:
        return None
    epoch, step = int(epoch), int(step)
    spe = ((rec.get("cursor") or {}).get("position") or {}).get(
        "steps_per_epoch"
    )
    total = epoch * int(spe) + step if spe else step
    return (epoch, step, total, int(spe) if spe else None)


def supervisor_metrics(log_path: str | None, budget=None,
                       model_dir: str | None = None) -> obs_core.Registry:
    """One scrape of the supervisor's pane of glass, as a FRESH obs
    registry (private per scrape): the restart journal →
    ``hvt_restarts_total`` / ``hvt_fleet_shrinks_total`` /
    ``hvt_fleet_grows_total`` / ``hvt_supervisor_gave_up_total`` /
    ``hvt_flight_dumps_total`` / ``hvt_policy_actions_total`` and the last
    settled generation/size; the checkpoint manifests under ``model_dir``
    → ``hvt_committed_epoch`` / ``hvt_committed_step``; ``budget`` (the
    loop's shared dict) → ``hvt_restart_budget_remaining``. The same
    journal, manifests and budget render the same bytes as the JAX
    package's scrape."""
    reg = obs_core.Registry()
    records = journal_records(log_path)
    restarts = gave_up = shrinks = grows = flight_dumps = 0
    policy_actions: dict = {}  # (action, outcome) -> count
    generation = size = None
    for rec in records:
        name = rec.get("name")
        if name == "restarts":
            restarts = int(rec.get("value", 0))
        elif name == "supervisor_gave_up":
            gave_up += 1
        elif name == "shrink":
            shrinks += 1
        elif name == "grow":
            grows += 1
        elif name == "flight_dump":
            flight_dumps += 1
        elif isinstance(name, str) and name.startswith("policy_"):
            key = (name[len("policy_"):],
                   str(rec.get("outcome", "applied")))
            policy_actions[key] = policy_actions.get(key, 0) + 1
        if name in ("start", "shrink", "grow", "steady"):
            generation = rec.get("generation")
            size = rec.get("size")
    reg.counter_set("hvt_restarts_total", restarts)
    reg.counter_set("hvt_fleet_shrinks_total", shrinks)
    reg.counter_set("hvt_fleet_grows_total", grows)
    reg.counter_set("hvt_supervisor_gave_up_total", gave_up)
    reg.counter_set("hvt_flight_dumps_total", flight_dumps)
    for (action, outcome), n in sorted(policy_actions.items()):
        reg.counter_set(
            "hvt_policy_actions_total", n, action=action, outcome=outcome,
        )
    epoch, step, total, _ = manifest_progress(model_dir)
    if generation is not None:
        reg.gauge("hvt_elastic_generation", generation)
    if size is not None:
        reg.gauge("hvt_fleet_size", size)
    if epoch >= 0:
        reg.gauge("hvt_committed_epoch", epoch)
        reg.gauge("hvt_committed_step", max(total, step))
    if budget:
        reg.gauge(
            "hvt_restart_budget_remaining",
            max(0, budget.get("max", 0) - budget.get("used", 0)),
        )
    return reg


def default_metrics_dump_path(model_dir: str | None,
                              log_path: str | None) -> str | None:
    """Where the final supervisor scrape lands: ``<model_dir>/metrics.prom``,
    else beside the journal. The single resolver the dump writer and
    `launch.job`'s ``metrics_checks:`` reader share."""
    root = model_dir or (os.path.dirname(log_path) if log_path else None)
    return os.path.join(root, "metrics.prom") if root else None


def dump_metrics(log_path: str | None, budget=None,
                 model_dir: str | None = None,
                 path: str | None = None) -> str | None:
    """Write one final text-exposition scrape (`default_metrics_dump_path`)
    so metrics survive the supervisor — the gateable job output
    ``metrics_checks:`` reads. Best-effort: a failed dump never changes
    the job's exit code (and a torn dump fails the gate loudly)."""
    if path is None:
        path = default_metrics_dump_path(model_dir, log_path)
        if path is None:
            return None
    try:
        text = obs_prom.render(supervisor_metrics(log_path, budget, model_dir))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        return path
    except OSError:
        return None


def start_status_server(port: int, log_path: str | None,
                        host: str | None = None, budget=None,
                        model_dir: str | None = None):
    """Serve the supervisor's own status over HTTP (the ``--status-port``
    surface). Binds loopback by default (``HVT_STATUS_HOST`` or ``host=``
    opt in to off-host: the routes are unauthenticated).

    Routes: ``GET /status`` → ``{"fleet": fleet_status(...),
    "coordinator": null}``; ``GET /journal`` → ``{"records": [...]}``;
    ``GET /healthz`` → ``{"status": "ok", "fleet": ...}``; ``GET
    /metrics`` → the `supervisor_metrics` exposition; ``GET /fleet`` →
    404 (the rollup is not ported: ROADMAP queue A item 13.5).

    Returns the started server (a daemon thread runs it); callers own
    ``shutdown()``. Port 0 binds an ephemeral port —
    ``server.server_address[1]`` carries the real one."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if host is None:
        host = registry.get_str("HVT_STATUS_HOST")

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # health probes are noise
            pass

        def do_GET(self):
            try:
                if self.path == "/metrics":
                    obs_prom.write_http(self, supervisor_metrics(
                        log_path, budget, model_dir))
                elif self.path == "/status":
                    self._send(200, {"fleet": fleet_status(log_path),
                                     "coordinator": None})
                elif self.path == "/journal":
                    self._send(200, {"records": journal_records(log_path)})
                elif self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "fleet": fleet_status(log_path)})
                elif self.path == "/fleet":
                    self._send(404, {"error": "no fleet rollup — not "
                                     f"ported yet ({ITEM_FLIGHT})"})
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except Exception as e:  # observability must never crash
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def fleet_status(journal_path: str | None, events: int = 8) -> dict:
    """Summarize a supervisor journal for health surfaces: generation/size
    (from the last settle record), restart/shrink/grow counts, and the
    trailing events. Tolerant of torn lines and of a missing file; reads
    across a `RestartLog` rotation."""
    status: dict = {
        "journal": journal_path, "generation": None, "size": None,
        "restarts": 0, "shrinks": 0, "grows": 0, "events": [],
    }
    if not journal_path or not (
        os.path.exists(journal_path)
        or os.path.exists(journal_path + ".1")
    ):
        status["error"] = "journal not found"
        return status
    records = journal_records(journal_path)
    for rec in records:
        name = rec.get("name")
        if name in ("start", "shrink", "grow", "steady"):
            status["generation"] = rec.get("generation")
            status["size"] = rec.get("size")
        if name == "restarts":
            status["restarts"] = int(rec.get("value", 0))
        elif name == "shrink":
            status["shrinks"] += 1
        elif name == "grow":
            status["grows"] += 1
    status["events"] = [
        {k: r.get(k) for k in
         ("name", "kind", "member", "generation", "size", "wall_time")
         if k in r}
        for r in records[-events:]
    ]
    return status


class ElasticPolicy:
    """Not ported: elastic supervision is ROADMAP queue A item 13.4."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ElasticPolicy is not ported yet — "
                                  f"{ITEM_ELASTIC}")

    @classmethod
    def from_mapping(cls, mapping):
        return cls()


def supervise_elastic(*args, **kwargs):
    """Not ported: ROADMAP queue A item 13.4."""
    raise NotImplementedError(f"supervise_elastic is not ported yet — "
                              f"{ITEM_ELASTIC}")


def supervise_elastic_hosts(*args, **kwargs):
    """Not ported: ROADMAP queue A item 13.4."""
    raise NotImplementedError(f"supervise_elastic_hosts is not ported yet "
                              f"— {ITEM_ELASTIC}")
