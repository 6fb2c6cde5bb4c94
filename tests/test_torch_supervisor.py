"""The port's restart supervisor (`horovod_tpu_torch.launch.supervisor`),
fault plans (`testing.faults`) and env-requested callbacks against the JAX
package's: ``classify``/``shell_code`` over every exit code from −15 to
255, ``RestartPolicy.from_mapping``, ``parse_plan`` over every kind and
malformed spec (same plan or same error), ``supervisor_metrics`` (byte-equal
exposition), ``fleet_status`` and ``journal_records`` over the same
journals and manifests; then ``tests/test_supervisor.py``'s
``TestSupervise`` through ``TestEnvWiring`` run against the port. Child
scripts import no torch; backoff sleeps are no-ops."""

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from horovod_tpu.launch import supervisor as jsup
from horovod_tpu.obs import prom as jprom
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.launch import ci_gate, launcher
from horovod_tpu_torch.launch import supervisor
from horovod_tpu_torch.launch.supervisor import RestartPolicy
from horovod_tpu_torch.obs import prom
from horovod_tpu_torch.testing import faults

NO_SLEEP = lambda s: None  # noqa: E731 — backoff without wall-clock


def _script(tmp_path, body, name="child.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def _start(argv, env=None):
    return lambda: launcher.start_local(1, argv, env=env, tag_output=False)


def _records(log_path):
    with open(log_path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- parity with the JAX package ---------------------------------------------


def test_classify_and_shell_code_match_jax_over_every_code():
    for code in range(-15, 256):
        for hang in (False, True):
            assert (supervisor.classify(code, hang=hang)
                    == jsup.classify(code, hang=hang)), code
        assert supervisor.shell_code(code) == jsup.shell_code(code), code


MAPPINGS = [
    {}, {"max_restarts": "5", "backoff": None, "heartbeat_timeout": 30},
    {"max_restarts": 0, "backoff": 0.0, "backoff_factor": 3,
     "backoff_max": 9, "startup_timeout": 2, "grace_seconds": 1,
     "oom_kill_budget": "1"},
    {"heartbeat_timeout": None, "startup_timeout": None},
    {"max_restart": 3}, {"backof": 1, "grace": 2},
    {"max_restarts": "two"}, {"backoff": [1]},
]


@pytest.mark.parametrize("mapping", MAPPINGS, ids=range(len(MAPPINGS)))
def test_restart_policy_from_mapping_matches_jax(mapping):
    def build(cls):
        try:
            return ("ok", vars(cls.from_mapping(dict(mapping))))
        except (TypeError, ValueError) as e:
            return (type(e).__name__, str(e))

    assert build(RestartPolicy) == build(jsup.RestartPolicy)


PLANS = [
    "0:1:kill", "1:3:hang", "2:0:leave", "0:2:exit1", "0:2:exit143",
    "3:1.5:leave", "0:0:corrupt", "0:1:corrupt@epoch3",
    "0:1:corrupt@shard1", "0:1:corrupt@epoch3/shard1", "0:1:reorder",
    "1:0:slow:50", "1:0:slow:0.5", "0:2:netdrop:300", "0:2:dataslow:20",
    "0:30:hostdown",
    # malformed
    "0:1", "", "a:1:kill", "0:b:kill", "0:1:explode", "0:1:exitX",
    "0:1.x:kill", "0:1.0:kill", "0:1.-2:kill", "0:1:slow:", "0:1:slow:-5",
    "0:1:netdrop:abc", "0:1:corrupt@", "0:1:corrupt@epochX",
    "0:1:corrupt@epoch1/disk2", "0:1:", "::", "0:1:exit",
]


@pytest.mark.parametrize("spec", PLANS)
def test_parse_plan_matches_jax(spec):
    def parse(mod):
        try:
            p = mod.parse_plan(spec)
            return ("ok", p.rank, p.epoch, p.kind, p.step, p.exit_code,
                    p.slow_ms, p.netdrop_ms, p.dataslow_ms)
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(faults) == parse(jfaults)


def _journal(tmp_path, seed):
    """A journal of every record kind the metrics and status read, with a
    rotated predecessor and a torn tail, from a numpy seed."""
    rng = np.random.default_rng(seed)
    log = supervisor.RestartLog(str(tmp_path / f"j{seed}.jsonl"),
                                max_lines=int(rng.integers(3, 7)))
    restarts = 0
    for i in range(int(rng.integers(6, 14))):
        kind = str(rng.choice(["restarts", "supervisor_gave_up", "shrink",
                               "grow", "flight_dump", "policy_evict",
                               "policy_warn", "start", "steady"]))
        fields = {"attempt": i, "kind": str(rng.choice(["crash", "hang"])),
                  "generation": int(rng.integers(1, 5)),
                  "size": int(rng.integers(1, 4))}
        if kind == "restarts":
            restarts += 1
        if kind.startswith("policy_") and rng.random() < 0.5:
            fields["outcome"] = str(rng.choice(["dry-run", "applied"]))
        log.write(kind, float(restarts), **fields)
    with open(log.path, "a") as f:
        f.write('{"name": "restarts", "val')
    return log.path


def _manifests(tmp_path, seed):
    """Checkpoint manifests as the port writes them (some with a stream
    cursor, one torn) under a model dir."""
    rng = np.random.default_rng(seed)
    d = tmp_path / f"models{seed}" / "horovod-mnist"
    d.mkdir(parents=True)
    spe = int(rng.integers(5, 500))
    for epoch in range(1, int(rng.integers(2, 5))):
        meta = {"epoch": epoch, "step": int(rng.integers(0, 3)),
                "payload_sha256": "0" * 64}
        if rng.random() < 0.7:
            meta["cursor"] = {"format": 1, "kind": "fit", "seed": 0,
                              "epoch": epoch, "step": meta["step"],
                              "position": {"steps_per_epoch": spe}}
        (d / f"checkpoint-{epoch}.pt.meta.json").write_text(
            json.dumps(meta))
    (d / "checkpoint-99.pt.meta.json").write_text('{"epoch": 9')  # torn
    return str(d.parent)


@pytest.mark.parametrize("seed", range(6))
def test_supervisor_metrics_byte_equal_to_jax(tmp_path, seed):
    log = _journal(tmp_path, seed)
    model_dir = _manifests(tmp_path, seed)
    budget = {"max": 3, "used": seed % 4}
    for args in ((log, budget, model_dir), (log, None, None),
                 (None, budget, model_dir)):
        t = prom.render(supervisor.supervisor_metrics(
            args[0], budget=args[1], model_dir=args[2]))
        j = jprom.render(jsup.supervisor_metrics(
            args[0], budget=args[1], model_dir=args[2]))
        assert t == j
    assert supervisor.manifest_progress(model_dir) == \
        jsup.manifest_progress(model_dir)


@pytest.mark.parametrize("seed", range(6))
def test_fleet_status_and_journal_records_match_jax(tmp_path, seed):
    log = _journal(tmp_path, seed)
    assert supervisor.journal_records(log) == jsup.journal_records(log)
    for events in (3, 8):
        assert (supervisor.fleet_status(log, events)
                == jsup.fleet_status(log, events))
    missing = str(tmp_path / "missing.jsonl")
    assert supervisor.fleet_status(missing) == jsup.fleet_status(missing)
    assert supervisor.journal_records(None) == jsup.journal_records(None)


# -- behaviour (tests/test_supervisor.py, run against the port) --------------


class TestSupervise:
    def test_success_needs_no_restart(self, tmp_path):
        log = tmp_path / "restarts.jsonl"
        code = supervisor.supervise(
            _start(_script(tmp_path, "raise SystemExit(0)")),
            RestartPolicy(max_restarts=3), log_path=str(log), sleep=NO_SLEEP)
        assert code == 0
        assert log.exists() and _records(log) == []

    def test_crash_loop_exhausts_budget_with_original_code(self, tmp_path):
        log = tmp_path / "restarts.jsonl"
        code = supervisor.supervise(
            _start(_script(tmp_path, "raise SystemExit(7)")),
            RestartPolicy(max_restarts=2, backoff=0.0),
            model_dir=str(tmp_path / "models"), log_path=str(log),
            sleep=NO_SLEEP)
        assert code == 7
        records = _records(log)
        restarts = [r for r in records if r["name"] == "restarts"]
        assert [r["value"] for r in restarts] == [1, 2]
        assert all(r["kind"] == "crash" and r["exit_code"] == 7
                   for r in restarts)
        assert records[-1]["name"] == "supervisor_gave_up"
        assert records[-1]["exit_code"] == 7
        # The final scrape landed beside the journal.
        dump = prom.parse_text(
            (tmp_path / "models" / "metrics.prom").read_text())
        assert dump["hvt_restarts_total"] == 2
        assert dump["hvt_supervisor_gave_up_total"] == 1
        assert dump["hvt_restart_budget_remaining"] == 0

    def test_progress_spares_the_budget(self, tmp_path):
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        log = tmp_path / "restarts.jsonl"
        argv = _script(tmp_path, f"""
            import os, sys
            md = {str(model_dir)!r}
            n = len([f for f in os.listdir(md) if f.startswith('checkpoint')])
            if n >= 4:
                sys.exit(0)
            open(os.path.join(md, f'checkpoint-{{n + 1}}.pt'), 'w').close()
            sys.exit(1)
        """)
        code = supervisor.supervise(
            _start(argv), RestartPolicy(max_restarts=1, backoff=0.0),
            model_dir=str(model_dir), log_path=str(log), sleep=NO_SLEEP)
        assert code == 0
        restarts = [r for r in _records(log) if r["name"] == "restarts"]
        assert len(restarts) == 4 and all(r["progressed"] for r in restarts)

    def test_checkpoint_mtime_counts_as_progress(self, tmp_path):
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        ckpt = model_dir / "checkpoint-1.pt"
        ckpt.write_bytes(b"a")
        before = supervisor.newest_checkpoint_marker(str(model_dir))
        os.utime(ckpt, (time.time() + 5, time.time() + 5))
        assert supervisor.newest_checkpoint_marker(str(model_dir)) != before

    def test_preemption_classified(self, tmp_path):
        stamp = tmp_path / "fired"
        log = tmp_path / "restarts.jsonl"
        argv = _script(tmp_path, f"""
            import os, sys
            if os.path.exists({str(stamp)!r}):
                sys.exit(0)
            open({str(stamp)!r}, 'w').close()
            sys.exit(143)
        """)
        code = supervisor.supervise(
            _start(argv), RestartPolicy(max_restarts=2, backoff=0.0),
            log_path=str(log), sleep=NO_SLEEP)
        assert code == 0
        restarts = [r for r in _records(log) if r["name"] == "restarts"]
        assert [r["kind"] for r in restarts] == ["preemption"]

    def test_oom_kill_budget_gives_up_first(self, tmp_path):
        log = tmp_path / "restarts.jsonl"
        code = supervisor.supervise(
            _start(_script(tmp_path, "import os, signal; "
                           "os.kill(os.getpid(), signal.SIGKILL)")),
            RestartPolicy(max_restarts=5, backoff=0.0, oom_kill_budget=1),
            log_path=str(log), sleep=NO_SLEEP)
        assert code == 137
        records = _records(log)
        assert [r["name"] for r in records] == ["restarts",
                                                "supervisor_gave_up"]
        assert records[-1]["budget"] == "oom-kill"

    def test_backoff_grows_and_resets_on_progress(self, tmp_path):
        sleeps = []
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        argv = _script(tmp_path, f"""
            import os, sys
            md = {str(model_dir)!r}
            c = os.path.join(md, 'count')
            n = int(open(c).read()) if os.path.exists(c) else 0
            open(c, 'w').write(str(n + 1))
            if n < 3:
                sys.exit(1)
            if n == 3:
                open(os.path.join(md, 'checkpoint-1.pt'), 'w').close()
                sys.exit(1)
            sys.exit(0)
        """)
        code = supervisor.supervise(
            _start(argv),
            RestartPolicy(max_restarts=5, backoff=1.0, backoff_factor=2.0),
            model_dir=str(model_dir), sleep=sleeps.append)
        assert code == 0
        assert sleeps == [1.0, 2.0, 4.0, 1.0]

    def test_hang_detected_killed_and_restarted(self, tmp_path):
        stamp = tmp_path / "fired"
        hb_dir = tmp_path / "hb"
        log = tmp_path / "restarts.jsonl"
        argv = _script(tmp_path, f"""
            import os, sys, time
            if os.path.exists({str(stamp)!r}):
                sys.exit(0)
            open({str(stamp)!r}, 'w').close()
            hb = os.environ['HVT_HEARTBEAT_DIR']
            os.makedirs(hb, exist_ok=True)
            open(os.path.join(hb, 'rank-0'), 'w').close()
            time.sleep(300)  # wedged: alive, no exit code, no beats
        """)
        code = supervisor.supervise(
            _start(argv, env={"HVT_HEARTBEAT_DIR": str(hb_dir)}),
            RestartPolicy(max_restarts=2, backoff=0.0,
                          heartbeat_timeout=1.0, grace_seconds=2.0),
            heartbeat_dir=str(hb_dir), log_path=str(log), sleep=NO_SLEEP)
        assert code == 0
        restarts = [r for r in _records(log) if r["name"] == "restarts"]
        assert [r["kind"] for r in restarts] == ["hang"]

    def test_never_beating_fleet_killed_after_startup_timeout(self,
                                                              tmp_path):
        stamp = tmp_path / "fired"
        hb_dir = tmp_path / "hb"
        log = tmp_path / "restarts.jsonl"
        argv = _script(tmp_path, f"""
            import os, sys, time
            if os.path.exists({str(stamp)!r}):
                sys.exit(0)
            open({str(stamp)!r}, 'w').close()
            time.sleep(300)  # wedged pre-fit: never beats
        """)
        code = supervisor.supervise(
            _start(argv),
            RestartPolicy(max_restarts=2, backoff=0.0, heartbeat_timeout=2.0,
                          startup_timeout=0.6, grace_seconds=2.0),
            heartbeat_dir=str(hb_dir), log_path=str(log), sleep=NO_SLEEP)
        assert code == 0
        restarts = [r for r in _records(log) if r["name"] == "restarts"]
        assert [r["kind"] for r in restarts] == ["hang"]

    def test_stale_beats_cleared_between_launches(self, tmp_path):
        hb_dir = tmp_path / "hb"
        hb_dir.mkdir()
        old = hb_dir / "rank-0"
        old.write_text("")
        os.utime(old, (1, 1))  # ancient — stale by any timeout
        code = supervisor.supervise(
            _start(_script(tmp_path, "import time; time.sleep(1)")),
            RestartPolicy(max_restarts=0, heartbeat_timeout=1.0),
            heartbeat_dir=str(hb_dir), sleep=NO_SLEEP)
        assert code == 0

    def test_staleness_is_clock_skew_immune(self, tmp_path):
        hb = tmp_path / "hb"
        hb.mkdir()
        beat = hb / "rank-0"
        beat.write_text("")
        os.utime(beat, (1, 1))  # skewed far into the past
        assert supervisor.heartbeats_stale(str(hb), 5.0)
        abort = supervisor._throttled_staleness_check(
            str(hb), timeout=1.0, startup_timeout=60.0)
        t_end = time.monotonic() + 1.6
        tick = 2
        while time.monotonic() < t_end:
            assert not abort(), "skewed-but-live beats judged hung"
            os.utime(beat, (tick, tick))
            tick += 1
            time.sleep(0.3)

    def test_abort_hook_detects_stopped_beats(self, tmp_path):
        hb = tmp_path / "hb"
        hb.mkdir()
        (hb / "rank-0").write_text("")
        abort = supervisor._throttled_staleness_check(
            str(hb), timeout=1.0, startup_timeout=60.0)
        assert not abort()
        deadline = time.monotonic() + 10
        while not abort():
            assert time.monotonic() < deadline, "never detected the stop"
            time.sleep(0.1)

    def test_heartbeats_stale_semantics(self, tmp_path):
        hb = tmp_path / "hb"
        assert not supervisor.heartbeats_stale(str(hb), 0.1)
        hb.mkdir()
        assert not supervisor.heartbeats_stale(str(hb), 0.1)
        beat = hb / "rank-0"
        beat.write_text("")
        assert not supervisor.heartbeats_stale(str(hb), 60.0)
        old = hb / "rank-1"
        old.write_text("")
        os.utime(old, (1, 1))
        assert not supervisor.heartbeats_stale(str(hb), 60.0)
        os.utime(beat, (1, 1))
        assert supervisor.heartbeats_stale(str(hb), 60.0)

    @pytest.mark.parametrize("env,item", [
        ({"HVT_FLIGHT_RECORD": "/tmp/f"}, "13.5"),
        ({"HVT_METRICS_PORT": "0"}, "13.5"),
        ({"HVT_POLICY": "dry-run"}, "13.6")])
    def test_unported_env_refused_before_launch(self, tmp_path, env, item):
        marker = tmp_path / "ran"
        with pytest.raises(NotImplementedError, match=item):
            supervisor.supervise_local(
                1, [sys.executable, "-c",
                    f"open({str(marker)!r}, 'w').close()"], env=env,
                log_path=str(tmp_path / "j.jsonl"), sleep=NO_SLEEP)
        assert not marker.exists()

    def test_unported_supervision_refused(self, tmp_path):
        with pytest.raises(NotImplementedError, match="13.6"):
            supervisor.supervise(lambda: None, policy_config=object())
        with pytest.raises(NotImplementedError, match="13.4"):
            supervisor.ElasticPolicy.from_mapping({"min_ranks": 1})
        for fn in (supervisor.supervise_elastic,
                   supervisor.supervise_elastic_hosts):
            with pytest.raises(NotImplementedError, match="13.4"):
                fn(1, ["true"])


class TestRestartPolicyMapping:
    def test_partial_mapping_and_none_skip(self):
        p = RestartPolicy.from_mapping(
            {"max_restarts": "5", "backoff": None, "heartbeat_timeout": 30})
        assert p.max_restarts == 5
        assert p.backoff == RestartPolicy().backoff
        assert p.heartbeat_timeout == 30.0

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown restart policy"):
            RestartPolicy.from_mapping({"max_restart": 3})


class TestRestartLogRotation:
    def test_rotates_at_max_lines_keeping_one_predecessor(self, tmp_path):
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"), max_lines=3)
        for i in range(8):
            log.write("restarts", float(i + 1), attempt=i + 1)
        live, prev = _records(log.path), _records(log.path + ".1")
        assert len(prev) == 3
        assert [r["value"] for r in prev + live] == [4.0, 5.0, 6.0, 7.0, 8.0]

    def test_rotates_at_max_bytes(self, tmp_path):
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"), max_lines=0,
                                    max_bytes=1)
        log.write("restarts", 1.0)
        log.write("restarts", 2.0)
        assert os.path.exists(log.path + ".1")

    def test_env_zero_disables_rotation(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVT_RESTART_LOG_MAX_LINES", "0")
        monkeypatch.setenv("HVT_RESTART_LOG_MAX_MB", "0")
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"))
        for i in range(50):
            log.write("restarts", float(i))
        assert not os.path.exists(log.path + ".1")
        assert len(_records(log.path)) == 50

    def test_ci_gate_counts_across_rotation(self, tmp_path):
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"), max_lines=2)
        for i in range(5):
            log.write("shrink", float(i + 1), generation=i)
        ok, value = ci_gate.check_metrics(str(log.path), "shrink",
                                          (3.0, 3.0), how="count")
        assert ok and value == 3.0

    def test_fleet_status_reads_across_rotation(self, tmp_path):
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"), max_lines=2)
        log.write("start", 3.0, generation=1, size=3)
        log.write("restarts", 1.0, member="m1", kind="leave")
        log.write("shrink", 2.0, generation=2, size=2)
        assert os.path.exists(log.path + ".1")
        status = supervisor.fleet_status(log.path)
        assert status["generation"] == 2 and status["size"] == 2
        assert status["restarts"] == 1 and status["shrinks"] == 1
        assert [e["name"] for e in status["events"]] == [
            "start", "restarts", "shrink"]

    def test_status_server_routes_and_loopback_default(self, tmp_path):
        log = supervisor.RestartLog(str(tmp_path / "j.jsonl"))
        log.write("restarts", 1.0, kind="crash")
        budget = {"max": 3, "used": 1}
        server = supervisor.start_status_server(0, log.path, budget=budget)
        try:
            bound_host, port = server.server_address[:2]
            assert bound_host == "127.0.0.1"

            def get(route):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{route}", timeout=5) as r:
                    return r.read().decode()

            status = json.loads(get("/status"))
            assert status["fleet"]["restarts"] == 1
            assert status["coordinator"] is None
            records = json.loads(get("/journal"))["records"]
            assert [r["name"] for r in records] == ["restarts"]
            assert json.loads(get("/healthz"))["status"] == "ok"
            metrics = prom.parse_text(get("/metrics"))
            assert metrics["hvt_restarts_total"] == 1
            assert metrics["hvt_restart_budget_remaining"] == 2
            with pytest.raises(urllib.error.HTTPError) as e:
                get("/fleet")
            assert e.value.code == 404
        finally:
            server.shutdown()
            server.server_close()


class TestFleet:
    def test_abort_terminates_and_marks(self):
        proc = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(60)"])
        fleet = launcher.Fleet([proc])
        t0 = time.monotonic()
        code = fleet.wait(grace_seconds=30.0, abort=lambda: True)
        assert time.monotonic() - t0 < 15
        assert fleet.aborted
        assert proc.returncode is not None and proc.returncode != 0
        assert code != 0

    def test_abort_not_consulted_after_failure(self):
        dead = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
        dead.wait()
        slow = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(0.5)"])
        calls = []

        def abort():
            calls.append(1)
            return True

        fleet = launcher.Fleet([dead, slow])
        assert fleet.wait(grace_seconds=30.0, abort=abort) == 3
        assert not fleet.aborted
        assert slow.returncode == 0


class TestFaultPlan:
    def test_parse_kinds(self):
        plan = faults.parse_plan("1:3:kill")
        assert (plan.rank, plan.epoch, plan.kind) == (1, 3, "kill")
        assert plan.exit_code is None
        assert faults.parse_plan("0:2:exit143").exit_code == 143
        assert faults.parse_plan("2:1.5:leave").step == 5

    @pytest.mark.parametrize("spec,item", [
        ("0:1:reorder", "13.5"), ("0:1:netdrop:50", "13.7"),
        ("0:1:dataslow:50", "13.7"), ("0:1:corrupt@shard1", "13.3"),
        ("0:1:corrupt@epoch2/shard0", "13.3")])
    def test_unported_kinds_refused_by_from_env(self, monkeypatch, spec,
                                                item):
        monkeypatch.setenv("HVT_FAULT", spec)
        with pytest.raises(NotImplementedError, match=item):
            faults.FaultInjectionCallback.from_env()

    @pytest.mark.parametrize("spec", ["0:1:kill", "0:1:hang", "0:1:leave",
                                      "0:1:exit3", "0:1:slow:5",
                                      "0:1:hostdown", "0:1:corrupt",
                                      "0:1:corrupt@epoch1"])
    def test_ported_kinds_build(self, monkeypatch, tmp_path, spec):
        monkeypatch.setenv("HVT_FAULT", spec)
        monkeypatch.setenv("HVT_FAULT_STAMP", str(tmp_path / "s"))
        cb = faults.FaultInjectionCallback.from_env()
        assert cb.plan.kind == spec.split(":", 2)[2]
        assert cb.stamp == str(tmp_path / "s")

    def test_step_filter_fires_at_or_past_target(self, monkeypatch):
        fired = []
        cb = faults.FaultInjectionCallback(faults.parse_plan("0:1.3:kill"))
        monkeypatch.setattr(cb, "_fire", lambda: fired.append(1))
        cb.on_epoch_begin(1)
        cb.on_batch_end(0)
        cb.on_batch_end(1)
        assert not fired
        cb.on_batch_end(4)
        assert len(fired) == 1

    def test_step_filter_does_not_refire_on_resumed_run(self, monkeypatch):
        fired = []
        cb = faults.FaultInjectionCallback(faults.parse_plan("0:1.3:kill"))
        monkeypatch.setattr(cb, "_fire", lambda: fired.append(1))
        cb.set_trainer(SimpleNamespace(_resume_epoch=1, _resume_step=3))
        cb.on_epoch_begin(1)
        cb.on_batch_end(3)
        cb.on_batch_end(4)
        assert not fired
        cb.set_trainer(SimpleNamespace(_resume_epoch=1, _resume_step=1))
        cb.on_batch_end(2)
        assert len(fired) == 1

    def test_callback_gates_on_rank_epoch_and_stamp(self, tmp_path,
                                                    monkeypatch):
        fired = []
        cb = faults.FaultInjectionCallback(faults.parse_plan("0:1:exit1"),
                                           stamp=str(tmp_path / "stamp"))
        monkeypatch.setattr(cb, "_fire", lambda: fired.append(1))
        cb.on_epoch_begin(0)
        cb.on_batch_end(0)
        assert not fired
        cb.on_epoch_begin(1)
        cb.on_batch_end(0)
        assert len(fired) == 1 and (tmp_path / "stamp").exists()
        cb.on_batch_end(1)
        assert len(fired) == 1

    def test_wrong_rank_does_not_fire(self, monkeypatch):
        fired = []
        cb = faults.FaultInjectionCallback(faults.parse_plan("5:0:kill"))
        monkeypatch.setattr(cb, "_fire", lambda: fired.append(1))
        cb.on_epoch_begin(0)
        cb.on_batch_end(0)
        assert not fired

    def test_slow_recurs_from_the_target_epoch(self, monkeypatch):
        naps = []
        monkeypatch.setattr(faults.time, "sleep", naps.append)
        cb = faults.FaultInjectionCallback(faults.parse_plan("0:1:slow:20"))
        cb.on_epoch_begin(0)
        cb.on_batch_end(0)
        cb.on_epoch_begin(1)
        cb.on_batch_end(0)
        cb.on_epoch_begin(2)
        cb.on_batch_end(0)
        assert naps == [0.02, 0.02]

    def test_corrupt_damages_the_payload_not_its_sidecars(self, tmp_path):
        d = tmp_path / "run"
        d.mkdir()
        for e in (1, 2):
            (d / f"checkpoint-{e}.pt").write_bytes(bytes(range(64)) * 4)
            (d / f"checkpoint-{e}.pt.sha256").write_text("x\n")
            (d / f"checkpoint-{e}.pt.meta.json").write_text("{}")
            os.utime(d / f"checkpoint-{e}.pt", (e, e))
        assert faults.newest_checkpoint_file(str(tmp_path)) == \
            str(d / "checkpoint-2.pt")
        target = faults.newest_checkpoint_file(str(tmp_path), epoch=1)
        assert target == str(d / "checkpoint-1.pt")
        faults.corrupt_file(target)
        data = (d / "checkpoint-1.pt").read_bytes()
        assert len(data) == 128 and data[0] == 0xFF
        assert (d / "checkpoint-1.pt.meta.json").read_text() == "{}"

    def test_host_pid_registry_sweeps_dead_pids(self, tmp_path):
        pid_dir = str(tmp_path / "h0")
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait()
        os.makedirs(pid_dir)
        open(os.path.join(pid_dir, str(dead.pid)), "w").close()
        assert faults.host_pids(pid_dir) == [dead.pid]
        faults.register_host_pid(pid_dir)  # sweeps the dead one
        assert faults.host_pids(pid_dir) == [os.getpid()]


class TestEnvWiring:
    def test_env_callbacks_off_by_default(self, monkeypatch):
        from horovod_tpu_torch.training import callbacks as cb_lib

        monkeypatch.delenv("HVT_HEARTBEAT_DIR", raising=False)
        monkeypatch.delenv("HVT_FAULT", raising=False)
        assert cb_lib.env_callbacks() == []

    def test_env_callbacks_install_heartbeat_and_fault(self, tmp_path,
                                                       monkeypatch):
        from horovod_tpu_torch.training import callbacks as cb_lib

        monkeypatch.setenv("HVT_HEARTBEAT_DIR", str(tmp_path / "hb"))
        monkeypatch.setenv("HVT_FAULT", "0:2:hang")
        cbs = cb_lib.env_callbacks()
        assert [type(c).__name__ for c in cbs] == [
            "HeartbeatCallback", "FaultInjectionCallback"]
        assert cbs[1].plan.epoch == 2

    def test_heartbeat_callback_touches_rank_file(self, tmp_path):
        from horovod_tpu_torch.training.callbacks import HeartbeatCallback

        cb = HeartbeatCallback(str(tmp_path / "hb"), interval=0.0)
        cb.on_train_begin()
        beat = tmp_path / "hb" / "rank-0"
        assert beat.exists()
        first = beat.stat().st_mtime_ns
        time.sleep(0.05)
        cb.on_batch_end(0)
        assert beat.stat().st_mtime_ns > first

    def test_heartbeat_throttles_batch_beats(self, tmp_path):
        from horovod_tpu_torch.training.callbacks import HeartbeatCallback

        cb = HeartbeatCallback(str(tmp_path / "hb"), interval=3600.0)
        cb.on_train_begin()
        beat = tmp_path / "hb" / "rank-0"
        first = beat.stat().st_mtime_ns
        time.sleep(0.05)
        cb.on_batch_end(0)
        assert beat.stat().st_mtime_ns == first
        cb.on_epoch_end(0)
        assert beat.stat().st_mtime_ns > first
