"""The port's launch layer (`horovod_tpu_torch.launch`): local and ssh
launchers, the fail-stop wait, job specs and the supervised CLI — the
supervisor-free cases of ``tests/test_launch.py`` run against the port,
``validate_spec`` against the JAX package's on the same specs, ``pod
--nprocs-per-host`` rank mapping, and every refusal naming its ROADMAP
item before a process is spawned. Child scripts import no torch."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from horovod_tpu.launch import job as jjob
from horovod_tpu_torch.launch import job as tjob
from horovod_tpu_torch.launch import launcher, specfile

PY = sys.executable


def _write_metrics(path, values, name="loss"):
    with open(path, "w") as f:
        for i, v in enumerate(values):
            f.write(json.dumps({"name": name, "value": v, "step": i}) + "\n")


def _spec(tmp_path, text, name="job.yaml"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return str(p)


class TestRunLocal:
    def test_single_process_gets_a_rendezvous(self, tmp_path):
        """The port's kept difference: a launched world of one rank has a
        process group, so its child gets the rendezvous."""
        out = tmp_path / "env.json"
        code = launcher.run_local(1, [PY, "-c", textwrap.dedent(f"""
            import json, os
            json.dump({{k: v for k, v in os.environ.items()
                       if k.startswith('HVT_')}}, open({str(out)!r}, 'w'))
        """)], tag_output=False)
        assert code == 0
        env = json.load(open(out))
        assert env["HVT_NUM_PROCESSES"] == "1"
        assert env["HVT_PROCESS_ID"] == env["HVT_LOCAL_RANK"] == "0"
        assert env["HVT_COORDINATOR_ADDRESS"].startswith("127.0.0.1:")

    def test_multi_process_env_assignment(self, tmp_path):
        code = launcher.run_local(3, [PY, "-c", textwrap.dedent(f"""
            import os
            rank = os.environ['HVT_PROCESS_ID']
            assert os.environ['HVT_NUM_PROCESSES'] == '3'
            assert os.environ['HVT_LOCAL_RANK'] == rank
            assert os.environ['HVT_COORDINATOR_ADDRESS'].startswith('127.0.0.1:')
            open(os.path.join({str(tmp_path)!r}, f'rank-{{rank}}'), 'w').close()
        """)], tag_output=False)
        assert code == 0
        assert sorted(p.name for p in tmp_path.glob("rank-*")) == [
            "rank-0", "rank-1", "rank-2"]

    def test_coordinator_port_is_used(self, tmp_path):
        out = tmp_path / "addr"
        code = launcher.run_local(
            1, [PY, "-c", "import os; open(%r, 'w').write(os.environ["
                "'HVT_COORDINATOR_ADDRESS'])" % str(out)],
            coordinator_port=47123, tag_output=False)
        assert code == 0 and out.read_text() == "127.0.0.1:47123"

    def test_failure_propagates(self):
        code = launcher.run_local(
            2, [PY, "-c", "import os,sys; sys.exit(int(os.environ["
                "'HVT_PROCESS_ID']) * 7)"], tag_output=False)
        assert code == 7  # fail-stop: any rank's nonzero code surfaces


class TestJob:
    def test_job_runs_and_gates(self, tmp_path):
        metrics = tmp_path / "metrics.jsonl"
        writer = (
            "import json;"
            f"f=open({str(metrics)!r},'w');"
            "[f.write(json.dumps({'name':'loss','value':v})+'\\n') "
            "for v in (0.25,0.1)]"
        )
        spec = _spec(tmp_path, f"""
            name: test-job
            job:
              command: ["{PY}", "-c", {json.dumps(writer)}]
              nprocs: 1
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
                aggregate: mean
        """)
        assert tjob.run_job(spec) == 0
        spec2 = _spec(tmp_path, open(spec).read().replace("0.0..0.3",
                                                          "0.0..0.05"),
                      "job2.yaml")
        assert tjob.run_job(spec2) == 1

    def test_job_status_port_requires_supervision(self, tmp_path, capsys):
        spec = _spec(tmp_path, f"""
            name: test-job
            job:
              command: ["{PY}", "-c", "pass"]
              nprocs: 1
              status_port: 9967
        """)
        assert tjob.run_job(spec) == 1
        assert "status_port" in capsys.readouterr().out

    def test_job_fresh_wipes_model_dir(self, tmp_path):
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        (model_dir / "checkpoint-6.pt").write_bytes(b"stale")
        metrics = tmp_path / "metrics.jsonl"
        writer = ("import json;"
                  f"open({str(metrics)!r},'w').write("
                  "json.dumps({'name':'loss','value':0.1}) + '\\n')")
        spec = _spec(tmp_path, f"""
            name: fresh-job
            job:
              fresh: true
              command: ["{PY}", "-c", {json.dumps(writer)}]
              nprocs: 1
              env:
                PS_MODEL_PATH: {model_dir}
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
        """)
        assert tjob.run_job(spec) == 0
        assert not (model_dir / "checkpoint-6.pt").exists()

    def test_job_fresh_refuses_suspicious_dir(self, tmp_path):
        spec = _spec(tmp_path, """
            name: fresh-bad
            job:
              fresh: true
              command: ["true"]
              env:
                PS_MODEL_PATH: /
        """)
        assert tjob.run_job(spec) == 1
        assert (tmp_path / "job.yaml").exists()  # nothing was wiped

    def test_job_resets_stale_metrics(self, tmp_path):
        metrics = tmp_path / "metrics.jsonl"
        _write_metrics(metrics, [0.01, 0.01])  # stale, would pass
        spec = _spec(tmp_path, f"""
            name: stale
            job:
              command: ["{PY}", "-c", "pass"]
              nprocs: 1
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
        """)
        assert tjob.run_job(spec) == 1

    def test_job_restart_block_supervises_and_logs(self, tmp_path):
        """`restart:` routes through the supervisor: a one-shot failure is
        restarted and journaled, the rerun passes the gate, a stale
        journal is reset first, and the journal and metrics gates read
        this run's records."""
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        log = model_dir / "restarts.jsonl"
        log.write_text('{"name": "restarts", "value": 9}\n')  # stale
        metrics = tmp_path / "metrics.jsonl"
        stamp = tmp_path / "fired"
        body = (
            "import json, os, sys;"
            f"s = {str(stamp)!r};"
            "fired = os.path.exists(s);"
            "open(s, 'w').close();"
            "(sys.exit(3) if not fired else None);"
            f"open({str(metrics)!r}, 'w').write("
            "json.dumps({'name': 'loss', 'value': 0.1}) + '\\n')"
        )
        spec = _spec(tmp_path, f"""
            name: supervised-job
            job:
              command: ["{PY}", "-c", {json.dumps(body)}]
              nprocs: 1
              restart:
                max_restarts: 2
                backoff: 0.0
              env:
                PS_MODEL_PATH: {model_dir}
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
            journal_checks:
              restarts:
                target: "1..1"
                aggregate: count
            metrics_checks:
              hvt_restarts_total:
                target: "1..1"
        """)
        assert tjob.run_job(spec) == 0
        records = [json.loads(line) for line in log.read_text().splitlines()]
        assert len(records) == 1  # stale journal was reset
        assert records[0]["name"] == "restarts"
        assert records[0]["exit_code"] == 3

    def test_job_empty_restart_block_supervises_with_defaults(self,
                                                              tmp_path):
        model_dir = tmp_path / "models"
        model_dir.mkdir()
        spec = _spec(tmp_path, f"""
            name: default-supervised
            job:
              command: ["{PY}", "-c", "pass"]
              nprocs: 1
              restart:
              env:
                PS_MODEL_PATH: {model_dir}
        """)
        assert tjob.run_job(spec) == 0
        assert (model_dir / "restarts.jsonl").exists()
        assert (model_dir / "metrics.prom").exists()

    def test_job_non_mapping_restart_rejected(self, tmp_path):
        spec = _spec(tmp_path, f"""
            name: bad-restart
            job:
              command: ["{PY}", "-c", "pass"]
              nprocs: 1
              restart: true
        """)
        assert tjob.run_job(spec) == 1

    def test_job_restart_block_exhausts_budget(self, tmp_path):
        spec = _spec(tmp_path, f"""
            name: doomed-job
            job:
              command: ["{PY}", "-c", "raise SystemExit(9)"]
              nprocs: 1
              restart:
                max_restarts: 1
                backoff: 0.0
        """)
        assert tjob.run_job(spec) == 9

    def test_journal_and_metrics_checks_need_supervision(self, tmp_path,
                                                         capsys):
        for block in ("journal_checks:\n  restarts:\n    target: '0..0'\n",
                      "metrics_checks:\n  hvt_restarts_total:\n"
                      "    target: '0..0'\n"):
            spec = _spec(tmp_path, f"job:\n  command: ['{PY}', '-c', "
                         f"'pass']\n{block}")
            assert tjob.run_job(spec) == 1
            assert "needs a restart: block" in capsys.readouterr().out


PLAIN_SPECS = [
    {"job": {"command": "python x.py", "nprocs": 2}},
    {"job": {"command": ["python", "x.py"], "restart": None}},
    {"job": {"command": "x", "restart": {"max_restarts": 2, "backoff": 1,
                                         "heartbeat_timeout": 60,
                                         "log": "/tmp/j.jsonl"}}},
    {"job": {"nprocs": 1}},
    {"job": {"command": "x", "restart": {"max_restart": 3}}},
    {"job": {"command": "x", "restart": {"backof": 1, "grace": 2}}},
    {"job": {"command": "x", "restart": True}},
    {"job": {"command": "x", "restart": [1, 2]}},
    {"job": {"restart": {"max_restarts": "two"}}},
    {"job": None},
    {"job": "python x.py"},
    ["not", "a", "mapping"],
    None,
]


@pytest.mark.parametrize("spec", PLAIN_SPECS, ids=range(len(PLAIN_SPECS)))
def test_validate_spec_matches_jax(spec):
    assert tjob.validate_spec(spec) == jjob.validate_spec(spec)


@pytest.mark.parametrize("key,item", [
    ("elastic", "13.4"), ("policy", "13.6"), ("tune", "13.9"),
    ("serve", "13.8")])
def test_refused_blocks_fail_before_any_side_effect(tmp_path, capsys, key,
                                                   item):
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    (model_dir / "checkpoint-1.pt").write_bytes(b"keep")
    marker = tmp_path / "ran"
    spec = _spec(tmp_path, f"""
        job:
          fresh: true
          command: ["{PY}", "-c", "open({str(marker)!r}, 'w').close()"]
          {key}:
            mode: "on"
          restart:
            max_restarts: 1
          env:
            PS_MODEL_PATH: {model_dir}
    """)
    assert tjob.run_job(spec) == 1
    out = capsys.readouterr().out
    assert f"job {key}: is not ported yet" in out and f"item {item}" in out
    assert not marker.exists()
    assert (model_dir / "checkpoint-1.pt").exists()  # no fresh wipe


@pytest.mark.parametrize("knob,value,item", [
    ("HVT_FLIGHT_RECORD", "/tmp/flight", "13.5"),
    ("HVT_METRICS_PORT", "29741", "13.5"),
    ("HVT_POLICY", "on", "13.6")])
def test_refused_env_knobs_in_a_spec(tmp_path, capsys, knob, value, item):
    marker = tmp_path / "ran"
    spec = _spec(tmp_path, f"""
        job:
          command: ["{PY}", "-c", "open({str(marker)!r}, 'w').close()"]
          env:
            {knob}: "{value}"
    """)
    assert tjob.run_job(spec) == 1
    out = capsys.readouterr().out
    assert knob in out and f"item {item}" in out
    assert not marker.exists()


@pytest.mark.parametrize("argv,item", [
    (["run", "--nprocs", "1", "--elastic"], "13.4"),
    (["run", "--nprocs", "1", "--min-ranks", "1"], "13.4"),
    (["pod", "--hosts", "a", "--max-ranks", "2"], "13.4"),
    (["run", "--nprocs", "1", "--max-restarts", "1", "--policy", "on"],
     "13.6"),
    (["pod", "--hosts", "a", "--spares", "1"], "13.6"),
    (["run", "--nprocs", "1", "--tune", "offline"], "13.9"),
    (["run", "--nprocs", "1", "--metrics-port", "29741"], "13.5"),
    (["run", "--nprocs", "1", "--env", "HVT_POLICY=dry-run"], "13.6"),
])
def test_refused_flags_name_their_item(tmp_path, capsys, argv, item):
    marker = tmp_path / "ran"
    with pytest.raises(SystemExit) as e:
        launcher.main(argv + ["--", PY, "-c",
                              f"open({str(marker)!r}, 'w').close()"])
    assert e.value.code == 2
    assert f"item {item}" in capsys.readouterr().err
    assert not marker.exists()


@pytest.mark.parametrize("sub,item", [("lint", "item 13 "),
                                      ("serve", "13.8"), ("fleet", "13.6")])
def test_refused_subcommands_name_their_item(capsys, sub, item):
    with pytest.raises(SystemExit) as e:
        launcher.main([sub, "--anything"])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


def test_status_port_needs_supervision_on_the_cli(capsys):
    with pytest.raises(SystemExit):
        launcher.main(["run", "--nprocs", "1", "--status-port", "0", "--",
                       PY, "-c", "pass"])
    assert "supervised launch" in capsys.readouterr().err


class TestWaitFailStop:
    """Grace-window edge cases of the fail-stop wait: survivors of a rank
    failure get grace_seconds to finish on their own before termination,
    and the FIRST failure's code is the job's code."""

    def _proc(self, code, delay=0.0):
        return subprocess.Popen(
            [PY, "-c", f"import time, sys; time.sleep({delay}); "
                       f"sys.exit({code})"])

    def test_survivor_finishing_within_grace_is_untouched(self):
        failed = self._proc(3)
        survivor = self._proc(0, delay=0.7)
        assert launcher._wait_fail_stop([failed, survivor],
                                        grace_seconds=30.0) == 3
        assert survivor.returncode == 0

    def test_survivor_terminated_after_grace(self):
        failed = self._proc(2)
        survivor = self._proc(0, delay=60)
        t0 = time.monotonic()
        assert launcher._wait_fail_stop([failed, survivor],
                                        grace_seconds=0.4) == 2
        assert time.monotonic() - t0 < 30
        assert survivor.returncode is not None and survivor.returncode < 0

    def test_first_failure_code_wins_over_later_ones(self):
        first = self._proc(5)
        second = self._proc(9, delay=0.7)
        assert launcher._wait_fail_stop([first, second],
                                        grace_seconds=30.0) == 5
        assert second.returncode == 9

    def test_all_zero_is_zero(self):
        assert launcher._wait_fail_stop(
            [self._proc(0), self._proc(0, delay=0.2)],
            grace_seconds=5.0) == 0


class TestSupervisedCLI:
    def test_run_with_max_restarts_supervises(self, tmp_path):
        log = tmp_path / "restarts.jsonl"
        code = launcher.main([
            "run", "--nprocs", "1", "--max-restarts", "1", "--backoff", "0",
            "--restart-log", str(log),
            "--", PY, "-c", "raise SystemExit(5)",
        ])
        assert code == 5
        records = [json.loads(line) for line in log.read_text().splitlines()]
        assert [r["name"] for r in records] == ["restarts",
                                                "supervisor_gave_up"]

    def test_restart_log_alone_enables_supervision(self, tmp_path):
        log = tmp_path / "restarts.jsonl"
        code = launcher.main(["run", "--nprocs", "1", "--restart-log",
                              str(log), "--", PY, "-c", "pass"])
        assert code == 0
        assert log.exists()  # journal touched even with zero restarts

    def test_status_port_zero_prints_the_bound_address(self, tmp_path,
                                                       capsys):
        code = launcher.main(["run", "--nprocs", "1", "--max-restarts", "0",
                              "--restart-log", str(tmp_path / "j.jsonl"),
                              "--status-port", "0", "--", PY, "-c", "pass"])
        assert code == 0
        assert "supervisor: status on http://127.0.0.1:" in \
            capsys.readouterr().out


@pytest.fixture
def fake_ssh(tmp_path, monkeypatch):
    """PATH-shimmed ssh/scp that exec locally — the multi-host launcher's
    deployment path testable on one machine. Hosts containing 'bad'
    refuse the connection."""
    bin_dir = tmp_path / "fakebin"
    bin_dir.mkdir()
    ssh = bin_dir / "ssh"
    ssh.write_text(
        "#!/bin/bash\n"
        'while [[ "$1" == -* ]]; do\n'
        '  if [[ "$1" == "-o" ]]; then shift 2; else shift; fi\n'
        "done\n"
        'host="$1"; shift\n'
        'if [[ "$host" == *bad* ]]; then\n'
        '  echo "ssh: connect to host $host: Connection refused" >&2\n'
        "  exit 255\n"
        "fi\n"
        'exec sh -c "$*"\n'
    )
    ssh.chmod(0o755)
    scp = bin_dir / "scp"
    scp.write_text(
        "#!/bin/bash\n"
        'while [[ "$1" == -* ]]; do\n'
        '  if [[ "$1" == "-o" ]]; then shift 2; else shift; fi\n'
        "done\n"
        'src="$1"; dst="$2"\n'
        'if [[ "$src" == *bad*:* ]]; then exit 1; fi\n'
        'exec cp "${src#*:}" "${dst#*:}"\n'
    )
    scp.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    return bin_dir


def _env_dump_script(out):
    return (f"import json, os; json.dump({{k: v for k, v in "
            f"os.environ.items() if k.startswith('HVT_') or k == 'EXTRA'}},"
            f" open({str(out)!r} + '.' + os.environ['HVT_PROCESS_ID'], 'w'))")


class TestSshLauncher:
    def test_run_hosts_assigns_ranks_and_coordinator(self, tmp_path,
                                                     fake_ssh):
        out = tmp_path / "envdump"
        code = launcher.run_hosts(
            ["alpha", "user@beta"], [PY, "-c", _env_dump_script(out)],
            env={"EXTRA": "propagated"}, coordinator_port=7700)
        assert code == 0
        for r in range(2):
            env = json.load(open(f"{out}.{r}"))
            assert env["HVT_PROCESS_ID"] == str(r)
            assert env["HVT_NUM_PROCESSES"] == "2"
            assert env["HVT_LOCAL_RANK"] == "0"
            assert env["EXTRA"] == "propagated"
            # ssh-style user@host: the dialed address is the bare host.
            assert env["HVT_COORDINATOR_ADDRESS"] == "alpha:7700"

    def test_pod_nprocs_per_host_maps_ranks_host_major(self, tmp_path,
                                                       fake_ssh):
        """`pod --nprocs-per-host K`: K ranks a host, process ids h*K + j,
        local ranks 0..K-1 (the port runs one rank a card)."""
        out = tmp_path / "envdump"
        code = launcher.main([
            "pod", "--hosts", "h0,user@h1", "--nprocs-per-host", "3",
            "--port", "7711", "--", PY, "-c", _env_dump_script(out)])
        assert code == 0
        for pid in range(6):
            env = json.load(open(f"{out}.{pid}"))
            assert env["HVT_NUM_PROCESSES"] == "6"
            assert env["HVT_LOCAL_RANK"] == str(pid % 3)
            assert env["HVT_COORDINATOR_ADDRESS"] == "h0:7711"

    def test_run_hosts_env_propagation_and_workdir(self, tmp_path, fake_ssh):
        script = ("import os, pathlib; pathlib.Path('cwd.txt').write_text("
                  "os.getcwd() + '\\n' + os.environ['MY_FLAG'])")
        code = launcher.run_hosts(["solo"], [PY, "-c", script],
                                  env={"MY_FLAG": "on remote"},
                                  workdir=str(tmp_path))
        assert code == 0
        cwd, flag = (tmp_path / "cwd.txt").read_text().splitlines()
        assert cwd == str(tmp_path)
        assert flag == "on remote"

    def test_run_hosts_failure_propagates(self, fake_ssh):
        assert launcher.run_hosts(["goodhost", "badhost"], ["true"]) == 255

    def test_job_with_hosts_fetches_remote_metrics(self, tmp_path, fake_ssh):
        metrics = tmp_path / "metrics.jsonl"
        _write_metrics(metrics, [0.9, 0.9])  # stale — must be reset
        writer = ("import json;"
                  f"open({str(metrics)!r}, 'w').write("
                  "json.dumps({'name': 'loss', 'value': 0.1}) + '\\n')")
        spec = _spec(tmp_path, f"""
            name: pod-job
            job:
              command: ["{PY}", "-c", {json.dumps(writer)}]
              hosts: [podhost]
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
        """)
        assert tjob.run_job(spec) == 0

    def test_job_refuses_gate_when_reset_fails(self, tmp_path, fake_ssh):
        metrics = tmp_path / "metrics.jsonl"
        _write_metrics(metrics, [0.01])  # stale pass-looking values
        spec = _spec(tmp_path, f"""
            name: pod-job-bad
            job:
              command: ["true"]
              hosts: [badhost]
            metrics: {metrics}
            checks:
              loss:
                target: "0.0..0.3"
        """)
        assert tjob.run_job(spec) != 0

    def test_supervised_pod_rotates_the_coordinator_port(self, tmp_path,
                                                         fake_ssh):
        """`pod --max-restarts`: each relaunch dials base + attempt, so an
        orphan holding the old port cannot wedge the next attempt."""
        stamp = tmp_path / "fired"
        log = tmp_path / "restarts.jsonl"
        body = (f"import os, sys; open({str(tmp_path)!r} + '/addr', 'a')"
                ".write(os.environ['HVT_COORDINATOR_ADDRESS'] + '\\n'); "
                f"s = {str(stamp)!r}; f = os.path.exists(s); "
                "open(s, 'w').close(); sys.exit(0 if f else 4)")
        code = launcher.main([
            "pod", "--hosts", "h0", "--port", "7800", "--max-restarts", "2",
            "--backoff", "0", "--restart-log", str(log), "--",
            PY, "-c", body])
        assert code == 0
        assert (tmp_path / "addr").read_text().split() == ["h0:7800",
                                                           "h0:7801"]

    def test_pod_heartbeat_timeout_needs_shared_dir(self, capsys,
                                                    monkeypatch):
        monkeypatch.delenv("PS_MODEL_PATH", raising=False)
        with pytest.raises(SystemExit):
            launcher.main(["pod", "--hosts", "h0", "--heartbeat-timeout",
                           "5", "--", "true"])
        assert "shared filesystem" in capsys.readouterr().err


def test_port_specs_validate_and_parse_without_yaml():
    root = os.path.join(os.path.dirname(tjob.__file__), "jobs")
    for name in ("mnist-ci.yaml", "mnist-ci-2proc.yaml"):
        spec = specfile.load(os.path.join(root, name))
        assert tjob.validate_spec(spec) == []
        assert spec["checks"]["loss"] == {"target": "0.0..0.3",
                                          "aggregate": "mean"}
    ci2 = specfile.load(os.path.join(root, "mnist-ci-2proc.yaml"))
    assert set(ci2["metrics_checks"]) == {"hvt_committed_step",
                                          "hvt_restarts_total"}
    assert ci2["job"]["env"]["HVT_DEVICE"] == "cpu"
