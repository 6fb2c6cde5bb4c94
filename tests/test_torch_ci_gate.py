"""The port's CI gate (`horovod_tpu_torch.launch.ci_gate`) against the JAX
package's on the same streams, built from a numpy seed: ``parse_target``,
``read_metric`` (with the ``.1`` rotation, torn lines and the ``job``
filter), ``aggregate``, ``check_metrics``, ``run_checks`` and
``run_prom_checks`` (over each package's own ``obs.prom`` parser) give
equal results; plus the behaviour cases of ``tests/test_launch.py``'s
``TestCIGate`` and the ``gate`` CLI."""

import json
import math

import numpy as np
import pytest

from horovod_tpu.launch import ci_gate as jgate
from horovod_tpu_torch.launch import ci_gate as tgate
from horovod_tpu_torch.launch import launcher

HOWS = ("mean", "last", "min", "max", "count")


def _write_metrics(path, values, name="loss"):
    with open(path, "w") as f:
        for i, v in enumerate(values):
            f.write(json.dumps({"name": name, "value": v, "step": i}) + "\n")


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _stream(tmp_path, seed):
    """A journal-like stream: three names, two jobs, a rotated ``.1``
    predecessor, a blank line and a torn tail."""
    rng = np.random.default_rng(seed)
    path = tmp_path / f"stream-{seed}.jsonl"
    for part in (str(path) + ".1", str(path)):
        with open(part, "w") as f:
            for _ in range(int(rng.integers(3, 9))):
                rec = {"name": str(rng.choice(["loss", "restarts", "grow"])),
                       "value": float(rng.normal())}
                if rng.random() < 0.5:
                    rec["job"] = str(rng.choice(["a", "b"]))
                f.write(json.dumps(rec) + "\n")
            f.write("\n")
            f.write('{"name": "loss", "val')  # torn mid-append
    return str(path)


@pytest.mark.parametrize("target", ["0.0..0.3", "1..1", "-2.5..1e3",
                                    "0..60000"])
def test_parse_target_matches_jax(target):
    assert tgate.parse_target(target) == jgate.parse_target(target)


@pytest.mark.parametrize("seed", range(4))
def test_read_metric_and_check_match_jax(tmp_path, seed):
    path = _stream(tmp_path, seed)
    for name in ("loss", "restarts", "grow", "absent"):
        for job in (None, "a", "b"):
            assert (tgate.read_metric(path, name, job=job)
                    == jgate.read_metric(path, name, job=job))
            for how in HOWS:
                for target in ((-1.0, 1.0), (0.0, 0.0), (2.0, 9.0)):
                    t = tgate.check_metrics(path, name, target, how=how,
                                            job=job)
                    j = jgate.check_metrics(path, name, target, how=how,
                                            job=job)
                    assert t[0] == j[0] and _same(t[1], j[1]), (name, how)


@pytest.mark.parametrize("how", HOWS)
def test_aggregate_matches_jax(how):
    vals = list(np.random.default_rng(7).normal(size=11))
    assert tgate.aggregate(vals, how) == jgate.aggregate(vals, how)
    if how == "count":
        assert tgate.aggregate([], how) == jgate.aggregate([], how) == 0.0
    else:
        for mod in (tgate, jgate):
            with pytest.raises(ValueError):
                mod.aggregate([], how)


def test_unknown_aggregate_refused_alike():
    for mod in (tgate, jgate):
        with pytest.raises(ValueError, match="unknown aggregate"):
            mod.aggregate([1.0], "median")


def test_missing_stream_fails_alike(tmp_path):
    missing = str(tmp_path / "nope.jsonl")
    for how in HOWS:
        t = tgate.check_metrics(missing, "loss", (0, 1), how=how)
        j = jgate.check_metrics(missing, "loss", (0, 1), how=how)
        assert t[0] is j[0] is False and math.isnan(t[1])


def test_run_checks_match_jax(tmp_path, capsys):
    path = _stream(tmp_path, 11)
    checks = {"loss": {"target": "-9..9", "aggregate": "count"},
              "grow": {"target": "-3..3", "aggregate": "mean", "job": "a"},
              "restarts": {"target": "5..6"}}
    t = tgate.run_checks(path, checks)
    t_out = capsys.readouterr().out
    j = jgate.run_checks(path, checks)
    assert (t, t_out) == (j, capsys.readouterr().out)


def test_run_prom_checks_match_jax(tmp_path, capsys):
    prom = tmp_path / "metrics.prom"
    prom.write_text(
        "# HELP hvt_restarts_total x\n# TYPE hvt_restarts_total counter\n"
        "hvt_restarts_total 1\nhvt_committed_step 15\n"
        'hvt_step_skew_ms{rank="0"} 3.5\n')
    checks = {"hvt_restarts_total": {"target": "1..1"},
              "hvt_committed_step": {"target": "1..1000000"},
              'hvt_step_skew_ms{rank="0"}': {"target": "0..1"},
              "hvt_absent": {"target": "0..0"}}
    for path in (str(prom), str(tmp_path / "missing.prom")):
        t = tgate.run_prom_checks(path, checks)
        t_out = capsys.readouterr().out
        j = jgate.run_prom_checks(path, checks)
        assert (t, t_out) == (j, capsys.readouterr().out)
    prom.write_text("hvt_restarts_total\n")  # torn: no value
    assert tgate.run_prom_checks(str(prom), checks) is False
    assert "unparseable" in capsys.readouterr().out


class TestCIGate:
    def test_parse_target_reference_grammar(self):
        assert tgate.parse_target("0.0..0.3") == (0.0, 0.3)

    def test_aggregates(self):
        vals = [0.4, 0.2, 0.05]
        assert tgate.aggregate(vals, "mean") == pytest.approx(0.21666,
                                                              rel=1e-3)
        assert tgate.aggregate(vals, "last") == 0.05
        assert tgate.aggregate(vals, "min") == 0.05
        assert tgate.aggregate(vals, "max") == 0.4

    def test_check_pass_and_fail(self, tmp_path):
        path = tmp_path / "metrics.jsonl"
        _write_metrics(path, [0.25, 0.15, 0.08])
        ok, value = tgate.check_metrics(str(path), "loss", (0.0, 0.3))
        assert ok and value == pytest.approx(0.16)
        ok, _ = tgate.check_metrics(str(path), "loss", (0.0, 0.1))
        assert not ok

    def test_missing_metric_fails_not_crashes(self, tmp_path):
        path = tmp_path / "metrics.jsonl"
        _write_metrics(path, [0.1], name="accuracy")
        ok, _ = tgate.check_metrics(str(path), "loss", (0.0, 0.3))
        assert not ok

    def test_gate_cli(self, tmp_path):
        path = tmp_path / "metrics.jsonl"
        _write_metrics(path, [0.2, 0.1])
        assert launcher.main(["gate", "--metrics", str(path),
                              "--check", "loss=0.0..0.3"]) == 0
        assert launcher.main(["gate", "--metrics", str(path),
                              "--check", "loss=0.0..0.01"]) == 1

    def test_gate_count_aggregate_cli(self, tmp_path):
        """The restart journal is gateable with the count aggregate."""
        log = tmp_path / "restarts.jsonl"
        _write_metrics(log, [1.0], name="restarts")
        assert launcher.main(["gate", "--metrics", str(log),
                              "--check", "restarts=1..1",
                              "--aggregate", "count"]) == 0
        assert launcher.main(["gate", "--metrics", str(log),
                              "--check", "restarts=0..0",
                              "--aggregate", "count"]) == 1

    def test_missing_journal_fails_count_gate(self, tmp_path):
        """Only an EXISTING empty journal passes restarts=0..0."""
        missing = tmp_path / "nope" / "restarts.jsonl"
        ok, _ = tgate.check_metrics(str(missing), "restarts", (0.0, 0.0),
                                    how="count")
        assert not ok
        existing = tmp_path / "restarts.jsonl"
        existing.write_text("")
        ok, value = tgate.check_metrics(str(existing), "restarts",
                                        (0.0, 0.0), how="count")
        assert ok and value == 0.0

    def test_accepts_rotated_away_live_file(self, tmp_path):
        p = tmp_path / "j.jsonl"
        (tmp_path / "j.jsonl.1").write_text(
            json.dumps({"name": "restarts", "value": 1.0}) + "\n")
        ok, value = tgate.check_metrics(str(p), "restarts", (1.0, 1.0),
                                        how="count")
        assert ok and value == 1.0
