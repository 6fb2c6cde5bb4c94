"""CI convergence gate — port of `horovod_tpu.launch.ci_gate` (all of it):
the Gradient workflow's ``checks`` block, natively.

Reference semantics (config.yaml:8-11): after the multinode run, aggregate a
named metric stream (``tensorflow:loss``, ``aggregate: mean``) and require it
inside ``target: "0.0..0.3"``. Here the stream is the
`horovod_tpu_torch.metrics` JSONL file (or the supervisor's restart
journal, whose records are metric-shaped) and the target grammar is the
same ``lo..hi`` string. Stdlib only, apart from the port's own
`obs.prom` parser for ``metrics_checks:``.
"""

from __future__ import annotations

import json
import os


def parse_target(target: str) -> tuple[float, float]:
    """Parse the reference's range grammar: ``"0.0..0.3"`` → (0.0, 0.3)."""
    lo, hi = target.split("..")
    return float(lo), float(hi)


def read_metric(path: str, name: str, job: str | None = None) -> list[float]:
    """All values of ``name`` in the stream, in write order. Reads a
    rotated ``.1`` predecessor (the supervisor's `RestartLog` rotation)
    before the live file, so count/last aggregates see the full window
    across the rotation boundary.

    ``job``: restrict to records whose ``job`` field equals it — the
    multi-job scoping for fleet journals (`hvt-launch fleet` tags every
    placement/preempt/regrow record with the job it concerns). ``None``
    keeps the classic single-job semantics: every record of ``name``
    counts, tagged or not."""
    values = []
    for part in (path + ".1", path):
        if not os.path.exists(part):
            continue
        with open(part) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # A torn final line (writer killed mid-append, or a
                    # reader racing the appender) must not crash the gate —
                    # the fail-on-empty-stream semantics still hold below.
                    continue
                if rec.get("name") != name:
                    continue
                if job is not None and rec.get("job") != job:
                    continue
                values.append(float(rec["value"]))
    return values


def aggregate(values: list[float], how: str = "mean") -> float:
    if how == "count":
        # Number of records, not their values — the restart-log check
        # ("exactly one restart recorded": restarts=1..1, aggregate count;
        # the supervisor's JSONL records are metric-shaped for this).
        return float(len(values))
    if not values:
        raise ValueError("no values to aggregate")
    if how == "mean":
        return sum(values) / len(values)
    if how == "last":
        return values[-1]
    if how == "min":
        return min(values)
    if how == "max":
        return max(values)
    raise ValueError(f"unknown aggregate {how!r}")


def check_metrics(
    path: str,
    name: str,
    target: tuple[float, float],
    how: str = "mean",
    job: str | None = None,
) -> tuple[bool, float]:
    """Return (passed, aggregated value). Missing metric — or a missing
    metrics file entirely — fails the gate rather than crashing it (a run
    that logged nothing must not pass)."""
    if not os.path.exists(path) and not os.path.exists(path + ".1"):
        # A missing stream file always fails — for every aggregate: a run
        # that wrote nothing (or a typo'd path) must not pass any check.
        # (A rotated-away live file with a `.1` predecessor still counts
        # as present: the stream exists, its newest window is just empty.)
        return False, float("nan")
    values = read_metric(path, name, job=job)
    if not values and how != "count":
        # count is the exception *for an existing file*: zero matching
        # records is a legitimate answer (e.g. asserting a supervised run
        # needed no restarts — the journal exists, no restart lines).
        return False, float("nan")
    value = aggregate(values, how)
    lo, hi = target
    return lo <= value <= hi, value


def run_prom_checks(prom_path: str, checks: dict) -> bool:
    """Evaluate a ``{series: {target}}`` block against a Prometheus text
    exposition dump (the supervisor's final scrape,
    `supervisor.dump_metrics`) — the job-spec ``metrics_checks:`` gate,
    same ``lo..hi`` grammar as ``checks:``. A missing dump, an unparseable
    dump, or an ABSENT series all fail loudly: a run whose metrics never
    landed must not pass a metrics gate."""
    from horovod_tpu_torch.obs import prom

    if not prom_path or not os.path.exists(prom_path):
        print(f"metrics check: exposition dump {prom_path} not found FAIL")
        return False
    try:
        with open(prom_path) as f:
            values = prom.parse_text(f.read())
    except ValueError as e:
        print(f"metrics check: unparseable exposition dump ({e}) FAIL")
        return False
    ok = True
    for name, rule in checks.items():
        lo, hi = parse_target(str(rule["target"]))
        value = values.get(name)
        passed = value is not None and lo <= value <= hi
        shown = "absent" if value is None else f"{value:.6g}"
        print(
            f"metrics check {name}: value={shown} target={rule['target']} "
            f"{'PASS' if passed else 'FAIL'}"
        )
        ok = ok and passed
    return ok


def run_checks(metrics_path: str, checks: dict) -> bool:
    """Evaluate a ``{name: {target, aggregate}}`` block (the config.yaml:8-11
    shape), printing one verdict line per check. Shared by the CLI and the
    YAML job runner. A rule may carry ``job: <name>`` to scope the
    aggregate to one job's records in a multi-job (fleet) journal —
    single-job specs omit it and behave exactly as before."""
    ok = True
    for name, rule in checks.items():
        how = rule.get("aggregate", "mean")
        job = rule.get("job")
        passed, value = check_metrics(
            metrics_path, name, parse_target(str(rule["target"])), how=how,
            job=job,
        )
        scope = f" job={job}" if job is not None else ""
        print(
            f"check {name}{scope}: {how}={value:.6g} "
            f"target={rule['target']} {'PASS' if passed else 'FAIL'}"
        )
        ok = ok and passed
    return ok
