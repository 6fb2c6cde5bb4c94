"""The port's `obs` core against the JAX package's: the same metric
catalog, byte-identical exposition for the same calls (counters with
labels, ``counter_set``, gauges, histograms, escaping, collectors), the
registry's refusals, `parse_text`, and the standalone metrics server with
its on-demand `torch.profiler` capture.
"""

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from horovod_tpu.obs import core as jcore
from horovod_tpu.obs import prom as jprom
from horovod_tpu_torch.obs import core, prom
from horovod_tpu_torch.obs import server as obs_server

TRICKY = 'a"b\\c\nd e'


def _fields(spec):
    return (spec.name, spec.kind, spec.help, spec.subsystem, spec.labels,
            spec.buckets)


def test_catalog_equals_jax_row_for_row():
    assert list(core.METRICS) == list(jcore.METRICS)
    for name, spec in core.METRICS.items():
        assert _fields(spec) == _fields(jcore.METRICS[name]), name


def _drive(core_mod, seed=0):
    """One sequence of calls on a fresh registry of ``core_mod``."""
    reg = core_mod.Registry()
    rng = random.Random(seed)
    reg.counter("hvt_serve_requests_total", route="/v1/generate", code="200")
    reg.counter("hvt_serve_requests_total", 2, route="/v1/generate",
                code="200")
    reg.counter("hvt_serve_requests_total", route="/v1/predict", code="400")
    reg.counter_set("hvt_restarts_total", 3)
    reg.counter_set("hvt_serve_device_calls_total", 7.5)
    reg.gauge("hvt_member_heartbeat_age_seconds", 1.25, member=TRICKY)
    reg.gauge("hvt_member_heartbeat_age_seconds", float("inf"), member="m1")
    reg.gauge("hvt_mfu", 0.1 + 0.2)
    for _ in range(50):
        reg.histogram("hvt_serve_ttft_seconds", rng.uniform(0, 3))
        reg.histogram("hvt_serve_request_seconds", rng.uniform(0, 100),
                      route="/v1/generate")
    reg.histogram("hvt_step_seconds", 1e-4)

    def collector(r):
        r.gauge("hvt_serve_queue_depth", 4)
        r.counter_set("hvt_serve_rows_total", 12)

    reg.register_collector(collector)
    reg.register_collector(collector)  # the same callable: no duplicate
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_identical_to_jax(seed):
    text = prom.render(_drive(core, seed))
    assert text == jprom.render(_drive(jcore, seed))
    assert 'member="a\\"b\\\\c\\nd e"' in text
    assert "hvt_member_heartbeat_age_seconds{member=\"m1\"} +Inf" in text
    assert "hvt_serve_queue_depth 4" in text


def test_empty_registry_renders_empty():
    assert prom.render(core.Registry()) == jprom.render(jcore.Registry()) == ""


def test_parse_text_round_trips():
    reg = _drive(core)
    text = prom.render(reg)
    parsed = prom.parse_text(text)
    assert parsed == jprom.parse_text(text)
    assert parsed['hvt_serve_requests_total{route="/v1/generate",'
                  'code="200"}'] == 3.0
    assert parsed["hvt_serve_ttft_seconds_count"] == 50.0
    assert parsed['hvt_serve_ttft_seconds_bucket{le="+Inf"}'] == 50.0
    assert parsed["hvt_serve_device_calls_total"] == 7.5
    with pytest.raises(ValueError):
        prom.parse_text("hvt_x 1\nnot-a-number-line x y z q\n")


@pytest.mark.parametrize("verb", ["counter", "gauge", "histogram",
                                  "counter_set"])
def test_undeclared_names_are_refused(verb):
    reg = core.Registry()
    with pytest.raises(core.UnknownMetricError, match="MetricSpec"):
        getattr(reg, verb)("hvt_not_a_thing", 1.0)
    assert not core.is_declared("hvt_not_a_thing")


def test_kind_and_label_mismatches_are_refused():
    reg = core.Registry()
    with pytest.raises(ValueError, match="gauge, not a counter"):
        reg.counter("hvt_mfu")
    with pytest.raises(ValueError, match="not a histogram"):
        reg.histogram("hvt_mfu", 0.5)
    with pytest.raises(ValueError, match="label"):
        reg.counter("hvt_serve_requests_total", route="/v1/generate")
    with pytest.raises(ValueError, match="label"):
        reg.gauge("hvt_mfu", 1.0, member="m0")
    with pytest.raises(ValueError, match="only go up"):
        reg.counter("hvt_restarts_total", -1.0)
    with pytest.raises(ValueError, match="_total"):
        core._decl([core.MetricSpec("hvt_bad", "counter", "x", "obs")])


def test_broken_collector_never_breaks_a_scrape():
    reg = core.Registry()
    reg.register_collector(lambda r: 1 / 0)
    reg.register_collector(lambda r: r.gauge("hvt_serve_queue_depth", 3))
    assert "hvt_serve_queue_depth 3" in prom.render(reg)


def test_default_registry_verbs():
    core.reset()
    try:
        core.counter("hvt_scrapes_total")
        core.gauge("hvt_mfu", 0.5)
        core.register_collector(lambda r: r.counter_set(
            "hvt_optimizer_steps_total", 9))
        parsed = prom.parse_text(prom.render())
        assert parsed == {"hvt_mfu": 0.5, "hvt_optimizer_steps_total": 9.0,
                          "hvt_scrapes_total": 1.0}
    finally:
        core.reset()


def test_no_lost_updates_across_threads():
    reg = core.Registry()
    n, threads = 400, 8

    def work():
        for _ in range(n):
            reg.counter("hvt_scrapes_total")
            reg.histogram("hvt_step_seconds", 0.01)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    parsed = prom.parse_text(prom.render(reg))
    assert parsed["hvt_scrapes_total"] == n * threads
    assert parsed["hvt_step_seconds_count"] == n * threads


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _post(url):
    try:
        with urllib.request.urlopen(
                urllib.request.Request(url, method="POST"), timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_metrics_server_serves_metrics_healthz_and_404():
    reg = core.Registry()
    reg.gauge("hvt_mfu", 0.4)
    srv = obs_server.start_metrics_server(0, registry=reg)
    try:
        assert srv.server_address[0] == "127.0.0.1"  # HVT_STATUS_HOST
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        code, ctype, text = _get(f"{url}/metrics")
        assert code == 200 and ctype == prom.CONTENT_TYPE
        assert "hvt_mfu 0.4" in text and "hvt_scrapes_total 1" in text
        assert json.loads(_get(f"{url}/healthz")[2]) == {"status": "ok"}
        assert _get(f"{url}/nope")[0] == 404
        assert _post(f"{url}/profile?seconds=1")[0] == 404  # profile off
        code, body = _post(f"{url}/flightrecord")
        assert code == 409 and "item 13" in body["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_profile_needs_a_directory(monkeypatch):
    monkeypatch.delenv("HVT_TRACE_DIR", raising=False)
    monkeypatch.delenv("HVT_PROFILE", raising=False)
    srv = obs_server.start_metrics_server(0, profile=True)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        code, body = _post(f"{url}/profile?seconds=1")
        assert code == 400 and "HVT_TRACE_DIR" in body["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_profile_writes_a_trace_one_capture_at_a_time(tmp_path, monkeypatch):
    monkeypatch.setenv("HVT_TRACE_DIR", str(tmp_path))
    srv = obs_server.start_metrics_server(0, profile=True)
    stop = threading.Event()

    def busy():  # another thread's operators land in the capture
        import torch

        a = torch.ones(16, 16)
        while not stop.is_set():
            (a @ a).sum()
            time.sleep(0.002)

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert _post(f"{url}/profile?seconds=0")[0] == 400
        code, body = _post(f"{url}/profile?seconds=0.3")
        assert code == 200 and body["profiling"].startswith(str(tmp_path))
        assert _post(f"{url}/profile?seconds=0.3")[0] == 409
        trace = os.path.join(body["profiling"], "trace.json")
        deadline = time.monotonic() + 30
        events = None
        while events is None:  # until the export is complete
            assert time.monotonic() < deadline, "no trace written"
            try:
                with open(trace) as f:
                    events = json.load(f)["traceEvents"]
            except (OSError, ValueError):
                time.sleep(0.05)
        assert "aten::mm" in {e.get("name") for e in events}
        deadline = time.monotonic() + 10
        while _post(f"{url}/profile?seconds=0.1")[0] == 409:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        stop.set()
        worker.join(timeout=10)
        srv.shutdown()
        srv.server_close()
