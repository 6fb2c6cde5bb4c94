"""The port's replica router (`horovod_tpu_torch.serving.router`): the
`ReplicaSet` ledger (JAX's three tests), `make_router` over two CPU port
servers (least-loaded spread, NDJSON passthrough, drain, 503, a replica's
429 forwarded, a dead port retried elsewhere, ``code="500"`` at 0), and
the wire across packages both ways: the JAX router in front of a port
replica, and the port's router in front of a JAX replica, each answering
as the replica does alone.
"""

import concurrent.futures
import contextlib
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from horovod_tpu import checkpoint as jckpt
from horovod_tpu.launch import serve as jserve
from horovod_tpu.serving import router as jrouter
from horovod_tpu_torch.launch import serve as serve_mod
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.obs import prom
from horovod_tpu_torch.serving import export_generate, load_generate
from horovod_tpu_torch.serving.engine import AdmissionError
from horovod_tpu_torch.serving.router import (NoReplicaError, ReplicaSet,
                                              make_router)

T0, NEW, CHUNK = 8, 8, 4
PROMPTS = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 11], [12] * T0, [13, 14]]


# -- the ledger (tests/test_serving_engine.py's, on the port)


def test_acquire_prefers_least_loaded():
    rs = ReplicaSet()
    rs.add("a", "http://a")
    rs.add("b", "http://b")
    r1 = rs.acquire()
    r2 = rs.acquire()
    assert {r1.name, r2.name} == {"a", "b"}  # spread, not piled
    r3 = rs.acquire(exclude={r1.name})
    assert r3.name == r2.name
    for r in (r1, r2, r3):
        rs.release(r)
    assert all(s["inflight"] == 0 for s in rs.snapshot())


def test_draining_replica_gets_no_traffic():
    rs = ReplicaSet()
    rs.add("a", "http://a")
    rs.add("b", "http://b")
    rs.drain("a")
    for _ in range(4):
        assert rs.acquire().name == "b"
    rs.drain("b")
    with pytest.raises(NoReplicaError):
        rs.acquire()
    rs.readmit("a")
    assert rs.acquire().name == "a"


def test_wait_drained_is_the_swap_barrier():
    rs = ReplicaSet()
    rs.add("a", "http://a")
    held = rs.acquire()
    rs.drain("a")
    assert rs.wait_drained("a", 0.05) is False  # in-flight request holds it
    t = threading.Timer(0.05, lambda: rs.release(held))
    t.start()
    try:
        assert rs.wait_drained("a", 5.0) is True
    finally:
        t.join()


# -- the HTTP router


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    model = TransformerLM(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                          dropout=0.0, device="cpu", seed=2)
    return export_generate(str(tmp_path_factory.mktemp("router")), model,
                           batch_size=2, prompt_len=T0, max_new_tokens=NEW,
                           streaming_chunk=CHUNK, timestamp="r")


@pytest.fixture(scope="module")
def solo(bundle_dir):
    b = load_generate(bundle_dir, device="cpu")
    return [b.generate_batch([np.asarray(p, np.int32)])[0] for p in PROMPTS]


@contextlib.contextmanager
def started(srv, close=None):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        if close is not None:
            close()
        th.join(timeout=30)
        assert not th.is_alive()


@contextlib.contextmanager
def replica(bundle_dir, **kw):
    srv = serve_mod.make_server(bundle_dir, port=0, device="cpu", **kw)
    with started(srv, srv.app.close) as url:
        yield srv, url


@contextlib.contextmanager
def router(urls, make=make_router, rs_cls=ReplicaSet):
    rs = rs_cls()
    for i, u in enumerate(urls):
        rs.add(f"r{i}", u)
    srv = make(port=0, replicas=rs)
    with started(srv) as url:
        yield srv, rs, url


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _metrics(url):
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        return prom.parse_text(r.read().decode())


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def test_router_spreads_and_streams_the_solo_tokens(bundle_dir, solo):
    with replica(bundle_dir) as (a, ua), replica(bundle_dir) as (b, ub), \
            router([ua, ub]) as (_, _, url):
        with concurrent.futures.ThreadPoolExecutor(len(PROMPTS)) as pool:
            replies = list(pool.map(
                lambda i: _post(f"{url}/v1/generate",
                                {"prompt": [PROMPTS[i]],
                                 "stream": i % 2 == 1}),
                range(len(PROMPTS))))
        rows = a.app.stats["rows"], b.app.stats["rows"]
        m = _metrics(url)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    assert rows[0] > 0 and rows[1] > 0 and sum(rows) == len(PROMPTS)
    for i, (code, ctype, body) in enumerate(replies):
        assert code == 200
        if i % 2:
            assert ctype == "application/x-ndjson"
            lines = [json.loads(ln) for ln in body.splitlines()]
            assert len(lines) == NEW // CHUNK + 1
            assert lines[-1] == {"done": True, "tokens": [solo[i]]}
        else:
            assert json.loads(body) == {"tokens": [solo[i]]}
    req = 'hvt_serve_requests_total{route="/v1/generate",code="%s"}'
    assert m[req % "200"] == len(PROMPTS)
    assert m[req % "500"] == 0
    assert m["hvt_serve_ttft_seconds_count"] == len(PROMPTS)
    assert m["hvt_serve_replicas"] == 2
    assert health["tier"] == "router" and health["live"] == 2


def test_drained_replica_gets_nothing(bundle_dir, solo):
    with replica(bundle_dir) as (a, ua), replica(bundle_dir) as (b, ub), \
            router([ua, ub]) as (_, rs, url):
        rs.drain("r0")
        for i in range(4):
            code, _, body = _post(f"{url}/v1/generate",
                                  {"prompt": [PROMPTS[i]]})
            assert code == 200 and json.loads(body)["tokens"] == [solo[i]]
        assert a.app.stats["rows"] == 0 and b.app.stats["rows"] == 4
        rs.readmit("r0")
        rs.drain("r1")
        assert _post(f"{url}/v1/generate", {"prompt": [[1]]})[0] == 200
        assert a.app.stats["rows"] == 1


def test_no_replica_is_503():
    with router([]) as (_, _, url):
        code, _, body = _post(f"{url}/v1/generate", {"prompt": [[1]]})
        assert code == 503 and "no replica registered" in body
    with router(["http://127.0.0.1:1"]) as (_, rs, url):
        rs.mark_dead("r0")
        code, _, body = _post(f"{url}/v1/generate", {"prompt": [[1]]})
        assert code == 503 and "draining/dead" in body
        assert _metrics(url)[
            'hvt_serve_requests_total{route="/v1/generate",code="503"}'] == 1


def test_a_replicas_429_is_forwarded(bundle_dir):
    with replica(bundle_dir, continuous=True) as (a, ua), \
            router([ua]) as (_, _, url):
        def full(*args, **kw):
            raise AdmissionError("serving queue full (64 waiting)")

        a.app.engine.submit = full
        code, _, body = _post(f"{url}/v1/generate", {"prompt": [[1]]})
        assert code == 429
        assert json.loads(body) == {
            "error": "serving queue full (64 waiting)"}
        m = _metrics(url)
    assert m['hvt_serve_requests_total{route="/v1/generate",code="429"}'] == 1


def test_a_dead_port_is_retried_elsewhere_and_marked(bundle_dir, solo):
    with replica(bundle_dir) as (a, ua), \
            router([_dead_port(), ua]) as (_, rs, url):
        # r0 (the dead port) sorts first on a tie: the first request
        # dials it, fails to connect and retries on r1.
        for i in range(3):
            code, _, body = _post(f"{url}/v1/generate",
                                  {"prompt": [PROMPTS[i]]})
            assert code == 200 and json.loads(body)["tokens"] == [solo[i]]
        snap = {s["name"]: s for s in rs.snapshot()}
        m = _metrics(url)
    assert snap["r0"]["dead"] and not snap["r1"]["dead"]
    assert m["hvt_serve_router_retries_total"] == 1
    assert m['hvt_serve_requests_total{route="/v1/generate",code="500"}'] == 0
    assert m["hvt_serve_replicas"] == 1


# -- the wire across packages


def test_jax_router_in_front_of_a_port_replica(bundle_dir, solo):
    with replica(bundle_dir) as (_, ua), \
            router([ua], jrouter.make_router, jrouter.ReplicaSet) as \
            (_, _, url):
        for i, stream in ((0, False), (1, True), (2, True)):
            payload = {"prompt": [PROMPTS[i]], "stream": stream}
            via = _post(f"{url}/v1/generate", payload)
            alone = _post(f"{ua}/v1/generate", payload)
            assert via == alone
            assert via[0] == 200 and solo[i] == (
                json.loads(via[2].splitlines()[-1])["tokens"][0])
        bad = {"prompt": [list(range(T0 + 1))]}
        assert _post(f"{url}/v1/generate", bad) == \
            _post(f"{ua}/v1/generate", bad)


def test_port_router_in_front_of_a_jax_replica(tmp_path):
    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            return nn.Dense(3)(x)

    model = Tiny()
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((4, 6), np.float32))["params"]
    d = jckpt.export_serving(str(tmp_path), lambda p, x: model.apply(
        {"params": p}, x), params, input_shape=(4, 6), timestamp="j")
    srv = jserve.make_server(d, port=0)
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    with started(srv) as ua, router([ua]) as (_, _, url):
        for payload in ({"input": x.tolist()}, {"input": [[1.0]]},
                        {"wrong": 1}):
            via = _post(f"{url}/v1/predict", payload)
            assert via == _post(f"{ua}/v1/predict", payload)
        assert via[0] == 400
        assert _post(f"{url}/v1/predict", {"input": x.tolist()})[0] == 200
        m = _metrics(url)
    req = 'hvt_serve_requests_total{route="/v1/predict",code="%s"}'
    assert m[req % "200"] == 2 and m[req % "400"] == 2
