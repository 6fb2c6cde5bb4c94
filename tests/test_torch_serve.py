"""The port's serving tier (`horovod_tpu_torch.launch.serve`) against the
JAX package's, on the CPU: predict bundles (probabilities within 1e-5 of
the JAX server's, the f32 logit tolerance of `test_torch_cnn.py`), the
coalescing device worker, generation bundles of every kind served by the
default (coalescing) app with the JAX server's tokens, ``/metrics``,
``/admin/reload`` under traffic in both modes, and the SIGTERM drain of a
launched server.

Greedy tokens compare exactly: the same weights (`params_from_flax`), and
the ragged contract makes each request's tokens its prompt's alone.
"""

import concurrent.futures
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu import checkpoint as jckpt
from horovod_tpu import serving as jserving
from horovod_tpu.launch import serve as jserve
from horovod_tpu.models import transformer as jtr
from horovod_tpu.models.cnn import MnistCNN as FlaxCNN
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.launch import serve as serve_mod
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.cnn import MnistCNN
from horovod_tpu_torch.models.convert import (cnn_params_from_flax,
                                              params_from_flax)
from horovod_tpu_torch.obs import prom
from horovod_tpu_torch.serving import export_generate, load_generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4  # the predict bundle's batch
PROB_ATOL = 1e-5
VOCAB, GEN_BATCH, T0, NEW, CHUNK = 64, 4, 12, 8, 4
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [7] * T0, [5], [2, 4], [8, 8, 8],
           [1, 2, 3, 4, 5, 6, 7], [60]]


# -- fixtures


@pytest.fixture(scope="module")
def cnn():
    """A seeded f32 flax `MnistCNN` and the port's twin on its weights."""
    fm = FlaxCNN()
    params = fm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 28, 28, 1), jnp.float32))["params"]
    tm = MnistCNN(device="cpu")
    tm.load_state_dict(cnn_params_from_flax(jax.device_get(params)))
    return fm, params, tm


@pytest.fixture(scope="module")
def predict_dirs(cnn, tmp_path_factory):
    fm, params, tm = cnn
    root = tmp_path_factory.mktemp("predict")
    jdir = jckpt.export_serving(
        str(root / "jax"), lambda p, x: fm.apply({"params": p}, x),
        params, input_shape=(BATCH, 28, 28, 1), timestamp="j")
    tdir = checkpoint.export_serving(str(root / "port"), tm,
                                     input_shape=(BATCH, 28, 28, 1),
                                     timestamp="t")
    return jdir, tdir


@pytest.fixture(scope="module")
def lm():
    """A flax `TransformerLM`, its params and the port's model on them."""
    cfg = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
               dropout=0.0)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def gen_dirs(lm, tmp_path_factory):
    """The port's bundles of the converted model: greedy, streaming,
    speculative, sampled; and bundle B (other weights) for reloads."""
    _, _, tm = lm
    root = str(tmp_path_factory.mktemp("generate"))
    kw = dict(batch_size=GEN_BATCH, prompt_len=T0, max_new_tokens=NEW)
    other = ttr.TransformerLM(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, dropout=0.0, device="cpu", seed=7)
    return {
        "greedy": export_generate(root, tm, timestamp="greedy", **kw),
        "stream": export_generate(root, tm, streaming_chunk=CHUNK,
                                  timestamp="stream", **kw),
        "speculative": export_generate(root, tm, speculative_gamma=3,
                                       timestamp="spec", **kw),
        "sampled": export_generate(root, tm, temperature=0.8, top_k=20,
                                   timestamp="sampled", **kw),
        "greedy_b": export_generate(root, other, timestamp="greedy_b", **kw),
        "stream_b": export_generate(root, other, streaming_chunk=CHUNK,
                                    timestamp="stream_b", **kw),
    }


@pytest.fixture(scope="module")
def solo(gen_dirs):
    """Each prompt's tokens from a bundle run on it alone."""
    out = {}
    for name in ("greedy", "greedy_b"):
        b = load_generate(gen_dirs[name], device="cpu")
        out[name] = [b.generate_batch([np.asarray(p, np.int32)])[0]
                     for p in PROMPTS]
    return out


@contextlib.contextmanager
def serving(bundle_dir, *, jax_server=False, **kw):
    srv = (jserve.make_server(bundle_dir, port=0, **kw) if jax_server else
           serve_mod.make_server(bundle_dir, port=0, device="cpu", **kw))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        if not jax_server:
            srv.app.close()
        th.join(timeout=30)
        assert not th.is_alive()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _concurrently(fn, args):
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        return list(pool.map(fn, args))


def _rows(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


# -- predict


def test_predict_matches_the_jax_server(predict_dirs):
    jdir, tdir = predict_dirs
    x = _rows(6, 0)
    with serving(jdir, jax_server=True) as (_, jurl), \
            serving(tdir) as (_, turl):
        replies = _concurrently(
            lambda u: _post(f"{u}/v1/predict", {"input": x.tolist()}),
            [jurl, turl])
    (jcode, jbody), (tcode, tbody) = replies
    assert jcode == tcode == 200
    want = np.asarray(json.loads(jbody)["prob"])
    got = np.asarray(json.loads(tbody)["prob"])
    assert got.shape == want.shape == (6, 10)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, BATCH, BATCH + 1, 3 * BATCH])
def test_predict_pads_and_splits_row_counts(predict_dirs, n):
    _, tdir = predict_dirs
    fn = checkpoint.load_serving(tdir, device="cpu")
    x = _rows(n, n)
    with serving(tdir) as (srv, url):
        code, body = _post(f"{url}/v1/predict", {"input": x.tolist()})
        stats = dict(srv.app.stats)
    assert code == 200
    got = np.asarray(json.loads(body)["prob"], np.float32)
    assert got.shape == (n, 10)
    np.testing.assert_allclose(got, fn(x), atol=PROB_ATOL, rtol=0)
    assert stats == {"device_calls": -(-n // BATCH), "rows": n}


def test_predict_errors_are_json(predict_dirs):
    _, tdir = predict_dirs
    with serving(tdir) as (srv, url):
        for bad in ({"input": [[1.0, 2.0]]}, {"wrong_key": []},
                    {"input": []}, [1, 2]):
            code, body = _post(f"{url}/v1/predict", bad)
            assert code == 400 and "error" in json.loads(body), bad
        code, body = _post(f"{url}/v1/generate", {"prompt": [[1]]})
        assert code == 404 and "/v1/predict" in json.loads(body)["error"]
        assert _get(f"{url}/nope")[0] == 404
        assert srv.app.stats == {"device_calls": 0, "rows": 0}

        def broken(x):
            raise RuntimeError("device fell over")

        real, srv.app.fn = srv.app.fn, broken
        code, body = _post(f"{url}/v1/predict",
                           {"input": _rows(1, 0).tolist()})
        assert code == 500 and "device fell over" in json.loads(body)["error"]
        srv.app.fn = real
        assert _post(f"{url}/v1/predict",
                     {"input": _rows(1, 0).tolist()})[0] == 200


def test_continuous_predict_bundle_is_refused(predict_dirs):
    with pytest.raises(ValueError, match="generation bundles only"):
        serve_mod.make_server(predict_dirs[1], port=0, continuous=True,
                              device="cpu")


@pytest.mark.parametrize("coalesce", [True, False],
                         ids=["coalesce", "serialized"])
def test_concurrent_single_rows(predict_dirs, coalesce):
    """Eight single-row clients behind a held device: coalesced they share
    dispatches; serialized each is a call of its own. Each answer equals
    its row run alone (padded to the batch)."""
    _, tdir = predict_dirs
    xs = _rows(8, 7)
    with serving(tdir, coalesce=coalesce) as (srv, url):
        app = srv.app
        real = app.fn

        def held(x):  # hold the device so the queue builds up
            time.sleep(0.1)
            return real(x)

        app.fn = held
        replies = _concurrently(
            lambda i: _post(f"{url}/v1/predict",
                            {"input": xs[i:i + 1].tolist()}), range(8))
        app.fn = real
        alone = [app._run_rows([row])[0] for row in xs]
        stats = dict(app.stats)
    for (code, body), want in zip(replies, alone):
        assert code == 200
        np.testing.assert_array_equal(
            np.asarray(json.loads(body)["prob"], np.float32)[0], want)
    assert stats["rows"] == 8
    if coalesce:
        assert stats["device_calls"] < 8, stats
    else:
        assert stats["device_calls"] == 8, stats


# -- generation


def test_coalesced_generation_matches_the_jax_server(lm, gen_dirs, solo,
                                                     tmp_path):
    jm, params, _ = lm
    jdir = jserving.export_generate(
        str(tmp_path), jm, params, batch_size=GEN_BATCH, prompt_len=T0,
        max_new_tokens=NEW, timestamp="jax")
    with serving(jdir, jax_server=True) as (_, jurl), \
            serving(gen_dirs["greedy"]) as (srv, turl):
        calls = [(u, p) for p in PROMPTS for u in (jurl, turl)]
        replies = _concurrently(
            lambda a: _post(f"{a[0]}/v1/generate", {"prompt": [a[1]]}),
            calls)
        stats = dict(srv.app.stats)
    for i, p in enumerate(PROMPTS):
        (jc, jb), (tc, tb) = replies[2 * i], replies[2 * i + 1]
        assert jc == tc == 200
        assert json.loads(tb)["tokens"] == json.loads(jb)["tokens"], p
        assert json.loads(tb)["tokens"] == [solo["greedy"][i]]
    assert stats["rows"] == len(PROMPTS)
    assert stats["device_calls"] <= len(PROMPTS)


def test_speculative_bundle_served_over_http(gen_dirs, solo):
    with serving(gen_dirs["speculative"]) as (_, url):
        code, body = _post(f"{url}/v1/generate", {"prompt": PROMPTS[:5]})
    assert code == 200
    assert json.loads(body)["tokens"] == solo["greedy"][:5]


def test_sampled_bundle_is_deterministic_per_seed(gen_dirs):
    prompts = PROMPTS[:6]  # more rows than the batch: two batch groups
    want = load_generate(gen_dirs["sampled"], device="cpu").generate_tokens(
        prompts, seed=3)
    with serving(gen_dirs["sampled"]) as (srv, url):
        replies = _concurrently(
            lambda s: _post(f"{url}/v1/generate",
                            {"prompt": prompts, "seed": s}), [3, 3, 4])
        stats = dict(srv.app.stats)
    tokens = [json.loads(b)["tokens"] for c, b in replies if c == 200]
    assert len(tokens) == 3
    assert tokens[0] == tokens[1] == want
    assert tokens[2] != want
    assert stats == {"device_calls": 6, "rows": 18}


def test_streaming_bundle_on_the_coalescing_app(gen_dirs, solo):
    with serving(gen_dirs["stream"]) as (srv, url):
        assert srv.app.engine is None
        replies = _concurrently(
            lambda p: _post(f"{url}/v1/generate",
                            {"prompt": [p], "stream": True}), PROMPTS[:4])
        code, body = _post(f"{url}/v1/generate", {"prompt": PROMPTS[:2],
                                                  "stream": True})
        two = [json.loads(ln) for ln in body.splitlines()]
        assert code == 200 and two[-1]["tokens"] == solo["greedy"][:2]
        assert len(two) == NEW // CHUNK + 1
        stats = dict(srv.app.stats)
    for (code, body), want in zip(replies, solo["greedy"]):
        lines = [json.loads(ln) for ln in body.splitlines()]
        assert code == 200 and lines[-1] == {"done": True, "tokens": [want]}
        assert sum((ln["tokens"][0] for ln in lines[:-1]), []) == want
    assert stats == {"device_calls": 5 * NEW // CHUNK, "rows": 6}


@pytest.mark.parametrize("name", ["greedy", "sampled", "stream"])
def test_invalid_requests_never_reach_stats(gen_dirs, name):
    with serving(gen_dirs[name]) as (srv, url):
        for bad in ({"prompt": [list(range(T0 + 1))]}, {"prompt": [[]]},
                    {"text": ["hi"]}, {"nope": 1},
                    {"prompt": [[1]] * (GEN_BATCH + 1), "stream": True}):
            code, body = _post(f"{url}/v1/generate", bad)
            assert code == 400 and "error" in json.loads(body), bad
        assert srv.app.stats == {"device_calls": 0, "rows": 0}


# -- /metrics


def test_metrics_count_requests_by_route_and_code(gen_dirs):
    with serving(gen_dirs["stream"]) as (srv, url), \
            serving(gen_dirs["greedy"]) as (other, _):
        for payload in ({"prompt": [[1, 2]]}, {"prompt": [[3]]},
                        {"prompt": [[4]], "stream": True},
                        {"prompt": [[]]}):
            _post(f"{url}/v1/generate", payload)
        _post(f"{url}/v1/predict", {"input": [[0.0]]})
        _get(f"{url}/nope")
        code, text = _get(f"{url}/metrics")
        stats = dict(srv.app.stats)
        other_text = _get(
            f"http://127.0.0.1:{other.server_address[1]}/metrics")[1]
    assert code == 200
    m = prom.parse_text(text)
    req = 'hvt_serve_requests_total{route="%s",code="%s"}'
    assert m[req % ("/v1/generate", "200")] == 3
    assert m[req % ("/v1/generate", "400")] == 1
    assert m[req % ("/v1/predict", "404")] == 1
    assert m[req % ("other", "404")] == 1
    assert m["hvt_serve_ttft_seconds_count"] == 3
    assert m["hvt_serve_tpot_seconds_count"] == 3
    assert m['hvt_serve_request_seconds_count{route="/v1/generate"}'] == 3
    assert m["hvt_serve_device_calls_total"] == stats["device_calls"]
    assert m["hvt_serve_rows_total"] == stats["rows"] == 3
    assert m["hvt_serve_queue_depth"] == 0
    assert not any('code="500"' in k for k in m)
    # Two servers in one process keep private registries.
    assert srv.metrics_registry is not other.metrics_registry
    om = prom.parse_text(other_text)
    assert not any(k.startswith("hvt_serve_requests_total") for k in om)
    assert om["hvt_serve_device_calls_total"] == 0


def test_continuous_metrics_mirror_the_engine(gen_dirs):
    with serving(gen_dirs["stream"], continuous=True) as (srv, url):
        assert _post(f"{url}/v1/generate", {"prompt": PROMPTS[:3]})[0] == 200
        m = prom.parse_text(_get(f"{url}/metrics")[1])
        sched = srv.app.engine.stats()
        health = json.loads(_get(f"{url}/healthz")[1])
    assert m["hvt_serve_device_calls_total"] == sched["device_calls_total"]
    assert m["hvt_serve_admitted_total"] == m["hvt_serve_retired_total"] == 3
    assert m["hvt_serve_live_seqs"] == 0
    assert health["scheduler"]["retired_total"] == 3
    assert health["inflight"] == 0 and health["stats"]["rows"] == 3


# -- /admin/reload


def test_reload_is_opt_in_and_validated(gen_dirs, predict_dirs):
    with serving(gen_dirs["greedy"]) as (_, url):
        code, body = _post(f"{url}/admin/reload",
                           {"bundle_dir": gen_dirs["greedy_b"]})
        assert code == 404 and "--allow-reload" in body
    with serving(gen_dirs["greedy"], allow_reload=True) as (srv, url):
        assert _post(f"{url}/admin/reload", {})[0] == 400
        assert _post(f"{url}/admin/reload", {"dir": "x"})[0] == 400
        assert srv.app.bundle_dir == gen_dirs["greedy"]
    with serving(predict_dirs[1], allow_reload=True) as (_, url):
        code, body = _post(f"{url}/admin/reload",
                           {"bundle_dir": predict_dirs[1]})
        assert code == 400 and "do not support reload" in body


@pytest.mark.parametrize("mode", ["coalesce", "continuous"])
def test_reload_swaps_a_to_b_under_traffic(gen_dirs, solo, mode):
    continuous = mode == "continuous"
    a, b = (("stream", "stream_b") if continuous
            else ("greedy", "greedy_b"))
    assert solo["greedy"] != solo["greedy_b"]
    stop = threading.Event()
    replies = []  # (sent after the swap returned, prompt index, code, body)
    swapped = threading.Event()

    def client(k):
        i = k
        while not stop.is_set():
            i = (i + 1) % len(PROMPTS)
            after = swapped.is_set()
            code, body = _post(f"{url}/v1/generate", {"prompt": [PROMPTS[i]]})
            replies.append((after, i, code, body))

    with serving(gen_dirs[a], continuous=continuous,
                 allow_reload=True) as (srv, url):
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        t0 = time.perf_counter()
        code, body = _post(f"{url}/admin/reload",
                           {"bundle_dir": gen_dirs[b]})
        swap_s = time.perf_counter() - t0
        swapped.set()
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert code == 200 and json.loads(body)["bundle"] == gen_dirs[b]
        health = json.loads(_get(f"{url}/healthz")[1])
    assert health["bundle"] == gen_dirs[b] and swap_s < 30
    before = [r for r in replies if not r[0]]
    after = [r for r in replies if r[0]]
    assert before and after
    for sent_after, i, code, body in replies:
        assert code == 200, body
        got = json.loads(body)["tokens"][0]
        if sent_after:
            assert got == solo["greedy_b"][i]
        else:
            assert got in (solo["greedy"][i], solo["greedy_b"][i])


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["coalesce", "continuous"])
def test_a_bundle_that_fails_to_load_leaves_the_old_serving(gen_dirs, solo,
                                                            tmp_path,
                                                            continuous):
    name = "stream" if continuous else "greedy"
    with serving(gen_dirs[name], continuous=continuous,
                 allow_reload=True) as (srv, url):
        code, body = _post(f"{url}/admin/reload",
                           {"bundle_dir": str(tmp_path / "missing")})
        assert code == 500 and "missing" in json.loads(body)["error"]
        assert srv.app.bundle_dir == gen_dirs[name]
        code, body = _post(f"{url}/v1/generate", {"prompt": [PROMPTS[1]]})
    assert code == 200 and json.loads(body)["tokens"] == [solo["greedy"][1]]


def test_continuous_reload_refuses_when_the_drain_times_out(gen_dirs, solo,
                                                            monkeypatch):
    monkeypatch.setenv("HVT_SERVE_DRAIN_TIMEOUT_S", "0.05")
    with serving(gen_dirs["stream"], continuous=True,
                 allow_reload=True) as (srv, url):
        decoder = srv.app.engine.decoder
        real = decoder.step

        def slow(state):  # keep a sequence live through the drain
            time.sleep(0.3)
            return real(state)

        decoder.step = slow
        pending = concurrent.futures.ThreadPoolExecutor(1).submit(
            _post, f"{url}/v1/generate", {"prompt": [PROMPTS[0]]})
        deadline = time.monotonic() + 30
        while srv.app.engine.stats()["live_seqs"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, body = _post(f"{url}/admin/reload",
                           {"bundle_dir": gen_dirs["stream_b"]})
        assert code == 500 and "refusing" in json.loads(body)["error"]
        assert pending.result(timeout=60)[0] == 200
        decoder.step = real
        code, body = _post(f"{url}/v1/generate", {"prompt": [PROMPTS[0]]})
        assert srv.app.bundle_dir == gen_dirs["stream"]
    assert code == 200 and json.loads(body)["tokens"] == [solo["greedy"][0]]


# -- the launched server


def test_sigterm_drains_in_flight_requests(tmp_path):
    model = ttr.TransformerLM(vocab_size=VOCAB, d_model=32, n_heads=4,
                              n_layers=2, dropout=0.0, device="cpu", seed=3)
    new = 96
    d = export_generate(str(tmp_path), model, batch_size=2, prompt_len=T0,
                        max_new_tokens=new, timestamp="drain")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launch.serve", d,
         "--device", "cpu", "--port", "0", "--host", "127.0.0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving" in line, proc.stderr.read()
        url = line.split(" on ")[1].split()[0]
        pool = concurrent.futures.ThreadPoolExecutor(6)
        futs = [pool.submit(_post, f"{url}/v1/generate",
                            {"prompt": [PROMPTS[i]]}) for i in range(6)]
        deadline = time.monotonic() + 60
        while json.loads(_get(f"{url}/healthz")[1])["inflight"] < 3:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        replies = [f.result(timeout=90) for f in futs]
        assert proc.wait(timeout=90) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    for code, body in replies:
        assert code == 200, body
        assert len(json.loads(body)["tokens"][0]) == new


def test_control_plane_flags_are_refused(capsys):
    for flag in ("--fleet-journal", "--coordinator", "--member"):
        with pytest.raises(SystemExit) as e:
            serve_mod.main(["some/bundle", flag, "x"])
        assert e.value.code == 2
        assert "item 13" in capsys.readouterr().err
