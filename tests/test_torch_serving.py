"""horovod_tpu_torch.serving + launch.serve on the CPU: bundle round trip,
row splicing, the continuous-batching engine, the block allocator and the
HTTP server (the same behaviours `tests/test_serving_engine.py` and
`tests/test_serve.py` hold the JAX package to).

The serving contract is the ragged one: every request's tokens equal the
bundle run on that prompt alone. Greedy, so the comparison is exact.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu_torch.launch import serve as serve_mod
from horovod_tpu_torch.models.decoding import generate
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.serving import (
    export_generate,
    is_generate_bundle,
    load_generate,
)
from horovod_tpu_torch.serving.blocks import BlockAllocator, OutOfBlocksError
from horovod_tpu_torch.serving.decoder import ChunkedBundleDecoder
from horovod_tpu_torch.serving.engine import (
    AdmissionError,
    ContinuousBatchingEngine,
)

VOCAB, BATCH, T0, NEW, CHUNK = 64, 4, 12, 8, 4

# The JAX bundle's generate.json keys (horovod_tpu/serving/bundle.py).
JAX_META_KEYS = {
    "kind", "batch_size", "prompt_len", "max_new_tokens", "temperature",
    "top_k", "top_p", "eos_id", "pad_id", "int8_compute", "quantized_cache",
    "speculative_gamma", "streaming_chunk", "has_tokenizer", "created",
}


def _model():
    return TransformerLM(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
                         dropout=0.0, device="cpu", seed=1)


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return export_generate(
        str(tmp_path_factory.mktemp("bundles")), _model(), batch_size=BATCH,
        prompt_len=T0, max_new_tokens=NEW, streaming_chunk=CHUNK,
        timestamp="stream",
    )


@pytest.fixture(scope="module")
def bundle(bundle_dir):
    return load_generate(bundle_dir, device="cpu")


def _solo(bundle, prompt):
    return bundle.generate_batch([np.asarray(prompt, np.int32)])[0]


# -- bundle ------------------------------------------------------------------


def test_bundle_round_trip(bundle_dir, bundle, tmp_path):
    assert is_generate_bundle(bundle_dir)
    with open(os.path.join(bundle_dir, "generate.json")) as f:
        meta = json.load(f)
    assert JAX_META_KEYS <= set(meta)
    assert meta["model"]["d_model"] == 32 and meta["streaming_chunk"] == CHUNK
    ref = _model()
    for name, t in ref.state_dict().items():
        assert torch.equal(bundle.model.state_dict()[name], t), name
    prompts = [[3], [1, 2, 40, 7], list(range(T0))]
    got = bundle.generate_tokens(prompts)
    for p, g in zip(prompts, got):
        assert g == generate(ref, torch.tensor([p]), NEW,
                             include_prompt=False)[0].tolist()
    # a one-shot (non-streaming) bundle of the same model agrees
    one = load_generate(export_generate(
        str(tmp_path), ref, batch_size=BATCH, prompt_len=T0,
        max_new_tokens=NEW, timestamp="oneshot"), device="cpu")
    assert one.generate_tokens(prompts) == got


def test_stream_chunks_concatenate_to_generate_batch(bundle):
    prompts = [[5, 6], [9]]
    chunks = list(bundle.stream_chunks(prompts))
    assert len(chunks) == NEW // CHUNK
    rows = [sum((c[i] for c in chunks), []) for i in range(2)]
    assert rows == bundle.generate_batch([np.asarray(p) for p in prompts])


def test_over_batch_requests_split(bundle):
    prompts = [[i + 1] for i in range(BATCH + 2)]
    out = bundle.generate_tokens(prompts)
    assert len(out) == BATCH + 2 and all(len(r) == NEW for r in out)
    assert out[-1] == _solo(bundle, prompts[-1])


@pytest.mark.parametrize("bad", [[], list(range(T0 + 1))])
def test_prompt_lengths_validated(bundle, bad):
    with pytest.raises(ValueError):
        bundle.validate_prompts([bad])


def test_export_rejects_unported_knobs(tmp_path):
    """Refused exports write nothing. The tokenizer and speculative knobs
    are ported since: what is refused now is what the JAX bundle refuses
    (a missing tokenizer file, a sampled or eos speculative bundle,
    int8_compute beside speculative or streaming, speculative + streaming,
    a chunk that does not divide max_new_tokens)."""
    m = _model()
    kw = dict(batch_size=2, prompt_len=4, max_new_tokens=4)
    with pytest.raises(FileNotFoundError):
        export_generate(str(tmp_path), m, tokenizer="tok.json", **kw)
    for bad in (dict(speculative_gamma=2, temperature=0.5),
                dict(speculative_gamma=2, eos_id=1),
                dict(speculative_gamma=2, int8_compute=True),
                dict(speculative_gamma=2, streaming_chunk=2),
                dict(streaming_chunk=2, int8_compute=True),
                dict(streaming_chunk=3)):
        with pytest.raises(ValueError):
            export_generate(str(tmp_path), m, **bad, **kw)
    assert not os.listdir(tmp_path)  # nothing written for a refused export


def test_jax_bundle_is_refused_with_guidance(tmp_path):
    (tmp_path / "generate.json").write_text(json.dumps(
        {"kind": "generate", "batch_size": 1, "prompt_len": 2}))
    with pytest.raises(ValueError, match="horovod_tpu_torch"):
        load_generate(str(tmp_path), device="cpu")


# -- decoder splice ----------------------------------------------------------


def test_splice_moves_fresh_rows_into_a_live_state(bundle):
    dec = ChunkedBundleDecoder(bundle)
    a, b = [1, 2, 3], [40, 41]
    toks_a, live = dec.prefill([a], seed=0, admission=0)
    toks_b, fresh = dec.prefill([b], seed=0, admission=1)
    live = dec.splice(live, fresh, [0], [2])
    got_a, got_b = list(toks_a[0]), list(toks_b[0])
    for _ in range(NEW // CHUNK - 1):
        toks, live = dec.step(live)
        got_a += toks[0].tolist()
        got_b += toks[2].tolist()
    assert got_a == _solo(bundle, a)
    assert got_b == _solo(bundle, b)
    assert not dec.done_flags(live).any()
    with pytest.raises(ValueError):
        dec.splice(live, fresh, [0, 1], [2])


def test_decoder_needs_a_streaming_bundle(tmp_path):
    one = load_generate(export_generate(
        str(tmp_path), _model(), batch_size=2, prompt_len=4,
        max_new_tokens=4, timestamp="x"), device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        ChunkedBundleDecoder(one)


# -- engine ------------------------------------------------------------------


def _engine(bundle, **kw):
    return ContinuousBatchingEngine(bundle, start_thread=False, **kw)


def test_engine_tokens_match_solo_generation(bundle):
    eng = _engine(bundle)
    prompts = [[3], [1, 2, 40], list(range(T0))]
    reqs = [eng.submit(p) for p in prompts]
    for _ in range(NEW // CHUNK):
        eng.tick()
    for r, p in zip(reqs, prompts):
        assert r.result(1) == _solo(bundle, p)
    s = eng.stats()
    assert s["live_seqs"] == 0 and s["retired_total"] == 3
    assert s["kv_blocks_free"] == s["kv_blocks_total"]
    assert s["prefill_calls_total"] == 1


def test_mid_flight_admission_and_retire_same_tick(bundle):
    eng = _engine(bundle, max_seqs=2)
    first = [eng.submit([i + 1]) for i in range(3)]
    # NEW // CHUNK == 2: the prefill delivers chunk 1, the step chunk 2,
    # so both admitted rows finish and retire within the same tick.
    assert eng.tick() == {"admitted": 2, "evicted": 2, "live": 0}
    late = eng.submit([9, 9])
    assert eng.tick() == {"admitted": 2, "evicted": 2, "live": 0}
    for r in first + [late]:
        assert r.result(1) == _solo(bundle, r.prompt)


def test_queue_full_and_oversized_requests(bundle):
    eng = _engine(bundle, queue_depth=2)
    eng.submit([1])
    eng.submit([2])
    with pytest.raises(AdmissionError):
        eng.submit([3])
    assert eng.stats()["rejected_total"] == 1
    tiny = _engine(bundle, kv_blocks=1, block_tokens=4)
    with pytest.raises(ValueError):
        tiny.submit([1])  # needs ceil((1 + 8) / 4) = 3 blocks of 1


def test_block_budget_gates_admission_fifo(bundle):
    # [i + 1] + NEW tokens fit one 16-token block: room for two sequences.
    eng = _engine(bundle, kv_blocks=2)
    reqs = [eng.submit([i + 1]) for i in range(3)]
    assert eng.tick()["admitted"] == 2
    assert reqs[2].slot is None
    while not reqs[2].finished:
        eng.tick()
    assert reqs[2].result(1) == _solo(bundle, [3])


def test_eos_retires_early_and_frees_slot(tmp_path):
    m = _model()
    probe = generate(m, torch.tensor([[5, 6]]), NEW, include_prompt=False)
    eos = int(probe[0, 1])  # the second generated token
    b = load_generate(export_generate(
        str(tmp_path), m, batch_size=2, prompt_len=T0, max_new_tokens=NEW,
        streaming_chunk=CHUNK, eos_id=eos, timestamp="eos"), device="cpu")
    eng = _engine(b)
    r = eng.submit([5, 6])
    eng.tick()
    assert r.result(1) == [int(probe[0, 0])]
    assert eng.stats()["live_seqs"] == 0


def test_scheduler_thread_end_to_end_and_stop(bundle):
    eng = ContinuousBatchingEngine(bundle)
    try:
        reqs = [eng.submit([i + 1, 7], stream=(i % 2 == 0))
                for i in range(BATCH + 2)]
        for r in reqs:
            if r.stream:
                assert sum(r.iter_chunks(), []) == _solo(bundle, r.prompt)
            assert r.result(30) == _solo(bundle, r.prompt)
        stats = eng.stats()
        assert stats["live_seqs"] == 0 and stats["queue_depth"] == 0
    finally:
        eng.stop()
    assert not eng._thread.is_alive()


def test_engine_trace_spans(bundle, tmp_path, monkeypatch):
    monkeypatch.setenv("HVT_TRACE_DIR", str(tmp_path))
    eng = _engine(bundle)
    eng.submit([4])
    eng.tick()
    (path,) = [p for p in tmp_path.iterdir() if p.name.startswith("spans-")]
    names = [json.loads(ln)["name"] for ln in path.read_text().splitlines()]
    assert {"decode", "step", "queue_wait"} <= set(names)


# -- block allocator ---------------------------------------------------------


def test_blocks_for_and_reuse():
    a = BlockAllocator(4, 16)
    assert a.blocks_for(1) == 1 and a.blocks_for(17) == 2
    t1 = a.reserve(32)
    t2 = a.reserve(32)
    assert a.free_blocks == 0
    with pytest.raises(OutOfBlocksError):
        a.reserve(1)
    a.free(t1)
    assert a.reserve(20).block_ids == t1.block_ids  # LIFO reuse
    with pytest.raises(ValueError):
        a.reserve(16 * 4 + 1)  # larger than the whole budget
    a.free(t2)
    with pytest.raises(ValueError):
        a.free(t2)  # double free


# -- HTTP server -------------------------------------------------------------


@pytest.fixture
def server(bundle_dir):
    srv = serve_mod.make_server(bundle_dir, port=0, device="cpu",
                                continuous=True)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    srv.app.engine.stop()
    th.join(timeout=10)
    assert not th.is_alive()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_generate_plain_and_streaming(server, bundle):
    srv, url = server
    health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
    assert health["status"] == "ok" and health["kind"] == "generate"
    assert health["signature"]["inputs"]["prompt"]["shape"] == [BATCH, T0]
    prompts = [[1, 2, 3], [60]]
    code, body = _post(f"{url}/v1/generate", {"prompt": prompts})
    assert code == 200
    want = [_solo(bundle, p) for p in prompts]
    assert json.loads(body)["tokens"] == want
    code, body = _post(f"{url}/v1/generate",
                       {"prompt": prompts[:1], "stream": True})
    lines = [json.loads(ln) for ln in body.splitlines()]
    assert code == 200 and lines[-1] == {"done": True, "tokens": want[:1]}
    assert sum((ln["tokens"][0] for ln in lines[:-1]), []) == want[0]
    assert len(lines) - 1 == NEW // CHUNK
    code, body = _post(f"{url}/v1/generate", {"prompt": prompts,
                                              "stream": True})
    lines = [json.loads(ln) for ln in body.splitlines()]
    assert {ln["row"] for ln in lines[:-1]} == {0, 1}
    stats = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
    assert stats["scheduler"]["retired_total"] == 5
    assert stats["stats"]["rows"] == 5


@pytest.mark.parametrize("payload,code", [
    ({"prompt": [list(range(T0 + 1))]}, 400),
    ({"prompt": [[]]}, 400),
    ({"text": ["hi"]}, 400),
    ({"nope": 1}, 400),
    ({"prompt": [[1]], "stream": True, "x": 0}, 200),
])
def test_server_status_codes(server, payload, code):
    _, url = server
    got, body = _post(f"{url}/v1/generate", payload)
    assert got == code, body
    if code != 200:
        assert "error" in json.loads(body)


def test_server_404_and_429(server, monkeypatch):
    srv, url = server
    assert _post(f"{url}/v1/predict", {"input": [[1]]})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope")
    assert e.value.code == 404

    def full(*a, **k):
        raise AdmissionError("serving queue full")

    monkeypatch.setattr(srv.app.engine, "submit", full)
    assert _post(f"{url}/v1/generate", {"prompt": [[1]]})[0] == 429


def test_server_sizes_engine_from_knobs(bundle_dir, monkeypatch):
    monkeypatch.setenv("HVT_SERVE_MAX_SEQS", "2")
    monkeypatch.setenv("HVT_SERVE_QUEUE_DEPTH", "5")
    srv = serve_mod.make_server(bundle_dir, port=0, device="cpu",
                                continuous=True)
    try:
        assert srv.app.engine.max_seqs == 2
        assert srv.app.engine.queue_depth == 5
    finally:
        srv.server_close()
        srv.app.engine.stop()
