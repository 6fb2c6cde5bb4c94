"""The decode knobs of `horovod_tpu_torch.serving.export_generate` — the
tokenizer, ``int8_compute``, ``quantized_cache``, ``speculative_gamma`` —
round-tripped through a bundle and held against the JAX package's
generators on the same weights (`params_from_flax`), greedy and ragged, so
the tokens are compared exactly; and ``/v1/generate`` with ``text``: text
in, text and tokens out (also in the stream's final line), with the JAX
server's 400s.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.data import tokenizer as jtok
from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import speculative as jspec
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer
from horovod_tpu_torch.launch import serve as serve_mod
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving import export_generate, load_generate

BATCH, T0, NEW = 3, 12, 8
CORPUS = ["the quick brown fox jumps over the lazy dog"] * 4 + [
    "a lazy dog and a quick fox", "the end <eos>"]


@pytest.fixture(scope="module")
def tokenizer():
    return ByteBPETokenizer.train(CORPUS, 300, specials=("<eos>",))


@pytest.fixture(scope="module")
def pair(tokenizer):
    cfg = dict(vocab_size=tokenizer.vocab_size, d_model=32, n_heads=4,
               n_layers=2, dropout=0.0)
    jm = jtr.TransformerLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    tm = ttr.TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm


def _prompts(tokenizer):
    return [tokenizer.encode(s) for s in
            ("the quick brown", "a lazy dog and a quick fox", "fox")]


def _jax_padded(prompts):
    padded = np.zeros((BATCH, T0), np.int32)
    lengths = np.ones((BATCH,), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
        lengths[i] = len(p)
    return jnp.asarray(padded), jnp.asarray(lengths)


def _export(tmp_path, tm, name, **kw):
    return export_generate(str(tmp_path), tm, batch_size=BATCH,
                           prompt_len=T0, max_new_tokens=NEW,
                           timestamp=name, **kw)


@pytest.mark.parametrize("knobs", [{}, {"int8_compute": True},
                                   {"quantized_cache": True},
                                   {"int8_compute": True,
                                    "quantized_cache": True}],
                         ids=["plain", "int8_compute", "int8_cache", "both"])
def test_generate_bundle_matches_jax(tmp_path, pair, tokenizer, knobs):
    jm, params, tm = pair
    d = _export(tmp_path, tm, "b", tokenizer=tokenizer, **knobs)
    b = load_generate(d, device="cpu")
    assert {k: b.meta[k] for k in knobs} == knobs
    prompts = _prompts(tokenizer)
    got = b.generate_tokens(prompts)
    fn = jdec.make_generate_fn(jm, max_new_tokens=NEW, include_prompt=False,
                               **knobs)
    want = np.asarray(fn(params, *_jax_padded(prompts)[:1],
                         jax.random.PRNGKey(0), _jax_padded(prompts)[1]))
    assert got == want.tolist()
    texts = ["the quick brown", "a lazy dog and a quick fox", "fox"]
    assert b.generate_text(texts) == [tokenizer.decode(g) for g in got]


@pytest.mark.parametrize("qc", [False, True], ids=["plain", "int8_cache"])
def test_speculative_bundle_matches_jax(tmp_path, pair, tokenizer, qc):
    jm, params, tm = pair
    d = _export(tmp_path, tm, "s", tokenizer=tokenizer, speculative_gamma=4,
                quantized_cache=qc)
    b = load_generate(d, device="cpu")
    prompts = _prompts(tokenizer)
    got = b.generate_tokens(prompts, seed=7)  # the seed is unused
    target = jm.clone(quantized_cache=True) if qc else jm
    fn = jspec.make_speculative_fn(target, max_new_tokens=NEW, gamma=4,
                                   include_prompt=False)
    padded, lengths = _jax_padded(prompts)
    want = np.asarray(fn(params, padded, None, lengths))
    assert got == want.tolist()
    plain = load_generate(_export(tmp_path, tm, "p", quantized_cache=qc),
                          device="cpu")
    assert got == plain.generate_tokens(prompts)


def test_streaming_int8_cache_bundle_streams_the_one_shot_tokens(tmp_path,
                                                                 pair):
    _, _, tm = pair
    s = load_generate(_export(tmp_path, tm, "st", quantized_cache=True,
                              streaming_chunk=4), device="cpu")
    o = load_generate(_export(tmp_path, tm, "os", quantized_cache=True),
                      device="cpu")
    prompts = [[1, 2, 3, 4], [9], [5, 6, 7, 8, 9, 10, 11]]
    assert s.generate_tokens(prompts) == o.generate_tokens(prompts)


def test_tokenizer_travels_as_a_path_and_from_jax(tmp_path, pair):
    """A tokenizer the JAX package saved, exported by path, loads as the
    port's and encodes as JAX's does."""
    _, _, tm = pair
    j = jtok.ByteBPETokenizer.train(CORPUS, 300, specials=("<eos>",))
    path = str(tmp_path / "jax-tokenizer.json")
    j.save(path)
    b = load_generate(_export(tmp_path, tm, "t", tokenizer=path),
                      device="cpu")
    assert b.meta["has_tokenizer"]
    assert b.tokenizer.merges == j.merges
    assert b.tokenizer.encode("the lazy fox") == j.encode("the lazy fox")
    with pytest.raises(ValueError, match="tokenizes to"):
        b.encode_texts(["the quick brown fox jumps over the lazy dog " * 3])


def test_missing_tokenizer_file_is_an_incomplete_bundle(tmp_path, pair,
                                                        tokenizer):
    _, _, tm = pair
    d = _export(tmp_path, tm, "m", tokenizer=tokenizer)
    (tmp_path / "m" / "tokenizer.json").unlink()
    with pytest.raises(FileNotFoundError, match="incomplete"):
        load_generate(d, device="cpu")
    b = load_generate(_export(tmp_path, tm, "n"), device="cpu")
    with pytest.raises(ValueError, match="no tokenizer"):
        b.generate_text(["fox"])


# -- /v1/generate with text ----------------------------------------------------


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve(bundle_dir):
    srv = serve_mod.make_server(bundle_dir, port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}/v1/generate"


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    srv.app.close()
    th.join(timeout=10)
    assert not th.is_alive()


def test_server_takes_text_and_returns_text(tmp_path, pair, tokenizer):
    _, _, tm = pair
    d = _export(tmp_path, tm, "srv", tokenizer=tokenizer,
                quantized_cache=True, streaming_chunk=4)
    bundle = load_generate(d, device="cpu")
    srv, th, url = _serve(d)
    try:
        texts = ["the quick brown", "fox"]
        want = [bundle.generate_tokens([tokenizer.encode(t)])[0]
                for t in texts]
        code, body = _post(url, {"text": texts})
        assert code == 200
        out = json.loads(body)
        assert out["tokens"] == want
        assert out["text"] == [tokenizer.decode(g) for g in want]
        code, body = _post(url, {"text": texts[:1], "stream": True})
        lines = [json.loads(ln) for ln in body.splitlines()]
        assert code == 200 and lines[-1]["done"]
        assert lines[-1]["text"] == [tokenizer.decode(want[0])]
        assert sum((ln["tokens"][0] for ln in lines[:-1]), []) == want[0]
        # The JAX server's 400s.
        for bad in ({"text": texts, "prompt": [[1]]}, {"text": "fox"},
                    {"text": ["the quick brown fox jumps over " * 4]}):
            code, body = _post(url, bad)
            assert code == 400, bad
        assert "not both" in _post(url, {"text": ["a"], "prompt": [[1]]})[1]
    finally:
        _stop(srv, th)


def test_text_without_a_tokenizer_is_a_400(tmp_path, pair):
    _, _, tm = pair
    d = _export(tmp_path, tm, "notok", streaming_chunk=4)
    srv, th, url = _serve(d)
    try:
        code, body = _post(url, {"text": ["fox"]})
        assert code == 400 and "no tokenizer" in body
        code, body = _post(url, {"prompt": [[1, 2]]})
        assert code == 200 and "text" not in json.loads(body)
    finally:
        _stop(srv, th)
