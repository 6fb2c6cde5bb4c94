"""Sequence packing in the port (`horovod_tpu_torch.data.packing`) against
the JAX package's `horovod_tpu.data.packing`: ``tests/test_packing.py``'s
cases, with every output byte-equal to JAX's on the same documents, and the
resumable `PackedLMStream` (its batches, cursor and refusals) byte-equal
too."""

import numpy as np
import pytest

from horovod_tpu.data import packing as jp
from horovod_tpu.data import stream as jstream
from horovod_tpu_torch.data import packing as tp
from horovod_tpu_torch.data import stream as tstream


def _docs(seed=0, n=40, lo=3, hi=40, vocab=64):
    rng = np.random.RandomState(seed)
    return [
        rng.randint(1, vocab, size=rng.randint(lo, hi)).astype(np.int32)
        for _ in range(n)
    ]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed,seq_len,kw", [
    (0, 64, {}),
    (1, 48, {"pad_id": 0}),
    (2, 64, {}),
    (5, 33, {"pad_id": 7}),
    (6, 64, {"max_docs_per_row": 2}),
    (7, 16, {"drop_overlong": True}),
    (8, 16, {}),
], ids=["reconstruct", "static_shapes", "efficiency", "pad_id",
        "max_docs_per_row", "drop_overlong", "split_overlong"])
def test_pack_documents_equals_jax(seed, seq_len, kw):
    docs = _docs(seed)
    got = tp.pack_documents(docs, seq_len=seq_len, **kw)
    _same(got, jp.pack_documents(docs, seq_len=seq_len, **kw))
    assert tp.packing_efficiency(got[1]) == jp.packing_efficiency(got[1])


def test_reconstructs_every_document():
    docs = _docs()
    toks, seg, doc = tp.pack_documents(docs, seq_len=64)
    for i, d in enumerate(docs):
        rows, cols = np.where(doc == i)
        assert len(rows) == len(d)
        assert (rows == rows[0]).all()
        assert (np.diff(cols) == 1).all()
        np.testing.assert_array_equal(toks[rows[0], cols], d)
        assert len(set(seg[rows[0], cols].tolist())) == 1


def test_static_shapes_and_padding_segment():
    toks, seg, doc = tp.pack_documents(_docs(1), seq_len=48, pad_id=0)
    assert toks.shape == seg.shape == doc.shape
    assert toks.shape[1] == 48
    pad = seg == 0
    assert (toks[pad] == 0).all()
    assert (doc[pad] == -1).all()


def test_efficiency_beats_one_doc_per_row():
    docs = _docs(2)
    _, seg, _ = tp.pack_documents(docs, seq_len=64)
    eff = tp.packing_efficiency(seg)
    total = sum(len(d) for d in docs)
    assert eff > total / (len(docs) * 64)
    assert eff > 0.8


def test_overlong_split_or_dropped():
    long = [np.arange(1, 150, dtype=np.int32)]
    toks, seg, doc = tp.pack_documents(long, seq_len=64)
    _same((toks, seg, doc), jp.pack_documents(long, seq_len=64))
    assert len(toks[doc == 0]) == 149
    rows_used = np.unique(np.where(doc == 0)[0])
    assert len(rows_used) == 3
    for r in rows_used:
        assert len(set(seg[r][doc[r] == 0].tolist())) == 1
    _, seg2, _ = tp.pack_documents(long, seq_len=64, drop_overlong=True)
    assert (seg2 == 0).all() if seg2.size else True


def test_max_docs_per_row():
    docs = [[1, 2]] * 10
    _, seg, _ = tp.pack_documents(docs, seq_len=64, max_docs_per_row=2)
    _same(tp.pack_documents(docs, seq_len=64, max_docs_per_row=2),
          jp.pack_documents(docs, seq_len=64, max_docs_per_row=2))
    for row in seg:
        assert len(set(row.tolist()) - {0}) <= 2


def test_bad_seq_len():
    with pytest.raises(ValueError, match="seq_len") as port:
        tp.pack_documents([[1]], seq_len=0)
    with pytest.raises(ValueError) as ref:
        jp.pack_documents([[1]], seq_len=0)
    assert str(port.value) == str(ref.value)


def test_next_token_pairs_mask_stops_at_boundaries():
    toks = np.array([[5, 6, 7, 9, 9, 0]], np.int32)
    seg = np.array([[1, 1, 1, 2, 2, 0]], np.int32)
    x, y, w = tp.next_token_pairs(toks, seg)
    np.testing.assert_array_equal(x, [[5, 6, 7, 9, 9]])
    np.testing.assert_array_equal(y, [[6, 7, 9, 9, 0]])
    np.testing.assert_array_equal(w, [[1, 1, 0, 1, 0]])
    docs = _docs(3)
    t, s, _ = tp.pack_documents(docs, seq_len=65)
    _same(tp.next_token_pairs(t, s), jp.next_token_pairs(t, s))


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["whole", "shard1of2"])
def test_packed_stream_batches_and_cursor_equal_jax(shard):
    docs = _docs(4, n=200)
    ts = tp.PackedLMStream(docs, 32, 4, seed=3, shard=shard)
    js = jp.PackedLMStream(docs, 32, 4, seed=3, shard=shard)
    assert ts.n_rows == js.n_rows
    t_it, j_it = ts.batches(), iter(js)
    for _ in range(3 * max(1, ts.n_rows // (4 * shard[1]))):
        _same(next(t_it), next(j_it))
    cur = ts.stream_cursor(2, 3, batches_per_epoch=5)
    assert cur.to_dict() == js.stream_cursor(2, 3, batches_per_epoch=5).to_dict()
    t_it = ts.batches_from(cur.to_dict())
    j_it = js.batches_from(jstream.StreamCursor.from_dict(cur.to_dict()))
    for _ in range(7):
        _same(next(t_it), next(j_it))


def test_packed_stream_cursor_refusals_match_jax():
    docs = _docs(5, n=80)
    ts = tp.PackedLMStream(docs, 32, 4, seed=1)
    js = jp.PackedLMStream(docs, 32, 4, seed=1)
    cur = ts.stream_cursor(0, 1).to_dict()
    bad = [dict(cur, format=cur["format"] + 1), dict(cur, kind="array"),
           dict(cur, seed=2), dict(cur, position=dict(cur["position"],
                                                      batch_size=8)),
           {"kind": "packed-lm"}]
    for rec in bad:
        with pytest.raises(tstream.StreamCursorError) as port:
            ts.batches_from(rec)
        with pytest.raises(jstream.StreamCursorError) as ref:
            js.batches_from(rec)
        assert str(port.value) == str(ref.value)
