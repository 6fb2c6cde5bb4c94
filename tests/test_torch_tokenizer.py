"""horovod_tpu_torch.data.tokenizer (the port's own copy) against
`horovod_tpu.data.tokenizer`: training on the same corpus learns the same
merges, encoding gives the same ids (exactly), ``decode(encode(s)) == s``,
special tokens are whole literals, and the JSON either side saves loads in
the other (byte-identical files).
"""

import numpy as np
import pytest

from horovod_tpu.data import tokenizer as jtok
from horovod_tpu_torch.data import tokenizer as ttok

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps; the quick fox runs\tand runs",
    "  leading spaces, trailing spaces  ",
    "naïve café — déjà vu, 東京 and emoji 🚀🚀",
    "the the the then there their",
] * 3
TEXTS = CORPUS[:5] + [
    "", " ", "unseen words stay encodable: zyxwvut",
    "multi\n\nline\r\ntext", "🚀 rocket <eos> after <pad><eos>",
]
SPECIALS = ("<eos>", "<pad>", "<eos><pad>")


@pytest.mark.parametrize("vocab,specials", [(300, ()), (330, SPECIALS)])
def test_training_learns_the_same_merges(vocab, specials):
    j = jtok.ByteBPETokenizer.train(CORPUS, vocab, specials=specials)
    t = ttok.ByteBPETokenizer.train(CORPUS, vocab, specials=specials)
    assert t.merges == j.merges
    assert t.vocab_size == j.vocab_size
    assert t.specials == j.specials


@pytest.mark.parametrize("specials", [(), SPECIALS])
def test_ids_and_round_trip(specials):
    j = jtok.ByteBPETokenizer.train(CORPUS, 320, specials=specials)
    t = ttok.ByteBPETokenizer.train(CORPUS, 320, specials=specials)
    for s in TEXTS:
        ids = t.encode(s)
        assert ids == j.encode(s), s
        assert t.decode(ids) == s
    enc = t.encode_corpus(TEXTS)
    assert all(a.dtype == np.int32 for a in enc)
    assert [a.tolist() for a in enc] == [
        a.tolist() for a in j.encode_corpus(TEXTS)]


def test_specials_are_whole_literals():
    t = ttok.ByteBPETokenizer.train(CORPUS, 300, specials=SPECIALS)
    j = jtok.ByteBPETokenizer.train(CORPUS, 300, specials=SPECIALS)
    eos, pad, both = (t.special_id(s) for s in SPECIALS)
    text = "a<eos>b<eos><pad><eos>"
    ids = t.encode(text)
    assert ids == j.encode(text)
    # At one position the longest special wins.
    assert ids.count(both) == 1 and ids.count(eos) == 2 and pad not in ids
    assert t.decode(ids) == text
    assert t.encode("<eos") == list(b"<eos")  # a partial literal is bytes


def test_json_crosses_both_ways(tmp_path):
    j = jtok.ByteBPETokenizer.train(CORPUS, 320, specials=SPECIALS)
    t = ttok.ByteBPETokenizer.train(CORPUS, 320, specials=SPECIALS)
    jp, tp = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    j.save(jp)
    t.save(tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    from_jax = ttok.ByteBPETokenizer.load(jp)
    from_port = jtok.ByteBPETokenizer.load(tp)
    for s in TEXTS:
        assert from_jax.encode(s) == j.encode(s)
        assert from_port.encode(s) == t.encode(s)


def test_bad_inputs(tmp_path):
    with pytest.raises(ValueError, match="vocab_size"):
        ttok.ByteBPETokenizer.train(CORPUS, 257, specials=SPECIALS)
    path = tmp_path / "other.json"
    path.write_text('{"format": "something-else", "merges": []}')
    with pytest.raises(ValueError, match="not a tokenizer"):
        ttok.ByteBPETokenizer.load(str(path))
