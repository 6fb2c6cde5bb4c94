"""Byte-level BPE tokenizer — the port's own copy of
`horovod_tpu.data.tokenizer` (the port imports nothing of the JAX package,
not even a module without JAX in it).

Byte-level BPE (the GPT-2/RoBERTa scheme): the base alphabet is all 256
bytes, so every string encodes with no unknown-token case and
``decode(encode(s)) == s`` for any Unicode input. Training learns
``vocab_size − 256 − len(specials)`` merges by most-frequent-pair counting
over a word-frequency table (ties to the smallest pair); encoding applies
the merges by learned rank, lowest first. Pre-tokenization splits on
whitespace with the whitespace glued to the FOLLOWING word, so merges never
cross word boundaries. Special tokens take ids [256 + n_merges,
vocab_size) and are matched as whole literals before byte splitting.

The saved JSON (``{"format": "hvt-bbpe-v1", "merges", "specials"}``) is
the JAX package's format: a tokenizer saved by either package loads in
the other. Merges, ids and the JSON are held against the JAX package in
``tests/test_torch_tokenizer.py``.
"""

from __future__ import annotations

import collections
import heapq
import json

import numpy as np

from horovod_tpu_torch.checkpoint import _atomic_write


def _pretokenize(text: str) -> list[bytes]:
    """Whitespace-split with the space glued to the next word: the units
    BPE merges operate within."""
    words: list[bytes] = []
    start = 0
    i = 0
    n = len(text)
    while i < n:
        if text[i].isspace():
            # Flush the word ending here; the whitespace run prefixes the
            # next word.
            if start < i:
                words.append(text[start:i].encode("utf-8"))
                start = i
            i += 1
            while i < n and text[i].isspace():
                i += 1
            # find the end of the following word
            j = i
            while j < n and not text[j].isspace():
                j += 1
            words.append(text[start:j].encode("utf-8"))
            start = j
            i = j
        else:
            i += 1
    if start < n:
        words.append(text[start:].encode("utf-8"))
    return words


class ByteBPETokenizer:
    """Trainable byte-level BPE. ``train`` then ``encode``/``decode``;
    `save`/`load` round-trip the full state as JSON."""

    def __init__(self, merges=None, specials=()):
        # merges: list of (id_a, id_b) pairs in learned order; pair i forms
        # token id 256 + i.
        self.merges: list[tuple[int, int]] = [tuple(m) for m in (merges or [])]
        self.specials: tuple[str, ...] = tuple(specials)
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._cache: dict[bytes, list[int]] = {}

    # -- vocabulary layout ---------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.specials)

    def special_id(self, token: str) -> int:
        return 256 + len(self.merges) + self.specials.index(token)

    # -- training ------------------------------------------------------------
    @classmethod
    def train(cls, texts, vocab_size: int, specials=()) -> "ByteBPETokenizer":
        """Learn merges from an iterable of strings until ``vocab_size``.

        Pair counting runs over the word-frequency table (each distinct
        word counted once, weighted by its frequency) — corpus length only
        matters through the pre-tokenization pass.
        """
        n_merges = vocab_size - 256 - len(specials)
        if n_merges < 0:
            raise ValueError(
                f"vocab_size ({vocab_size}) < base 256 + specials "
                f"({len(specials)})"
            )
        word_freq: collections.Counter = collections.Counter()
        for t in texts:
            word_freq.update(_pretokenize(t))
        # Each distinct word as a mutable symbol list. Training is
        # incremental (the merge-queue scheme): pair counts and a
        # pair → containing-words index are built once, each merge touches
        # only the words that contain the merged pair, and the best pair
        # comes from a lazy-deletion heap — per-merge cost is O(changed)
        # instead of a full corpus rescan, which is what makes MB-scale
        # corpora train in seconds.
        words = [(list(w), f) for w, f in word_freq.items()]
        pairs: dict[tuple[int, int], int] = {}
        where: dict[tuple[int, int], set[int]] = {}
        for wi, (sym, f) in enumerate(words):
            for p in zip(sym, sym[1:]):
                pairs[p] = pairs.get(p, 0) + f
                where.setdefault(p, set()).add(wi)
        # Heap key (-count, pair) reproduces the selection order of a full
        # rescan: highest count first, ties to the smallest (a, b) — the
        # learned merges are bit-identical to the O(merges × corpus)
        # trainer this replaces.
        heap = [(-c, p) for p, c in pairs.items()]
        heapq.heapify(heap)
        merges: list[tuple[int, int]] = []
        while len(merges) < n_merges and heap:
            negc, pair = heapq.heappop(heap)
            count = pairs.get(pair, 0)
            if count < 2:
                continue  # dead or noise-level pair (stale entry or < 2)
            if -negc != count:
                # Stale count: re-queue at the true value and keep popping.
                heapq.heappush(heap, (-count, pair))
                continue
            a, b = pair
            new_id = 256 + len(merges)
            merges.append(pair)
            changed: set[tuple[int, int]] = set()
            for wi in where.pop(pair, ()):
                sym, f = words[wi]
                for p in zip(sym, sym[1:]):
                    left = pairs.get(p, 0) - f
                    if left > 0:
                        pairs[p] = left
                    else:
                        pairs.pop(p, None)
                    ws = where.get(p)
                    if ws is not None:
                        ws.discard(wi)
                i = 0
                while i < len(sym) - 1:
                    if sym[i] == a and sym[i + 1] == b:
                        sym[i : i + 2] = [new_id]
                    else:
                        i += 1
                for p in zip(sym, sym[1:]):
                    pairs[p] = pairs.get(p, 0) + f
                    where.setdefault(p, set()).add(wi)
                    changed.add(p)
            for p in changed:
                if p in pairs:
                    heapq.heappush(heap, (-pairs[p], p))
        return cls(merges=merges, specials=specials)

    # -- encoding ------------------------------------------------------------
    def _bpe_word(self, word: bytes) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        sym = list(word)
        while len(sym) > 1:
            # The lowest-rank (earliest-learned) pair present merges first.
            best = None
            best_rank = None
            for pair in zip(sym, sym[1:]):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            a, b = best
            new_id = 256 + best_rank
            i = 0
            while i < len(sym) - 1:
                if sym[i] == a and sym[i + 1] == b:
                    sym[i : i + 2] = [new_id]
                else:
                    i += 1
        if len(self._cache) < 1 << 16:
            self._cache[word] = sym
        return sym

    def encode(self, text: str) -> list[int]:
        if not self.specials:
            ids: list[int] = []
            for w in _pretokenize(text):
                ids.extend(self._bpe_word(w))
            return ids
        # Specials are whole-literal matches, longest first, before BPE.
        ids = []
        ordered = sorted(self.specials, key=len, reverse=True)
        rest = text
        while rest:
            # Earliest match wins; at equal positions the LONGEST special
            # wins (ordered is longest-first, so its index breaks the tie).
            hit = min(
                (
                    (rest.find(s), k, s)
                    for k, s in enumerate(ordered)
                    if s in rest
                ),
                default=None,
            )
            if hit is None:
                for w in _pretokenize(rest):
                    ids.extend(self._bpe_word(w))
                break
            pos, _, s = hit
            for w in _pretokenize(rest[:pos]):
                ids.extend(self._bpe_word(w))
            ids.append(self.special_id(s))
            rest = rest[pos + len(s):]
        return ids

    def decode(self, ids) -> str:
        out = bytearray()
        n_base = 256 + len(self.merges)
        # Expand merged ids depth-first back to bytes.
        stack = list(reversed([int(i) for i in ids]))
        while stack:
            i = stack.pop()
            if i < 256:
                out.append(i)
            elif i < n_base:
                a, b = self.merges[i - 256]
                stack.extend((b, a))
            else:
                out.extend(self.specials[i - n_base].encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    def encode_corpus(self, texts) -> list[np.ndarray]:
        """Encode documents for `packing.pack_documents` — the
        text → packed-pretraining bridge."""
        return [np.asarray(self.encode(t), np.int32) for t in texts]

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        payload = {
            "format": "hvt-bbpe-v1",
            "merges": [list(m) for m in self.merges],
            "specials": list(self.specials),
        }
        _atomic_write(path, json.dumps(payload).encode())
        return path

    @classmethod
    def load(cls, path: str) -> "ByteBPETokenizer":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != "hvt-bbpe-v1":
            raise ValueError(f"not a tokenizer file: {path}")
        return cls(
            merges=[tuple(m) for m in payload["merges"]],
            specials=payload["specials"],
        )
