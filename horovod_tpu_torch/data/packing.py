"""Sequence packing: variable-length documents → fixed [B, T] rows + ids —
port of `horovod_tpu.data.packing` (numpy only; the same rows, ids and
batches, byte for byte, for the same documents and seed).

The data side of packed-sequence pretraining: the flash kernel masks
attention to within-document pairs given ``segment_ids``
(`ops.flash_attention`), the model restarts RoPE per document
(`models.transformer.packed_positions`), and this module produces those ids
from a corpus of variable-length token sequences.

Best-fit-decreasing packing: documents are placed, longest first, into the
open row with the least room that still fits them; leftover tail positions
carry ``pad_id`` tokens in their OWN segment (id 0), so they attend only
among themselves and are maskable in the loss. Every output row is exactly
``seq_len`` long.
"""

from __future__ import annotations

import numpy as np


def pack_documents(
    docs,
    seq_len: int,
    *,
    pad_id: int = 0,
    max_docs_per_row: int | None = None,
    drop_overlong: bool = False,
):
    """Pack variable-length token sequences into fixed-length rows.

    Args:
      docs: iterable of 1-D int arrays/lists (token sequences). Documents
        longer than ``seq_len`` are split into ``seq_len`` chunks (each
        chunk its own segment) unless ``drop_overlong``.
      seq_len: row length T.
      pad_id: token filling the unused tail of each row.
      max_docs_per_row: optional cap on documents sharing one row (some
        recipes cap cross-document attention pollution of the loss mask).

    Returns:
      ``(tokens, segment_ids, doc_ids)`` — all ``[n_rows, seq_len]`` int32:
      * ``tokens``: packed token rows;
      * ``segment_ids``: 1-based per-row segment numbering, 0 = padding —
        feed straight into ``TransformerLM(..., segment_ids=...)`` /
        `flash_attention`;
      * ``doc_ids``: index into ``docs`` for each position (-1 = padding) —
        for bookkeeping/metrics, not consumed by the model.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    pieces: list[tuple[int, np.ndarray]] = []
    for i, d in enumerate(docs):
        arr = np.asarray(d, np.int32).reshape(-1)
        if len(arr) == 0:
            continue
        if len(arr) > seq_len:
            if drop_overlong:
                continue
            for s in range(0, len(arr), seq_len):
                chunk = arr[s : s + seq_len]
                if len(chunk):
                    pieces.append((i, chunk))
        else:
            pieces.append((i, arr))

    # Best-fit-decreasing: longest pieces first, each placed into the open
    # row with the SMALLEST remaining capacity that still fits — found by
    # bisect over a (remaining, row) list kept sorted, so placement is
    # O(log rows) per piece instead of a linear scan (a 1e6-document corpus
    # packs in seconds, not hours). Occupancy matches or beats first-fit.
    import bisect

    pieces.sort(key=lambda p: -len(p[1]))
    rows: list[list[tuple[int, np.ndarray]]] = []
    open_rows: list[tuple[int, int]] = []  # sorted (remaining, row_index)

    def reinsert(r: int, remaining: int) -> None:
        if remaining > 0 and (
            max_docs_per_row is None or len(rows[r]) < max_docs_per_row
        ):
            bisect.insort(open_rows, (remaining, r))

    for i, arr in pieces:
        k = bisect.bisect_left(open_rows, (len(arr), -1))
        if k < len(open_rows):
            remaining, r = open_rows.pop(k)
            rows[r].append((i, arr))
            reinsert(r, remaining - len(arr))
        else:
            rows.append([(i, arr)])
            reinsert(len(rows) - 1, seq_len - len(arr))

    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, np.int32)
    segment_ids = np.zeros((n, seq_len), np.int32)
    doc_ids = np.full((n, seq_len), -1, np.int32)
    for r, row in enumerate(rows):
        at = 0
        for s, (i, arr) in enumerate(row, start=1):
            tokens[r, at : at + len(arr)] = arr
            segment_ids[r, at : at + len(arr)] = s
            doc_ids[r, at : at + len(arr)] = i
            at += len(arr)
    return tokens, segment_ids, doc_ids


def packing_efficiency(segment_ids) -> float:
    """Fraction of positions carrying real (non-padding) tokens."""
    seg = np.asarray(segment_ids)
    return float((seg != 0).mean()) if seg.size else 0.0


class PackedLMStream:
    """Resumable packed-LM batch stream — the corpus → packed-row feeding
    path (`tokenizer.py` → `pack_documents` → `next_token_pairs`) as a
    DURABLE stream with an exportable `data.stream.StreamCursor`.

    Packing is deterministic (best-fit-decreasing over a fixed corpus
    order), so the packed row set is a pure function of the inputs; the
    per-epoch row order is a pure function of ``(seed, epoch)`` (the
    anchored `ArrayDataset` engine underneath). Together any stream
    position — including epochs consumed by a dead process — is
    reconstructible byte-exactly from ``(seed, epoch, step)`` plus the
    geometry fingerprint the cursor carries (row count, seq_len, batch
    size, shard spec, and the tokenizer's merge-table sha256 when the
    corpus came in as raw text).

    Batches are ``(x, y)`` with ``x = tokens ⊕ segment_ids`` ([B, T, 2]
    int32) and ``y = targets ⊕ loss-weights`` ([B, T, 2] int32) — the
    `examples/lm_packed_pretraining.py` stacked-channel feed, so the
    stream drops straight into ``Trainer.fit(dataset=...)`` with the
    masked-CE loss."""

    def __init__(self, docs, seq_len: int, batch_size: int, *,
                 seed: int = 0, tokenizer=None, shard=(0, 1),
                 pad_id: int = 0):
        self._tok_digest = None
        if tokenizer is not None:
            import hashlib
            import json as _json

            self._tok_digest = hashlib.sha256(
                _json.dumps(
                    [list(m) for m in tokenizer.merges]
                ).encode()
            ).hexdigest()[:16]
            docs = tokenizer.encode_corpus(docs)
        toks, seg, _ = pack_documents(docs, seq_len + 1, pad_id=pad_id)
        x, y, w = next_token_pairs(toks, seg)
        xs = np.stack([x, seg[:, :-1]], axis=-1)
        ys = np.stack([y, w.astype(np.int32)], axis=-1)
        self.seq_len = int(seq_len)
        self.n_rows = int(len(xs))
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        from horovod_tpu_torch.data.loader import ArrayDataset

        ds = ArrayDataset((xs, ys))
        if tuple(shard) != (0, 1):
            ds = ds.shard(*shard)
        self.shard = tuple(shard)
        self._ds = (
            ds.repeat()
            .shuffle(ds.num_examples, seed=seed)
            .batch(batch_size)
        )

    def batches(self, skip: int = 0, *, start_epoch: int = 0,
                batches_per_epoch: int | None = None):
        """Anchored ``(x, y)`` batches — the `Trainer.fit(dataset=...)`
        fast-forward hook (see `ArrayDataset.batches`)."""
        return self._ds.batches(
            skip=skip, start_epoch=start_epoch,
            batches_per_epoch=batches_per_epoch,
        )

    def __iter__(self):
        return self.batches()

    def stream_cursor(self, epoch: int, step: int,
                      batches_per_epoch: int | None = None):
        from horovod_tpu_torch.data import stream as stream_lib

        return stream_lib.StreamCursor(
            kind="packed-lm", seed=self.seed, epoch=int(epoch),
            step=int(step),
            position={
                "n_rows": self.n_rows,
                "seq_len": self.seq_len,
                "batch_size": self.batch_size,
                "shard": list(self.shard),
                "tokenizer_sha256": self._tok_digest,
                "batches_per_epoch": batches_per_epoch,
            },
        )

    def batches_from(self, cursor):
        """Byte-exact continuation from a `StreamCursor` (or its dict
        form); format/kind/geometry mismatches are refused loudly."""
        from horovod_tpu_torch.data import stream as stream_lib

        if not isinstance(cursor, stream_lib.StreamCursor):
            cursor = stream_lib.StreamCursor.from_dict(cursor)
        cursor.require(
            "packed-lm", seed=self.seed,
            n_rows=self.n_rows, seq_len=self.seq_len,
            batch_size=self.batch_size, shard=list(self.shard),
            tokenizer_sha256=self._tok_digest,
        )
        return self.batches(
            skip=cursor.step, start_epoch=cursor.epoch,
            batches_per_epoch=cursor.position.get("batches_per_epoch"),
        )


def next_token_pairs(tokens, segment_ids):
    """(x, y, weights) next-token training triplets for packed rows.

    ``y`` is ``tokens`` shifted left within the row; ``weights`` zeroes the
    positions whose TARGET crosses a document boundary or is padding (both
    decided purely by ``segment_ids`` — padding is segment 0) — the
    per-token loss mask packed pretraining needs (multiply into a per-token
    loss, or feed frameworks that take sample weights)."""
    toks = np.asarray(tokens, np.int32)
    seg = np.asarray(segment_ids, np.int32)
    x = toks[:, :-1]
    y = toks[:, 1:]
    w = (
        (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    ).astype(np.float32)
    return x, y, w
