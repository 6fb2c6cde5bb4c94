"""Synthetic datasets — the port's own copy of what it needs from
`horovod_tpu.data.datasets` (numpy only, byte-identical arrays)."""

from __future__ import annotations

import numpy as np


def copy_task(n_sequences: int, seq_len: int, vocab_size: int = 64,
              seed: int = 0):
    """Long-range-recall LM dataset: the second half of each sequence
    repeats the first half, so predicting token ``t ≥ T/2`` requires
    attending ``T/2`` positions back.

    Returns ``(inputs, labels)`` int32 arrays of shape ``[n_sequences,
    seq_len]`` (next-token pairs over a BOS-prefixed sequence). Token 0 is
    the BOS and never sampled; label positions ``seq_len//2 ..`` are the
    recall half."""
    if seq_len % 2 != 0:
        raise ValueError("seq_len must be even")
    rng = np.random.RandomState(seed)
    half = seq_len // 2
    first = rng.randint(1, vocab_size, size=(n_sequences, half))
    bos = np.zeros((n_sequences, 1), dtype=first.dtype)
    tokens = np.concatenate([bos, first, first], axis=1).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]
