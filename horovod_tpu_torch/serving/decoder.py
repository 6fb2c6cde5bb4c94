"""`ChunkedBundleDecoder`: the row-splice adapter the engine steps — port of
`horovod_tpu.serving.decoder`.

A streaming bundle carries two functions
(`models/decoding.make_chunked_generate_fns`):

* ``start(prompt [B, T0], rng, lengths [B]) -> (tokens, state)`` —
  prefill + first ``chunk`` tokens;
* ``cont(state) -> (tokens, state)`` — the next ``chunk`` tokens.

The decode state is ``(cache, last_tok, rng, done)`` where every cache
leaf, ``last_tok`` and ``done`` carry a leading batch axis. The ragged
contract (each row generates exactly as if alone at its own length) makes
continuous batching legitimate as ROW SPLICING: to admit sequences
mid-flight, run ``start`` on a fresh batch holding the new prompts, then
copy the admitted rows of (cache, tok, done) into the live state.

The one leaf that is not per-row is the rng (one `torch.Generator` for
the batch). Splicing it would disturb every live row, so the live
generator is kept and freshness comes from folding a monotone admission
counter into each prefill's seed. Greedy bundles are bit-exact either
way; sampled ones draw valid but not per-request-reproducible samples.

Free/retired rows keep computing garbage until the next admission
overwrites them — harmless: their cache writes past the end are dropped
(`models/transformer`), and cheaper than a masked batch shape.
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.models.decoding import make_rng


class ChunkedBundleDecoder:
    """Step/splice interface over a streaming `GenerateBundle`. The engine
    owns WHICH rows are live; this class owns HOW a batch advances one
    chunk and how fresh rows enter a live state."""

    def __init__(self, bundle):
        chunk = int(bundle.meta.get("streaming_chunk") or 0)
        if not chunk:
            raise ValueError(
                "continuous batching needs a streaming bundle "
                "(export_generate(..., streaming_chunk=K)) — this bundle "
                "carries the one-shot generator only"
            )
        self.bundle = bundle
        self.chunk = chunk
        self.batch_size = bundle.batch_size
        self.prompt_len = bundle.prompt_len
        self.max_new_tokens = int(bundle.meta["max_new_tokens"])
        self.total_chunks = self.max_new_tokens // chunk
        self.eos_id = bundle.meta.get("eos_id")
        self.pad_id = int(bundle.meta.get("pad_id") or 0)

    def prefill(self, prompts, seed: int, admission: int):
        """Run ``start`` with ``prompts`` in rows ``0..len(prompts)-1`` of
        a full batch (pad rows elsewhere); ``admission`` salts the seed.
        Returns ``(tokens [B, chunk] np, fresh_state)``."""
        if not 1 <= len(prompts) <= self.batch_size:
            raise ValueError(
                f"prefill takes 1..{self.batch_size} prompts, got "
                f"{len(prompts)}"
            )
        padded, lengths = self.bundle._pad(prompts)
        rng = make_rng(seed, self.bundle.device, salt=admission + 1)
        tokens, state = self.bundle._start(padded, rng, lengths)
        return tokens.cpu().numpy(), state

    def splice(self, live_state, fresh_state, src_rows, dst_rows):
        """Copy rows ``src_rows`` of ``fresh_state`` into rows ``dst_rows``
        of ``live_state`` across every per-row leaf (cache, last_tok,
        done) — a `torch.where` over an index-gathered fresh state. The
        live rng is kept. Returns the new live state."""
        if len(src_rows) != len(dst_rows):
            raise ValueError(
                f"src/dst row counts differ: {src_rows} vs {dst_rows}"
            )
        perm = np.zeros((self.batch_size,), np.int64)
        mask = np.zeros((self.batch_size,), bool)
        for s, d in zip(src_rows, dst_rows):
            perm[d] = s
            mask[d] = True
        dev = self.bundle.device
        perm_t = torch.as_tensor(perm, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)

        def put(a, b):
            if isinstance(a, dict):
                return {k: put(a[k], b[k]) for k in a}
            m = mask_t.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, b.index_select(0, perm_t), a)

        cache_l, tok_l, rng_l, done_l = live_state
        cache_f, tok_f, _, done_f = fresh_state
        with torch.inference_mode():
            return (
                put(cache_l, cache_f), put(tok_l, tok_f), rng_l,
                put(done_l, done_f),
            )

    def step(self, state):
        """One ``cont`` dispatch: every row advances ``chunk`` tokens.
        Returns ``(tokens [B, chunk] np, state)``."""
        tokens, state = self.bundle._cont(state)
        return tokens.cpu().numpy(), state

    def done_flags(self, state) -> np.ndarray:
        """Per-row eos-done booleans (all-False when no eos_id)."""
        return state[3].cpu().numpy()
