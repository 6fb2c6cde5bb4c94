"""Beam search over the KV-cache decode loop — port of
`horovod_tpu.models.beam`.

* **Beams are batch rows**: W hypotheses per row live as a [B·W] batch
  through the same cached decode step the other modes use.
* **Reordering is a gather**: when beam w extends parent p, every cache
  tensor (K/V, the int8 cache's scales, the ring's slot positions) takes
  rows ``[batch, parent]`` — a batch-dim gather written back in place, so
  the step stays one captured graph (`decoding.StepGraph`); the JAX search
  is one ``lax.scan``, here the steps are replays.
* Scores are accumulated f32 log-probabilities; finished rows (``eos_id``)
  freeze their score and expand only to eos; the final choice applies the
  GNMT length penalty ``((5 + len) / 6) ** length_penalty``.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.models import quant
from horovod_tpu_torch.models.decoding import (
    _NEG,
    StepGraph,
    check_params,
    decode_fn,
)


def _reorder_(leaf, parent, b: int, w: int) -> None:
    """Rows of ``leaf`` ([B·W, ...] beam-major within a batch row, or
    [B, W, ...]) taken from their parents, in place."""
    rest = leaf.shape[1:] if leaf.shape[0] == b * w else leaf.shape[2:]
    shaped = leaf.view((b, w) + tuple(rest))
    idx = parent.view((b, w) + (1,) * len(rest)).expand_as(shaped)
    leaf.copy_(torch.gather(shaped, 1, idx.long()).view(leaf.shape))


def make_beam_search_fn(model, *, max_new_tokens: int, beam_size: int,
                        length_penalty: float = 0.0,
                        eos_id: int | None = None,
                        include_prompt: bool = True,
                        return_scores: bool = False,
                        quantized: bool = False):
    """The beam searcher ``fn(prompt [B, T0], *, params=None) -> tokens``:
    the best beam per batch row; with ``return_scores`` ``(tokens,
    scores)``, the best beam's accumulated log-probability
    (length-penalized when ``length_penalty > 0``). ``params`` with
    ``quantized=True`` is a `quant.quantize_params` tree dequantized inside
    each step. ``fn.steps`` is the step's `StepGraph`."""
    if beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    w = beam_size
    unpack = quant.make_unpack(quantized)
    runner = StepGraph(None, model.device)

    def step_body(dec):
        def body(s, _gen):
            cache, gen, scores = s["cache"], s["gen"], s["scores"]
            b = scores.shape[0]
            logits, new = dec(s["last"].reshape(b * w, 1), cache)
            cache["index"].copy_(new["index"])
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
            vocab = logp.shape[-1]
            logp = logp.view(b, w, vocab)
            if eos_id is not None:
                # Finished beams expand only to eos, at no score cost.
                frozen = torch.full((vocab,), _NEG, device=logp.device)
                frozen[eos_id] = 0.0
                logp = torch.where(s["finished"][:, :, None], frozen, logp)
            total = scores[:, :, None] + logp
            new_scores, flat = torch.topk(total.view(b, w * vocab), w)
            parent = flat // vocab
            token = (flat % vocab).to(torch.int32)
            _reorder_(gen, parent, b, w)
            gen.index_copy_(2, s["i"], token[:, :, None])
            for name, leaf in cache.items():
                if name == "index":
                    continue  # the shared scalar position
                for t in leaf.values():
                    _reorder_(t, parent, b, w)
            if eos_id is not None:
                fin = torch.gather(s["finished"], 1, parent)
                s["finished"].copy_(fin | (token == eos_id))
            scores.copy_(new_scores)
            s["last"].copy_(token)
            s["i"].add_(1)

        return body

    @torch.inference_mode()
    def run(prompt, *, params=None):
        check_params(quantized, params)
        dev = model.device
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
        b, t0 = prompt.shape
        dec = decode_fn(model, params, unpack)
        runner.bind(step_body(dec), params)
        logits, cache = dec(prompt, max_decode_len=t0 + max_new_tokens)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        # Seed: the top-W first tokens of each row ARE the initial beams.
        scores, tok0 = torch.topk(logp0, w)
        tok0 = tok0.to(torch.int32)
        finished = (torch.zeros((b, w), dtype=torch.bool, device=dev)
                    if eos_id is None else tok0 == eos_id)
        tiled = {k: (v if k == "index" else
                     {n: t.repeat_interleave(w, dim=0) for n, t in v.items()})
                 for k, v in cache.items()}
        gen = torch.zeros((b, w, max_new_tokens), dtype=torch.int32,
                          device=dev)
        gen[:, :, 0] = tok0
        state = {"cache": tiled, "gen": gen, "scores": scores, "last": tok0,
                 "finished": finished,
                 "i": torch.ones(1, dtype=torch.long, device=dev)}
        state = runner.run(state, max_new_tokens - 1)
        gen, scores = state["gen"], state["scores"]
        # Length-penalized final selection: len = tokens up to the first
        # eos (inclusive), or the full budget.
        if eos_id is not None:
            is_eos = gen == eos_id
            first = is_eos.int().argmax(dim=-1) + 1
            lengths = torch.where(is_eos.any(dim=-1), first,
                                  torch.full_like(first, max_new_tokens))
        else:
            lengths = torch.full((b, w), max_new_tokens, device=dev)
        if length_penalty > 0.0:
            norm = ((5.0 + lengths.float()) / 6.0) ** length_penalty
            final = scores / norm
        else:
            final = scores
        best = final.argmax(dim=1)
        tokens = torch.gather(
            gen, 1, best[:, None, None].expand(-1, 1, max_new_tokens))[:, 0]
        best_score = torch.gather(final, 1, best[:, None])[:, 0]
        if eos_id is not None:
            # Everything after the first eos is eos (generate's fill).
            blen = torch.gather(lengths, 1, best[:, None])
            pos = torch.arange(max_new_tokens, device=dev)[None, :]
            tokens = torch.where(pos < blen, tokens,
                                 torch.full_like(tokens, eos_id))
        if include_prompt:
            tokens = torch.cat([prompt, tokens], dim=1)
        tokens = tokens.clone()
        if return_scores:
            return tokens, best_score.clone()
        return tokens

    run.steps = runner
    return run
