"""Speculative decoding — port of `horovod_tpu.models.speculative`: draft
cheap token chunks, verify them with ONE target chunk forward, accept the
matching prefix.

* **Exact greedy**: a drafted token is kept only while it equals the
  target's own argmax, so the output is the target's greedy output
  whatever the draft proposes — drafts change the speed, never the result.
* **Per-row acceptance**: each batch row advances by its own accepted
  length through the per-row cache index (the verify pass is the cache's
  chunk extension, `models/transformer`), rolled back to the committed
  prefix after every round.
* **Drafts**: prompt lookup (`ngram_draft_fn`, the default), a stateless
  ``draft_fn(buf [B, Tmax], cur_len [B], n_draft) -> [B, n_draft]``, or a
  ``draft_model`` (a smaller `TransformerLM` with its own cache, re-fed a
  fixed 2-token window ending at the committed head every round, then
  γ − 2 single-token steps).
* **Sampling** (``temperature > 0``): the rejection scheme for
  deterministic drafts — accept draft d with probability p(d) under the
  target's filtered distribution, else resample from p without d — so each
  committed position has exactly the law of `decoding.generate`'s sampled
  path. Draws are keyed by (seed, absolute position, tag, batch row) as in
  the JAX package, through a counter hash here (`_keyed_uniform`; the bits
  differ from ``jax.random``'s).

The JAX loop is one ``lax.while_loop``. Here it is a host loop of rounds,
each a replay of one captured round on CUDA (`decoding.StepGraph`: draft,
verify, acceptance, rollback), with one sync a round to read whether
every row has its tokens. Restrictions as in the JAX package: no
``eos_id``, dense models only, ragged ``lengths`` not with a draft model.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.models import quant
from horovod_tpu_torch.models.decoding import (
    _NEG,
    StepGraph,
    check_params,
    check_sampling_params,
    decode_fn,
    filter_logits,
)
from horovod_tpu_torch.ops.dropout import _M32, _mix32


def _keyed_uniform(seed, *keys):
    """Uniforms in (0, 1) that are a pure function of ``seed`` (a 0-d int64
    tensor) and the broadcast integer tensors ``keys`` — the draw of a
    (position, tag, row[, token]) key, whatever round or schedule asks."""
    h = _mix32(seed & _M32) ^ _mix32((seed >> 32) & _M32)
    for k in keys:
        h = _mix32(h ^ (k.to(torch.int64) & _M32))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _keyed_categorical(seed, logits, pos, tag, row):
    """A draw from ``softmax(logits [B, V])`` by the Gumbel-max trick over
    keyed uniforms: one draw per (pos, tag, row) key, ``pos``/``tag``/
    ``row`` ``[B]``."""
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    u = _keyed_uniform(seed, pos[:, None], tag[:, None], row[:, None],
                       vocab[None, :])
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)


def ngram_draft_fn(*, ngram: int = 3) -> Callable:
    """Prompt-lookup draft: continue the most recent earlier occurrence of
    the current ``ngram``-token suffix; a row without one repeats its last
    token. Returns ``draft_fn(buf [B, Tmax], cur_len [B] or scalar,
    n_draft) -> [B, n_draft]``."""

    def draft_fn(buf, cur_len, n_draft: int):
        b, tmax = buf.shape
        dev = buf.device
        cur_len = torch.as_tensor(cur_len, device=dev).to(torch.int64)
        if cur_len.dim() == 0:
            cur_len = cur_len.expand(b)
        ar = torch.arange(ngram, device=dev)
        suf_idx = (cur_len[:, None] - ngram + ar).clamp(0, tmax - 1)
        suffix = torch.gather(buf, 1, suf_idx)  # [B, ngram]
        n_windows = tmax - ngram
        starts = torch.arange(n_windows, device=dev)
        windows = buf[:, starts[:, None] + ar[None, :]]  # [B, S, ngram]
        # An EARLIER occurrence: the window ends before the suffix starts.
        eq = (windows == suffix[:, None, :]).all(dim=-1) \
            & (starts[None, :] < (cur_len - ngram)[:, None])
        s_star = torch.where(eq, starts[None, :], -1).amax(dim=1)
        follow = (s_star[:, None] + ngram
                  + torch.arange(n_draft, device=dev)).clamp(0, tmax - 1)
        draft = torch.gather(buf, 1, follow)
        last = torch.gather(buf, 1, (cur_len - 1)[:, None])
        return torch.where((s_star >= 0)[:, None], draft, last)

    return draft_fn


def make_speculative_fn(model, *, max_new_tokens: int, gamma: int = 4,
                        draft_fn: Callable | None = None, draft_model=None,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 0.0, include_prompt: bool = True,
                        return_stats: bool = False, quantized: bool = False):
    """The speculative generator ``fn(prompt [B, T0], rng=None,
    lengths=None, *, params=None)``: greedy output equal to
    `decoding.make_generate_fn`'s, or (``temperature > 0``, ``rng``
    required) the sampled law. ``gamma`` tokens are verified per target pass
    (the exact head + γ − 1 drafts); ``lengths`` is the ragged contract;
    ``params`` with ``quantized=True`` is a `quant.quantize_params` tree
    dequantized inside every round. ``return_stats`` adds ``{"rounds",
    "tokens"}`` (loop iterations until the slowest row finished; tokens
    committed over all rows). ``fn.steps`` is the round's `StepGraph`."""
    if gamma < 2:
        raise ValueError("gamma must be >= 2 (1 exact token + >=1 draft)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    check_sampling_params(temperature, top_p)
    sampled = temperature != 0.0
    if draft_fn is not None and draft_model is not None:
        raise ValueError("pass draft_fn OR draft_model, not both")
    for m, role in ((model, "target"), (draft_model, "draft")):
        if m is not None and getattr(m, "moe_every", 0):
            raise ValueError(
                f"speculative decoding requires a dense model ({role}): MoE "
                "expert capacity binds per call group, so a chunked verify "
                "forward can legitimately route (and decode) differently "
                "than the per-token steps it replaces — the exact-output "
                "contract cannot hold; use decoding.generate for MoE models"
            )
    draft = draft_fn or (None if draft_model is not None
                         else ngram_draft_fn())
    unpack = quant.make_unpack(quantized)
    runner = StepGraph(None, model.device)

    def round_body(dec, ddec):
        def body(s, _gen):
            buf, cur_len, n_gen = s["buf"], s["cur_len"], s["n_gen"]
            b = buf.shape[0]
            dev = buf.device
            rows = torch.arange(b, device=dev, dtype=torch.int32)
            active = n_gen < max_new_tokens
            next_tok = s["next_tok"]
            # next_tok is already the target's exact output: commit it.
            buf.scatter_(1, cur_len[:, None].long(), next_tok[:, None])
            if ddec is not None:
                proposals = _model_draft(ddec, s["dcache"], buf, cur_len)
            else:
                proposals = draft(buf, cur_len + 1, gamma - 1)
            chunk = torch.cat([next_tok[:, None],
                               proposals.to(torch.int32)], dim=1)
            logits, _ = dec(chunk, s["cache"])
            steps = torch.arange(gamma - 1, device=dev, dtype=torch.int32)
            if sampled:
                flt = filter_logits(logits, temperature, top_k, top_p)
                probs = torch.softmax(flt, dim=-1)  # [B, γ, V]
                vocab = flt.shape[-1]
                d = chunk[:, 1:]
                pos_mat = cur_len[:, None] + 1 + steps[None, :]
                us = _keyed_uniform(s["seed"], pos_mat, d, rows[:, None])
                p_d = torch.gather(probs[:, :-1], 2, d[..., None].long())
                acc = (us < p_d[..., 0]).to(torch.int32)
            else:
                a = logits.argmax(dim=-1).to(torch.int32)
                acc = (chunk[:, 1:] == a[:, :-1]).to(torch.int32)
            m_row = 1 + torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)
            m_row = torch.where(
                active, torch.minimum(m_row, max_new_tokens - n_gen),
                torch.zeros_like(m_row))
            tail = (cur_len[:, None] + 1 + steps[None, :]).long()
            buf.scatter_(1, tail, chunk[:, 1:])
            if sampled:
                gm = (m_row - 1).clamp(0, gamma - 1).long()
                flt_m = torch.gather(
                    flt, 1, gm[:, None, None].expand(-1, 1, vocab))[:, 0]
                has_draft = m_row < gamma
                d_m = torch.gather(chunk, 1, m_row.clamp(1, gamma - 1)
                                   .long()[:, None])[:, 0]
                acc_m = torch.gather(acc, 1, (m_row - 1).clamp(0, gamma - 2)
                                     .long()[:, None])[:, 0].bool()
                hit = torch.nn.functional.one_hot(d_m.long(), vocab).bool()
                masked = torch.where(has_draft[:, None] & hit,
                                     torch.full_like(flt_m, _NEG), flt_m)
                tag = torch.where(has_draft, vocab + d_m,
                                  torch.full_like(d_m, 2 * vocab))
                resampled = _keyed_categorical(s["seed"], masked,
                                               cur_len + m_row, tag, rows)
                new_next = torch.where(has_draft & acc_m, d_m, resampled)
            else:
                new_next = torch.gather(
                    a, 1, (m_row - 1).clamp(0, gamma - 1).long()[:, None]
                )[:, 0]
            next_tok.copy_(torch.where(active, new_next, next_tok))
            # Roll the cache back to each row's committed prefix: stale K/V
            # above it are masked out and overwritten by the next chunk.
            cur_len.add_(m_row)
            n_gen.add_(m_row)
            s["cache"]["index"].copy_(cur_len)
            s["rounds"].add_(1)

        return body

    def _model_draft(ddec, dcache, buf, cur_len):
        """γ − 1 greedy proposals from the draft model, its cache kept: the
        catch-up window [cur_len − 1, cur_len] re-feeds what the draft
        cache may lack, written at the true positions."""
        dcache["index"].copy_(cur_len - 1)
        win = (cur_len - 1)[:, None].long() + torch.arange(
            2, device=buf.device)[None, :]
        dlogits, new = ddec(torch.gather(buf, 1, win), dcache)
        dcache["index"].copy_(new["index"])
        tok = dlogits[:, -1].argmax(dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(gamma - 2):
            slog, new = ddec(tok[:, None], dcache)
            dcache["index"].copy_(new["index"])
            tok = slog[:, -1].argmax(dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.inference_mode()
    def run(prompt, rng=None, lengths=None, *, params=None):
        check_params(quantized, params)
        dev = model.device
        prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
        b, t0 = prompt.shape
        tmax = t0 + max_new_tokens + gamma  # chunk-overhang headroom
        if sampled and rng is None:
            raise ValueError(
                "sampled speculative decoding (temperature > 0) needs an "
                "rng: call fn(prompt, rng)"
            )
        if lengths is not None and draft_model is not None:
            raise ValueError(
                "ragged prompts (lengths=...) are not supported with a "
                "draft_model — its prefill consumes the padded prompt; "
                "use the n-gram/custom draft, or decoding.make_generate_fn"
            )
        if draft_model is not None and t0 < 2:
            raise ValueError(
                "draft_model mode needs a prompt of >= 2 tokens (the "
                "catch-up window spans the last two committed tokens)"
            )
        dec = decode_fn(model, params, unpack)
        ddec = None if draft_model is None else draft_model.decode
        runner.bind(round_body(dec, ddec), params)
        logits, cache = dec(prompt, max_decode_len=tmax)
        rows = torch.arange(b, device=dev, dtype=torch.int32)
        if lengths is None:
            start = torch.full((b,), t0, dtype=torch.int32, device=dev)
            last = logits[:, -1]
        else:
            start = torch.as_tensor(lengths, device=dev).to(torch.int32,
                                                            copy=True)
            last = logits[rows.long(), (start - 1).clamp(max=t0 - 1).long()]
        state = {"cache": {**cache, "index": start.clone()}}
        if sampled:
            seed = torch.randint(0, 2**62, (), generator=rng, device=dev)
            flt0 = filter_logits(last, temperature, top_k, top_p)
            tag = torch.full((b,), 2 * flt0.shape[-1], dtype=torch.int32,
                             device=dev)
            next_tok = _keyed_categorical(seed, flt0, start, tag, rows)
            state["seed"] = seed
        else:
            next_tok = last.argmax(dim=-1).to(torch.int32)
        buf = torch.zeros((b, tmax), dtype=torch.int32, device=dev)
        buf[:, :t0] = prompt
        if draft_model is not None:
            _, dcache = draft_model.decode(prompt[:, :-1],
                                           max_decode_len=tmax)
            state["dcache"] = {**dcache, "index": torch.full(
                (b,), t0 - 1, dtype=torch.int32, device=dev)}
        state.update(
            buf=buf, cur_len=start.clone(),
            n_gen=torch.zeros((b,), dtype=torch.int32, device=dev),
            next_tok=next_tok,
            rounds=torch.zeros((), dtype=torch.int32, device=dev),
        )
        while int(state["n_gen"].min()) < max_new_tokens:
            state = runner.run(state, 1)
        buf = state["buf"]
        if lengths is not None:
            idx = start[:, None].long() + torch.arange(
                max_new_tokens, device=dev)[None, :]
            gen = torch.gather(buf, 1, idx)
            out = torch.cat([prompt, gen], dim=1) if include_prompt else gen
        else:
            out = buf[:, (0 if include_prompt else t0):t0 + max_new_tokens]
        out = out.clone()
        if return_stats:
            return out, {"rounds": state["rounds"].clone(),
                         "tokens": state["n_gen"].sum()}
        return out

    run.steps = runner
    return run
