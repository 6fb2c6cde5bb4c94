"""Autoregressive inference: KV-cache prefill + decode loop — port of
`horovod_tpu.models.decoding`.

The JAX module compiles prefill and a `lax.scan` of decode steps into one
program; here the scan is a Python loop of eager steps (the prefill's
attention is the CUDA flash kernel on the card). Contracts kept exactly:

* **ragged prompts** — ``lengths [B]``: row i's prompt is its first
  ``lengths[i]`` tokens; its first token samples the logits at
  ``lengths[i] - 1`` and its decode writes start at ``lengths[i]`` (the
  per-row cache index), so every row generates as if alone in the batch;
* **chunked state** — ``(cache, last_tok, rng, done)``: every leaf but
  ``rng`` carries a leading batch axis and each row depends only on its
  own row, which is what lets the serving engine splice rows;
* greedy / temperature / top-k / top-p sampling and the eos fill.

``rng`` is one `torch.Generator` on the model's device. It draws other
numbers than ``jax.random`` from the same seed, so sampled tokens differ
from the JAX package's; greedy tokens do not.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def check_sampling_params(temperature: float, top_p: float) -> None:
    """The one place the sampling-knob ranges are enforced."""
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")


def filter_logits(logits, temperature: float, top_k: int, top_p: float):
    """Temperature/top-k/top-p filtering on ``[..., vocab]`` logits (f32):
    the filtered logits whose softmax is the sampling distribution, `_NEG`
    on masked tokens. ``temperature`` must be > 0."""
    check_sampling_params(temperature, top_p)
    if temperature == 0.0:
        raise ValueError("filter_logits needs temperature > 0 (greedy is "
                         "the callers' argmax fast path)")
    logits = logits.float() / temperature
    neg = torch.full_like(logits, _NEG)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p:
        # Nucleus: keep the smallest prefix of descending-prob tokens whose
        # EXCLUSIVE cumulative mass is < top_p (the top token always
        # survives).
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        n_keep = (exclusive < top_p).sum(dim=-1, keepdim=True)
        kth = torch.gather(sorted_logits, -1, n_keep - 1)
        logits = torch.where(logits < kth, neg, logits)
    return logits


def _sample(logits, rng, temperature: float, top_k: int, top_p: float = 0.0):
    """One next-token draw from ``[B, vocab]`` logits."""
    check_sampling_params(temperature, top_p)
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), -1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0].to(torch.int32)


def make_rng(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` — verbatim when
    ``salt`` is 0, else mixed with it (the role of ``jax.random.fold_in``)."""
    if salt:
        seed = (seed * 0x9E3779B97F4A7C15 + salt) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


def _check_not_ported(kw: dict) -> None:
    for name, value in kw.items():
        if name not in ("quantized", "int8_compute", "quantized_cache"):
            raise TypeError(f"unexpected argument {name!r}")
        if value:
            raise NotImplementedError(
                f"{name}=True is not ported yet — ROADMAP queue A item 10 "
                "(decode: models/quant.py)"
            )


def _prefill(model, prompt, lengths, max_new_tokens):
    """Prompt forward creating the cache; returns ``(last_logits, cache)``
    with the ragged-lengths layout applied."""
    b, t0 = prompt.shape
    logits, cache = model.decode(prompt, max_decode_len=t0 + max_new_tokens)
    if lengths is None:
        return logits[:, -1], cache
    lengths = torch.as_tensor(lengths, device=prompt.device).to(torch.int32)
    rows = torch.arange(b, device=prompt.device)
    last = logits[rows, lengths.long() - 1]
    return last, {**cache, "index": lengths}


def _steps(model, state, n, sampling, eos_id):
    """``n`` decode steps from ``state``; returns ``(tokens [B, n], state)``."""
    cache, tok, rng, done = state
    fill = 0 if eos_id is None else eos_id
    out = []
    for _ in range(n):
        logits, cache = model.decode(tok[:, None], cache)
        nxt = _sample(logits[:, -1], rng, *sampling)
        nxt = torch.where(done, torch.full_like(nxt, fill), nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    tokens = torch.stack(out, dim=1) if out else tok.new_zeros((tok.shape[0], 0))
    return tokens, (cache, tok, rng, done)


def _first(model, prompt, rng, lengths, max_new_tokens, sampling, eos_id):
    prompt = torch.as_tensor(prompt, device=model.device).to(torch.int32)
    last, cache = _prefill(model, prompt, lengths, max_new_tokens)
    tok = _sample(last, rng, *sampling)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_id is None
            else tok == eos_id)
    return prompt, (cache, tok, rng, done)


def make_generate_fn(model, *, max_new_tokens: int, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0,
                     eos_id: int | None = None, include_prompt: bool = True,
                     **not_ported):
    """The generator ``fn(prompt [B, T0], rng=None, lengths=None) ->
    tokens`` over ``model`` (a `TransformerLM`, decode mode with a cache of
    ``T0 + max_new_tokens``). ``rng`` defaults to seed 0 on the model's
    device; ``lengths`` ([B]) selects the ragged-prompt contract (module
    docstring). Runs under `torch.inference_mode`."""
    _check_not_ported(not_ported)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    check_sampling_params(temperature, top_p)
    sampling = (temperature, top_k, top_p)

    @torch.inference_mode()
    def run(prompt, rng=None, lengths=None):
        if rng is None:
            rng = make_rng(0, model.device)
        prompt, state = _first(
            model, prompt, rng, lengths, max_new_tokens, sampling, eos_id
        )
        rest, _ = _steps(model, state, max_new_tokens - 1, sampling, eos_id)
        gen = torch.cat([state[1][:, None], rest], dim=1)
        return torch.cat([prompt, gen], dim=1) if include_prompt else gen

    return run


def make_chunked_generate_fns(model, *, max_new_tokens: int, chunk: int,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 0.0, eos_id: int | None = None,
                              **not_ported):
    """Chunked generation for streaming serving: ``(start_fn, cont_fn)``.

    * ``start_fn(prompt [B, T0], rng, lengths [B]) -> (tokens [B, chunk],
      state)`` — prefill + the first ``chunk`` tokens (ragged lengths);
    * ``cont_fn(state) -> (tokens [B, chunk], state)`` — the next ``chunk``
      tokens against the carried cache.

    ``state`` is ``(cache, last_tok, rng, done)``. The cache is sized
    ``T0 + max_new_tokens``, so at most ``max_new_tokens / chunk`` chunks
    are valid — the caller enforces the budget. Token streams equal
    `make_generate_fn`'s for the same knobs and generator. The state's
    cache is written in place by ``cont_fn``."""
    _check_not_ported(not_ported)
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if max_new_tokens % chunk != 0:
        raise ValueError(
            f"chunk ({chunk}) must divide max_new_tokens ({max_new_tokens})"
        )
    check_sampling_params(temperature, top_p)
    sampling = (temperature, top_k, top_p)

    @torch.inference_mode()
    def start(prompt, rng, lengths):
        _, state = _first(
            model, prompt, rng, lengths, max_new_tokens, sampling, eos_id
        )
        first = state[1]
        rest, state = _steps(model, state, chunk - 1, sampling, eos_id)
        return torch.cat([first[:, None], rest], dim=1), state

    @torch.inference_mode()
    def cont(state):
        return _steps(model, state, chunk, sampling, eos_id)

    return start, cont


def generate(model, prompt, max_new_tokens: int, *, rng=None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_id: int | None = None, include_prompt: bool = True,
             **not_ported):
    """Generate ``max_new_tokens`` continuations of ``prompt`` ([B, T0]
    ints) on the model's device. ``temperature=0`` = greedy; after a row
    emits ``eos_id`` its remaining positions are filled with it."""
    fn = make_generate_fn(
        model, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_id=eos_id,
        include_prompt=include_prompt, **not_ported,
    )
    return fn(prompt, rng)
