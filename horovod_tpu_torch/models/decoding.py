"""Autoregressive inference: KV-cache prefill + decode loop — port of
`horovod_tpu.models.decoding`.

The JAX module compiles prefill and a `lax.scan` of decode steps into one
program. Here the prefill runs eagerly (its attention is the CUDA flash
kernel on the card, and its prompt shape varies) and the per-token step is
captured once in a CUDA graph and replayed (`StepGraph`): one graph launch
a token instead of ~840 kernel launches. The cache is written in place, so
its tensors are the graph's static buffers; sampled modes draw inside the
capture from a generator registered with the graph, so a replay equals the
eager step bit for bit on the same generator state. On the CPU the same
step function runs eagerly. Contracts kept exactly:

* **ragged prompts** — ``lengths [B]``: row i's prompt is its first
  ``lengths[i]`` tokens; its first token samples the logits at
  ``lengths[i] - 1`` and its decode writes start at ``lengths[i]`` (the
  per-row cache index), so every row generates as if alone in the batch;
* **chunked state** — ``(cache, last_tok, rng, done)``: every leaf but
  ``rng`` carries a leading batch axis and each row depends only on its
  own row, which is what lets the serving engine splice rows;
* greedy / temperature / top-k / top-p sampling and the eos fill;
* ``quantized`` (a `quant.quantize_params` tree passed as ``params=``,
  dequantized inside each step), ``int8_compute`` (the prefill's matmuls
  on int8, `quant.int8_dot_general`; the steps stay in the compute dtype)
  and ``quantized_cache`` (the int8 K/V cache).

``rng`` is one `torch.Generator` on the model's device. It draws other
numbers than ``jax.random`` from the same seed, so sampled tokens differ
from the JAX package's; greedy tokens do not.
"""

from __future__ import annotations

import torch
from torch import nn

from horovod_tpu_torch.models import quant

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


# -- the captured step -------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _layout(tree):
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return tuple(_layout(v) for v in tree)
    return (tuple(tree.shape), tree.dtype)


def clone_state(tree):
    """A copy of a state tree of tensors (what a caller keeps of a
    `StepGraph.run` result past the next run)."""
    return _map(lambda t: t.clone(), tree)


class StepGraph:
    """Steps of ``body(state, generator)`` — a function that advances a tree
    of tensors IN PLACE — run ``n`` at a time.

    On CUDA the first `run` at a state layout (the shapes and dtypes of its
    tensors) copies the state into buffers of the runner's own, runs one
    step eagerly on a side stream (cuBLAS workspaces, the first K/V writes)
    and captures the step in a CUDA graph over those buffers; every later
    step of that layout is a replay. A state whose tensors are the buffers
    (the previous run's result) is not copied. A sampled body draws from
    the runner's generator, registered with each graph: each run takes the
    caller's generator state in and hands the advanced state back, so a
    replay draws what the eager step would. The counts — ``eager_steps``,
    ``captures``, ``replays`` — are what `chip_smoke.py` prints. On the
    CPU, ``body`` runs eagerly on the caller's tensors and generator.
    """

    def __init__(self, body, device, *, sampled: bool = False,
                 host_collectives: bool = False):
        self.body = body
        self.device = torch.device(device)
        # A step whose forward communicates through host memory (a
        # model-parallel model under gloo) cannot sit in a graph.
        self.graphs = self.device.type == "cuda" and not host_collectives
        self.generator = (torch.Generator(device=self.device)
                          if self.graphs and sampled else None)
        self.eager_steps = self.captures = self.replays = 0
        self._entries: dict = {}
        self._ident = self._params = None
        self._stream = torch.cuda.Stream(self.device) if self.graphs else None

    def counts(self) -> dict:
        return {"eager_steps": self.eager_steps, "captures": self.captures,
                "replays": self.replays}

    def bind(self, body, params) -> None:
        """Step ``body``, which reads ``params`` (None: the model's own,
        read in place): a graph holds the addresses of the tensors its
        step read, so other ``params`` tensors drop the graphs (the next
        run captures again). The runner keeps ``params`` alive."""
        ident = None if params is None else [id(t) for t in _leaves(params)]
        if self.body is None or ident != self._ident:
            self.reset()
            self.body, self._ident, self._params = body, ident, params

    def reset(self) -> None:
        if self._entries and self.graphs:
            torch.cuda.synchronize(self.device)  # no replay still reads them
        self._entries = {}

    def run(self, state, n: int, rng=None):
        """``n`` steps from ``state``; returns the state after them — on
        CUDA the runner's buffers, valid until its next run."""
        if not self.graphs:
            for _ in range(n):
                self.body(state, rng)
                self.eager_steps += 1
            return state
        key = _layout(state)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = [None, clone_state(state), False]
        else:
            for dst, src in zip(_leaves(entry[1]), _leaves(state)):
                if dst is not src:
                    dst.copy_(src)
        static = entry[1]
        gen = self.generator
        if gen is not None:
            gen.set_state(rng.get_state())
        left = n
        if entry[0] is None and left:
            if not entry[2]:  # one eager step at this layout first
                self._eager(static)
                entry[2] = True
                left -= 1
            if left:
                entry[0] = self._capture(static)
        for _ in range(left):
            entry[0].replay()
            self.replays += 1
        if gen is not None:
            rng.set_state(gen.get_state())
        return static

    def _eager(self, static) -> None:
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.body(static, self.generator)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.eager_steps += 1

    def _capture(self, static):
        graph = torch.cuda.CUDAGraph()
        gen = self.generator
        if gen is not None:
            graph.register_generator_state(gen)
            before = gen.get_state()
        torch.cuda.synchronize(self.device)
        with torch.cuda.graph(graph, stream=self._stream):
            self.body(static, gen)
        if gen is not None:
            gen.set_state(before)  # the capture drew nothing
        self.captures += 1
        return graph


# -- the decode family's building blocks --------------------------------------


class _Decode(nn.Module):
    """``model.decode`` as a module call, so `torch.func.functional_call`
    can run it over other parameters."""

    def __init__(self, model):
        super().__init__()
        self.lm = model

    def forward(self, tokens, cache=None, max_decode_len: int = 0):
        return self.lm.decode(tokens, cache, max_decode_len=max_decode_len)


def decode_fn(model, params=None, unpack=None):
    """``model.decode`` over ``params`` (a state_dict-like mapping, or a
    `quant.quantize_params` tree with ``unpack`` its dequantization) in
    place of the model's own parameters — the JAX ``apply({"params":
    unpack(qparams)}, ...)``. ``unpack`` runs at every call, inside the
    captured step when the caller is one."""
    if params is None:
        return model.decode
    wrapper = _Decode(model)
    unpack = unpack or (lambda p: p)

    def call(tokens, cache=None, max_decode_len: int = 0):
        full = {f"lm.{k}": v for k, v in unpack(params).items()}
        return torch.func.functional_call(
            wrapper, full, (tokens, cache), {"max_decode_len": max_decode_len}
        )

    return call


def decode_models(model, *, quantized_cache: bool = False,
                  int8_compute: bool = False):
    """``(step model, prefill model)``: ``model`` with the int8 cache when
    asked, and its clone with ``int8_compute`` for the prefill (JAX applies
    int8 compute to the prefill only: compute-bound there, while a decode
    step is bandwidth-bound)."""
    dmodel = model
    if quantized_cache and not model.quantized_cache:
        dmodel = model.clone(quantized_cache=True)
    pmodel = dmodel.clone(int8_compute=True) if int8_compute else dmodel
    return dmodel, pmodel


def check_params(quantized: bool, params) -> None:
    if quantized and params is None:
        raise ValueError(
            "quantized=True decodes from an int8 tree: pass "
            "params=quant.quantize_params(model)"
        )
    if quantized and not any(quant.is_qleaf(v) for v in params.values()):
        raise ValueError("quantized=True needs a quant.quantize_params tree")


def _prefill(dec, prompt, lengths, max_new_tokens):
    """Prompt forward creating the cache; returns ``(last_logits, cache)``
    with the ragged-lengths layout applied."""
    b, t0 = prompt.shape
    logits, cache = dec(prompt, max_decode_len=t0 + max_new_tokens)
    if lengths is None:
        return logits[:, -1], cache
    # A tensor of its own: the steps advance the cache index in place.
    lengths = torch.as_tensor(lengths, device=prompt.device).to(
        torch.int32, copy=True)
    rows = torch.arange(b, device=prompt.device)
    last = logits[rows, lengths.long() - 1]
    return last, {**cache, "index": lengths}


def _first(dec, device, prompt, rng, lengths, max_new_tokens, sampling,
           eos_id):
    prompt = torch.as_tensor(prompt, device=device).to(torch.int32)
    last, cache = _prefill(dec, prompt, lengths, max_new_tokens)
    tok = _sample(last, rng, *sampling)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_id is None
            else tok == eos_id)
    return prompt, (cache, tok, rng, done)


def _token_step(dec, sampling, eos_id):
    """The per-token step over the state tree ``{"cache", "tok", "done",
    "out", "t"}``: one decode step, a draw, the eos fill, the token written
    to column ``t`` of ``out``."""
    fill = 0 if eos_id is None else eos_id

    def body(s, gen):
        logits, new = dec(s["tok"][:, None], s["cache"])
        s["cache"]["index"].copy_(new["index"])
        nxt = _sample(logits[:, -1], gen, *sampling)
        nxt = torch.where(s["done"], torch.full_like(nxt, fill), nxt)
        if eos_id is not None:
            s["done"].logical_or_(nxt == eos_id)
        s["tok"].copy_(nxt)
        s["out"].index_copy_(1, s["t"], nxt[:, None])
        s["t"].add_(1)

    return body


def _token_state(cache, tok, done, width: int) -> dict:
    # tok and done are copies: the steps advance them in place, and the
    # caller keeps the first token.
    return {"cache": cache, "tok": tok.clone(), "done": done.clone(),
            "out": tok.new_zeros((tok.shape[0], width)),
            "t": torch.zeros(1, dtype=torch.long, device=tok.device)}


def _steps(runner, state, n, width):
    """``n`` decode steps from ``(cache, tok, rng, done)``; returns
    ``(tokens [B, n], state after them)`` — the state's tensors are
    ``runner``'s buffers on CUDA."""
    cache, tok, rng, done = state
    s = runner.run(_token_state(cache, tok, done, width), n, rng)
    return s["out"][:, :n], (s["cache"], s["tok"], rng, s["done"])


def make_generate_fn(model, *, max_new_tokens: int, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0,
                     eos_id: int | None = None, include_prompt: bool = True,
                     quantized: bool = False, int8_compute: bool = False,
                     quantized_cache: bool = False):
    """The generator ``fn(prompt [B, T0], rng=None, lengths=None, *,
    params=None) -> tokens`` over ``model`` (a `TransformerLM`, decode mode
    with a cache of ``T0 + max_new_tokens``). ``rng`` defaults to seed 0 on
    the model's device; ``lengths`` ([B]) selects the ragged-prompt
    contract (module docstring); ``params`` replaces the model's
    parameters — with ``quantized=True`` it must be a
    `quant.quantize_params` tree, dequantized (to bf16, as JAX) inside each
    step. ``int8_compute`` runs the prefill's matmuls on int8;
    ``quantized_cache`` stores K/V as int8. The decode steps are replays of
    one captured step on CUDA (``fn.steps``, a `StepGraph`). Runs under
    `torch.inference_mode`."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    check_sampling_params(temperature, top_p)
    sampling = (temperature, top_k, top_p)
    dmodel, pmodel = decode_models(model, quantized_cache=quantized_cache,
                                   int8_compute=int8_compute)
    unpack = quant.make_unpack(quantized)
    from horovod_tpu_torch.training.graphs import (
        forward_communicates_over_host,
    )

    runner = StepGraph(None, model.device, sampled=temperature > 0.0,
                       host_collectives=forward_communicates_over_host(model))
    width = max(1, max_new_tokens - 1)

    @torch.inference_mode()
    def run(prompt, rng=None, lengths=None, *, params=None):
        check_params(quantized, params)
        if rng is None:
            rng = make_rng(0, model.device)
        runner.bind(_token_step(decode_fn(dmodel, params, unpack),
                                sampling, eos_id), params)
        prompt, state = _first(
            decode_fn(pmodel, params, unpack), model.device, prompt, rng,
            lengths, max_new_tokens, sampling, eos_id,
        )
        rest, _ = _steps(runner, state, max_new_tokens - 1, width)
        gen = torch.cat([state[1][:, None], rest], dim=1)
        return torch.cat([prompt, gen], dim=1) if include_prompt else gen

    run.steps = runner
    return run


def make_chunked_generate_fns(model, *, max_new_tokens: int, chunk: int,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 0.0, eos_id: int | None = None,
                              quantized_cache: bool = False):
    """Chunked generation for streaming serving: ``(start_fn, cont_fn)``.

    * ``start_fn(prompt [B, T0], rng, lengths [B]) -> (tokens [B, chunk],
      state)`` — prefill + the first ``chunk`` tokens (ragged lengths);
    * ``cont_fn(state) -> (tokens [B, chunk], state)`` — the next ``chunk``
      tokens against the carried cache.

    ``state`` is ``(cache, last_tok, rng, done)``, tensors of its own (not
    the runner's buffers). The cache is sized ``T0 + max_new_tokens``, so at
    most ``max_new_tokens / chunk`` chunks are valid — the caller enforces
    the budget. Token streams equal `make_generate_fn`'s for the same knobs
    and generator. Both functions step through one `StepGraph`
    (``start_fn.steps``): a chunk is ``chunk`` replays on CUDA."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if max_new_tokens % chunk != 0:
        raise ValueError(
            f"chunk ({chunk}) must divide max_new_tokens ({max_new_tokens})"
        )
    check_sampling_params(temperature, top_p)
    sampling = (temperature, top_k, top_p)
    dmodel, _ = decode_models(model, quantized_cache=quantized_cache)
    runner = StepGraph(_token_step(dmodel.decode, sampling, eos_id),
                       model.device, sampled=temperature > 0.0)

    def own(tokens, state):
        cache, tok, rng, done = state
        return tokens.clone(), (clone_state(cache), tok.clone(), rng,
                                done.clone())

    @torch.inference_mode()
    def start(prompt, rng, lengths):
        _, state = _first(
            dmodel.decode, model.device, prompt, rng, lengths,
            max_new_tokens, sampling, eos_id,
        )
        first = state[1]
        rest, state = _steps(runner, state, chunk - 1, chunk)
        return own(torch.cat([first[:, None], rest], dim=1), state)

    @torch.inference_mode()
    def cont(state):
        return own(*_steps(runner, state, chunk, chunk))

    start.steps = cont.steps = runner
    return start, cont


def generate(model, prompt, max_new_tokens: int, *, rng=None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_id: int | None = None, include_prompt: bool = True,
             quantized: bool = False, int8_compute: bool = False,
             quantized_cache: bool = False, params=None):
    """Generate ``max_new_tokens`` continuations of ``prompt`` ([B, T0]
    ints) on the model's device. ``temperature=0`` = greedy; after a row
    emits ``eos_id`` its remaining positions are filled with it. The knobs
    and ``params`` as in `make_generate_fn`."""
    fn = make_generate_fn(
        model, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_id=eos_id,
        include_prompt=include_prompt, quantized=quantized,
        int8_compute=int8_compute, quantized_cache=quantized_cache,
    )
    return fn(prompt, rng, params=params)
