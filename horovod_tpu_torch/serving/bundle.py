"""Generation serving bundles — port of `horovod_tpu.serving.bundle`.

The JAX bundle is a StableHLO program plus msgpack weights, which a host
without JAX and flax cannot read. The port's bundle is its own format, in
the same timestamped directory convention (``export_dir/<stamp>/``):

* ``generate.json`` — the JAX bundle's keys (shapes, sampling knobs,
  eos/pad ids, streaming chunk, the int8 and speculative knobs, ...) plus
  ``model``: the `TransformerLM` hyperparameters (a JAX bundle carries
  these inside its program);
* ``weights.pt`` — ``torch.save`` of the model's state_dict;
* ``tokenizer.json`` — optional `data.tokenizer.ByteBPETokenizer`, in the
  JAX package's format.

Ragged prompts are first-class: the bundle serves one ``[batch_size,
prompt_len]`` shape, and prompts of any length ≤ ``prompt_len`` are
right-padded with per-row true lengths (the decoding module's ragged
contract), so clients never see the static shape. The knobs bake in as in
the JAX bundle: ``int8_compute`` (int8 prefill matmuls), ``quantized_cache``
(the int8 K/V cache), ``speculative_gamma`` (the speculative decoder with
the prompt-lookup draft: greedy only, no eos, no int8_compute) and
``streaming_chunk`` (the chunked generator pair), with the JAX bundle's
validation and errors.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer
from horovod_tpu_torch.models.decoding import (
    make_chunked_generate_fns,
    make_generate_fn,
    make_rng,
)
from horovod_tpu_torch.models.speculative import make_speculative_fn
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.runtime import resolve_device

GEN_META_FILE = "generate.json"
GEN_WEIGHTS_FILE = "weights.pt"
TOKENIZER_FILE = "tokenizer.json"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _generators(model, *, max_new_tokens: int, temperature: float,
                top_k: int, top_p: float, eos_id, int8_compute: bool,
                quantized_cache: bool, speculative_gamma: int,
                streaming_chunk: int) -> dict:
    """The bundle's generator functions over ``model``, validated as the
    JAX bundle validates them: ``{"call": one-shot fn}`` or ``{"start",
    "cont"}`` for a streaming bundle."""
    if speculative_gamma:
        if temperature != 0.0:
            raise ValueError(
                "speculative bundles are greedy-only (temperature == 0): "
                "the exported program carries no rng input"
            )
        if eos_id is not None:
            raise ValueError(
                "speculative decoding does not support eos early-stop — "
                "export without eos_id or without speculative_gamma"
            )
        if int8_compute:
            raise ValueError(
                "int8_compute is not wired into the speculative loop — "
                "export with one or the other"
            )
    if streaming_chunk:
        if speculative_gamma:
            raise ValueError(
                "streaming_chunk and speculative_gamma are exclusive — "
                "one program shape per bundle"
            )
        if int8_compute:
            raise ValueError(
                "int8_compute is not wired into the chunked generator — "
                "export with one or the other"
            )
        start, cont = make_chunked_generate_fns(
            model, max_new_tokens=max_new_tokens, chunk=streaming_chunk,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
            quantized_cache=quantized_cache,
        )
        return {"start": start, "cont": cont}
    if speculative_gamma:
        target = (model.clone(quantized_cache=True) if quantized_cache
                  else model)
        return {"call": make_speculative_fn(
            target, max_new_tokens=max_new_tokens, gamma=speculative_gamma,
            include_prompt=False,
        )}
    return {"call": make_generate_fn(
        model, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_id=eos_id, include_prompt=False,
        int8_compute=int8_compute, quantized_cache=quantized_cache,
    )}


def export_generate(
    export_dir: str,
    model: TransformerLM,
    *,
    batch_size: int,
    prompt_len: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    eos_id: int | None = None,
    pad_id: int = 0,
    tokenizer=None,
    timestamp: str | None = None,
    int8_compute: bool = False,
    quantized_cache: bool = False,
    speculative_gamma: int = 0,
    streaming_chunk: int = 0,
) -> str:
    """Export a generation bundle of ``model`` into ``export_dir/<stamp>/``
    and return that directory. Knobs as in the JAX package; every knob is
    validated before the directory exists. A model that holds parameter
    shards over a mesh is exported gathered: every rank calls, the primary
    writes (`checkpoint.gather_for_export`)."""
    if prompt_len < 1 or batch_size < 1:
        raise ValueError(
            f"batch_size ({batch_size}) and prompt_len ({prompt_len}) "
            "must be >= 1"
        )
    if isinstance(tokenizer, str) and not os.path.isfile(tokenizer):
        raise FileNotFoundError(f"no tokenizer file {tokenizer}")
    from horovod_tpu_torch.checkpoint import gather_for_export

    model, stamp, writes = gather_for_export(model, "export_generate",
                                             timestamp)
    # The generator builders validate the knobs (chunk | max_new_tokens,
    # sampling ranges) — build them once for that. Every check runs before
    # the output directory exists.
    _generators(model, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_id=eos_id, int8_compute=int8_compute,
                quantized_cache=quantized_cache,
                speculative_gamma=speculative_gamma,
                streaming_chunk=streaming_chunk)
    out_dir = os.path.join(export_dir, stamp)
    if not writes:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = os.path.join(out_dir, GEN_WEIGHTS_FILE + ".tmp")
    torch.save(weights, tmp)
    os.replace(tmp, os.path.join(out_dir, GEN_WEIGHTS_FILE))
    meta = {
        "kind": "generate",
        "batch_size": batch_size,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "temperature": temperature,
        "top_k": top_k,
        "top_p": top_p,
        "eos_id": eos_id,
        "pad_id": pad_id,
        "int8_compute": int8_compute,
        "quantized_cache": quantized_cache,
        "speculative_gamma": speculative_gamma,
        "streaming_chunk": streaming_chunk,
        "has_tokenizer": tokenizer is not None,
        "created": stamp,
        "model": model.config(),
    }
    # Tokenizer BEFORE the meta that advertises it, and the meta LAST: a
    # crash mid-export never leaves a bundle that loads, or one whose meta
    # promises what is not there.
    if tokenizer is not None:
        tok_path = os.path.join(out_dir, TOKENIZER_FILE)
        if isinstance(tokenizer, str):
            shutil.copyfile(tokenizer, tok_path)
        else:
            tokenizer.save(tok_path)
    _atomic_write(
        os.path.join(out_dir, GEN_META_FILE),
        json.dumps(meta, indent=2).encode(),
    )
    return out_dir


def is_generate_bundle(bundle_dir: str) -> bool:
    return os.path.exists(os.path.join(bundle_dir, GEN_META_FILE))


class GenerateBundle:
    """A reloaded generation bundle on ``device``: tokenize → pad → run →
    trim → detokenize.

    ``generate_tokens(prompts, seed)`` takes token-id sequences (each of
    length 1..prompt_len); requests of any row count are split / padded to
    the bundle's batch internally. ``generate_text(texts, seed)`` adds the
    tokenizer round trip (the bundle must carry one). Generations are
    trimmed at ``eos_id`` when the bundle was exported with one.
    """

    def __init__(self, bundle_dir: str, device="cuda"):
        self.device = resolve_device(device)
        self.bundle_dir = bundle_dir
        with open(os.path.join(bundle_dir, GEN_META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta.get("kind") != "generate":
            raise ValueError(f"{bundle_dir} is not a generation bundle")
        if "model" not in self.meta:
            raise ValueError(
                f"{bundle_dir} carries no 'model' hyperparameters — a JAX "
                "(StableHLO) bundle; export it with horovod_tpu_torch"
            )
        self.tokenizer = None
        tok_path = os.path.join(bundle_dir, TOKENIZER_FILE)
        if os.path.exists(tok_path):
            self.tokenizer = ByteBPETokenizer.load(tok_path)
        elif self.meta.get("has_tokenizer"):
            # An incomplete bundle fails here, not as token-id-only
            # serving behind a /healthz that advertises a tokenizer.
            raise FileNotFoundError(
                f"{bundle_dir} advertises a tokenizer (generate.json "
                f"has_tokenizer=true) but {TOKENIZER_FILE} is missing — "
                "the bundle is incomplete"
            )
        self.model = TransformerLM(**self.meta["model"], device=self.device)
        state = torch.load(
            os.path.join(bundle_dir, GEN_WEIGHTS_FILE),
            map_location=self.device, weights_only=True,
        )
        self.model.load_state_dict(state)
        self.model.eval()
        fns = _generators(
            self.model,
            max_new_tokens=int(self.meta["max_new_tokens"]),
            temperature=float(self.meta["temperature"]),
            top_k=int(self.meta["top_k"]),
            top_p=float(self.meta["top_p"]),
            eos_id=self.meta.get("eos_id"),
            int8_compute=bool(self.meta.get("int8_compute")),
            quantized_cache=bool(self.meta.get("quantized_cache")),
            speculative_gamma=int(self.meta.get("speculative_gamma") or 0),
            streaming_chunk=int(self.meta.get("streaming_chunk") or 0),
        )
        self._call = fns.get("call")
        self._start, self._cont = fns.get("start"), fns.get("cont")

    def release_graphs(self) -> None:
        """Drop the CUDA graphs of this bundle's decode steps (a server
        retiring the bundle calls it on the thread that ran them, so the
        graphs are never destroyed by another thread mid-capture)."""
        for fn in (self._call, self._start):
            if fn is not None:
                fn.steps.reset()

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def prompt_len(self) -> int:
        return int(self.meta["prompt_len"])

    def _pad(self, prompts):
        """Right-pad ≤ batch_size prompts into ``(padded [B, T0], lengths
        [B])`` int32 arrays (pad rows get length 1)."""
        padded = np.full(
            (self.batch_size, self.prompt_len),
            int(self.meta.get("pad_id") or 0), np.int32,
        )
        lengths = np.ones((self.batch_size,), np.int32)
        for i, p in enumerate(prompts):
            padded[i, : len(p)] = p
            lengths[i] = len(p)
        return padded, lengths

    def stream_chunks(self, prompts, seed: int = 0, chunk: int = 0):
        """Streaming generation: yields ``[B_req, chunk]`` lists of token
        ids per dispatch. Requires a streaming bundle and at most
        ``batch_size`` prompts; stops early once every row has emitted eos
        (when configured). ``chunk`` (the batch-group index) salts the
        seed; group 0 uses ``seed`` verbatim."""
        k = int(self.meta.get("streaming_chunk") or 0)
        if not k:
            raise ValueError(
                "this bundle was not exported with streaming_chunk — "
                "re-export to stream"
            )
        prompts = self.validate_prompts(prompts)
        if not prompts or len(prompts) > self.batch_size:
            raise ValueError(
                f"streaming takes 1..{self.batch_size} prompts per request, "
                f"got {len(prompts)}"
            )
        n = len(prompts)
        padded, lengths = self._pad(prompts)
        rng = make_rng(seed, self.device, salt=chunk)
        tokens, state = self._start(padded, rng, lengths)
        yield tokens[:n].tolist()
        total = int(self.meta["max_new_tokens"])
        for _ in range(total // k - 1):
            if self.meta.get("eos_id") is not None and bool(
                state[3][:n].all()
            ):
                return  # every live row finished — stop dispatching
            tokens, state = self._cont(state)
            yield tokens[:n].tolist()

    def validate_prompts(self, prompts) -> list:
        """Normalize to int32 row arrays; guided error outside 1..T0."""
        t0 = self.prompt_len
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        for i, p in enumerate(prompts):
            if not 1 <= len(p) <= t0:
                raise ValueError(
                    f"prompt {i} has {len(p)} tokens; this bundle serves "
                    f"prompts of 1..{t0} tokens"
                )
        return prompts

    def generate_batch(self, prompts, seed: int = 0, chunk: int = 0) -> list:
        """≤ batch_size validated prompt rows → trimmed generated-id
        lists (streaming bundles collect their chunks)."""
        if len(prompts) > self.batch_size:
            raise ValueError(
                f"{len(prompts)} rows > batch {self.batch_size}; use "
                "generate_tokens for auto-splitting"
            )
        if self.meta.get("streaming_chunk"):
            rows = [[] for _ in prompts]
            for part in self.stream_chunks(prompts, seed=seed, chunk=chunk):
                for i, r in enumerate(part):
                    rows[i].extend(r)
            return [self._trim(r) for r in rows]
        padded, lengths = self._pad(prompts)
        # Speculative bundles are greedy: no generator (the seed is unused).
        rng = (None if self.meta.get("speculative_gamma")
               else make_rng(seed, self.device, salt=chunk))
        gen = self._call(padded, rng, lengths)[: len(prompts)]
        return [self._trim(row) for row in gen.tolist()]

    def generate_tokens(self, prompts, seed: int = 0) -> list:
        """Token-id prompts → generated-id lists (prompt not included;
        trimmed at eos when configured)."""
        prompts = self.validate_prompts(prompts)
        b = self.batch_size
        out: list = []
        for ci, start in enumerate(range(0, len(prompts), b)):
            out.extend(self.generate_batch(
                prompts[start : start + b], seed=seed, chunk=ci
            ))
        return out

    def _trim(self, row) -> list:
        eos = self.meta.get("eos_id")
        row = [int(t) for t in row]
        if eos is None:
            return row
        return row[: row.index(eos)] if eos in row else row

    def encode_texts(self, texts) -> list:
        """Texts → token-id prompts through the bundle's tokenizer, each
        within ``prompt_len``."""
        if self.tokenizer is None:
            raise ValueError(
                "this bundle has no tokenizer.json — export with "
                "tokenizer=... or POST token ids to /v1/generate instead"
            )
        prompts = [self.tokenizer.encode(t) for t in texts]
        for i, p in enumerate(prompts):
            if len(p) > self.prompt_len:
                raise ValueError(
                    f"text {i} tokenizes to {len(p)} tokens; this bundle "
                    f"serves prompts of up to {self.prompt_len} tokens"
                )
        return prompts

    def generate_text(self, texts, seed: int = 0) -> list:
        """Texts → generated texts (tokenize, generate, detokenize)."""
        gen = self.generate_tokens(self.encode_texts(texts), seed=seed)
        return [self.tokenizer.decode(g) for g in gen]


def load_generate(bundle_dir: str, device="cuda") -> GenerateBundle:
    """Reload an `export_generate` bundle onto ``device``."""
    return GenerateBundle(bundle_dir, device=device)
