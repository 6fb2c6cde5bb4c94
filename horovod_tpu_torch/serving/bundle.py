"""Generation serving bundles — port of `horovod_tpu.serving.bundle`.

The JAX bundle is a StableHLO program plus msgpack weights, which a host
without JAX and flax cannot read. The port's bundle is its own format, in
the same timestamped directory convention (``export_dir/<stamp>/``):

* ``generate.json`` — the JAX bundle's keys (shapes, sampling knobs,
  eos/pad ids, streaming chunk, ...) plus ``model``: the `TransformerLM`
  hyperparameters (a JAX bundle carries these inside its program);
* ``weights.pt`` — ``torch.save`` of the model's state_dict.

Ragged prompts are first-class: the bundle serves one ``[batch_size,
prompt_len]`` shape, and prompts of any length ≤ ``prompt_len`` are
right-padded with per-row true lengths (the decoding module's ragged
contract), so clients never see the static shape. Token-id serving only:
the tokenizer is not ported yet.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from horovod_tpu_torch.models.decoding import (
    make_chunked_generate_fns,
    make_generate_fn,
    make_rng,
)
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.runtime import resolve_device

GEN_META_FILE = "generate.json"
GEN_WEIGHTS_FILE = "weights.pt"

_TOKENIZER_TODO = (
    "tokenizers are not ported yet — ROADMAP queue A item 10 "
    "(data/tokenizer.py); serve token ids"
)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


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
    validated before the directory exists."""
    if prompt_len < 1 or batch_size < 1:
        raise ValueError(
            f"batch_size ({batch_size}) and prompt_len ({prompt_len}) "
            "must be >= 1"
        )
    if tokenizer is not None:
        raise NotImplementedError(_TOKENIZER_TODO)
    if int8_compute or quantized_cache:
        raise NotImplementedError(
            "int8_compute / quantized_cache are not ported yet — ROADMAP "
            "queue A item 10 (decode: models/quant.py)"
        )
    if speculative_gamma:
        raise NotImplementedError(
            "speculative bundles are not ported yet — ROADMAP queue A item "
            "10 (decode: speculative.py)"
        )
    # The generator builders validate the knobs (chunk | max_new_tokens,
    # sampling ranges) — build them once for that.
    if streaming_chunk:
        make_chunked_generate_fns(
            model, max_new_tokens=max_new_tokens, chunk=streaming_chunk,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        )
    else:
        make_generate_fn(
            model, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_id=eos_id,
        )
    stamp = timestamp or time.strftime("%Y%m%d-%H%M%S")
    out_dir = os.path.join(export_dir, stamp)
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
        "has_tokenizer": False,
        "created": stamp,
        "model": model.config(),
    }
    # Meta LAST: a crash mid-export never leaves a bundle that loads.
    _atomic_write(
        os.path.join(out_dir, GEN_META_FILE),
        json.dumps(meta, indent=2).encode(),
    )
    return out_dir


def is_generate_bundle(bundle_dir: str) -> bool:
    return os.path.exists(os.path.join(bundle_dir, GEN_META_FILE))


class GenerateBundle:
    """A reloaded generation bundle on ``device``: pad → run → trim.

    ``generate_tokens(prompts, seed)`` takes token-id sequences (each of
    length 1..prompt_len); requests of any row count are split / padded to
    the bundle's batch internally. Generations are trimmed at ``eos_id``
    when the bundle was exported with one.
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
        if self.meta.get("has_tokenizer"):
            raise NotImplementedError(_TOKENIZER_TODO)
        self.tokenizer = None
        self.model = TransformerLM(**self.meta["model"], device=self.device)
        state = torch.load(
            os.path.join(bundle_dir, GEN_WEIGHTS_FILE),
            map_location=self.device, weights_only=True,
        )
        self.model.load_state_dict(state)
        self.model.eval()
        knobs = dict(
            max_new_tokens=int(self.meta["max_new_tokens"]),
            temperature=float(self.meta["temperature"]),
            top_k=int(self.meta["top_k"]),
            top_p=float(self.meta["top_p"]),
            eos_id=self.meta.get("eos_id"),
        )
        if self.meta.get("streaming_chunk"):
            self._start, self._cont = make_chunked_generate_fns(
                self.model, chunk=int(self.meta["streaming_chunk"]), **knobs
            )
            self._call = None
        else:
            self._call = make_generate_fn(
                self.model, include_prompt=False, **knobs
            )

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
        rng = make_rng(seed, self.device, salt=chunk)
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


def load_generate(bundle_dir: str, device="cuda") -> GenerateBundle:
    """Reload an `export_generate` bundle onto ``device``."""
    return GenerateBundle(bundle_dir, device=device)
