"""Packed-sequence LM pretraining, end to end — the twin of the JAX
package's ``examples/lm_packed_pretraining.py``.

The standard long-context data format: variable-length documents packed
into fixed [B, T] rows.

1. `data.packing.pack_documents`: best-fit-decreasing packing → static rows
   + segment ids (padding isolated in segment 0);
2. `data.packing.next_token_pairs`: shifted (x, y, loss-weights) whose mask
   stops targets at document boundaries;
3. `TransformerLM(..., segment_ids=...)`: per-document RoPE restart and the
   flash kernels' segment-masked attention;
4. a weighted cross-entropy Trainer loss via the callable-loss hook.

The corpus is synthetic: each "document" is a repeated random motif, so a
model that attends within documents learns the motif quickly — falling loss
is the functional check.

Run (any mesh; ids shard with the tokens; on a live ``seq`` axis attention
is the flash ring over the ``seq`` group):

    python -m horovod_tpu_torch.examples.lm_packed_pretraining
    HVT_MESH="data=2,seq=4" python -m horovod_tpu_torch.launch run \\
        --nprocs 8 -- python -m horovod_tpu_torch.examples.lm_packed_pretraining

Knobs: SEQ_LEN, DOCS, DRIVE_EPOCHS, DRIVE_STEPS, VOCAB, DMODEL, NLAYERS,
TEXT, as in the JAX script, plus ``HVT_DEVICE`` (``cuda``, the default, or
``cpu``). ``main()`` returns the fit's history.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvt
from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data.packing import (
    next_token_pairs,
    pack_documents,
    packing_efficiency,
)
from horovod_tpu_torch.models.transformer import (
    ShardingConfig,
    TransformerLM,
    param_specs,
)
from horovod_tpu_torch.parallel import mesh as mesh_lib


def synthetic_corpus(n_docs: int, vocab: int, seed: int = 0):
    """Documents of motif repeats: learnable within-document structure."""
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n_docs):
        motif = rng.randint(1, vocab, size=rng.randint(4, 12))
        reps = rng.randint(2, 8)
        docs.append(np.tile(motif, reps).astype(np.int32))
    return docs


class PackedLM(torch.nn.Module):
    """TransformerLM + a per-row segment-id channel carried IN the input:
    ``[B, T, 2]`` = tokens ⊕ ids, so the packed metadata flows through
    fit/evaluate without a Trainer-side protocol change."""

    def __init__(self, inner: TransformerLM):
        super().__init__()
        self.inner = inner

    def forward(self, xs, *, train: bool = False, dropout_seed=None):
        return self.inner(xs[..., 0], train=train, segment_ids=xs[..., 1],
                          dropout_seed=dropout_seed)


def text_corpus(n_docs: int, seed: int = 0):
    """Synthetic TEXT documents (motifs of words) for the TEXT=1 path:
    ByteBPETokenizer.train → encode → pack."""
    rng = np.random.RandomState(seed)
    words = [
        "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
        "theta", "iota", "kappa", "lambda", "mu",
    ]
    docs = []
    for _ in range(n_docs):
        motif = " ".join(rng.choice(words, size=rng.randint(3, 7)))
        docs.append(" ".join([motif] * rng.randint(2, 6)))
    return docs


def masked_ce(logits, y2):
    """Per-row mean cross-entropy with boundary/padding positions zeroed
    (``y2`` = targets ⊕ 0/1 weights); the Trainer means over the rows."""
    targets, weights = y2[..., 0], y2[..., 1].float()
    lf = logits.float()
    per = F.cross_entropy(lf.reshape(-1, lf.shape[-1]),
                          targets.reshape(-1).long(),
                          reduction="none").view(targets.shape)
    return (per * weights).sum(-1) / weights.sum(-1).clamp_min(1.0)


def main():
    hvt.init(device=registry.get_str("HVT_DEVICE"))
    device = runtime.device()
    mesh = mesh_lib.build_mesh(
        mesh_lib.MeshSpec.from_string(os.environ.get("HVT_MESH"))
    )
    seq_len = int(os.environ.get("SEQ_LEN", 256))
    vocab = int(os.environ.get("VOCAB", 64))

    if os.environ.get("TEXT"):
        # Full text pipeline: raw strings → trained byte-BPE → token docs.
        from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer

        texts = text_corpus(int(os.environ.get("DOCS", 2000)))
        vocab = int(os.environ.get("VOCAB", 384))
        tokenizer = ByteBPETokenizer.train(texts, vocab_size=vocab)
        vocab = tokenizer.vocab_size  # training may stop below the budget
        docs = tokenizer.encode_corpus(texts)
        if hvt.is_primary():
            path = os.path.join(
                os.environ.get("PS_MODEL_PATH", "./models"), "tokenizer.json"
            )
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tokenizer.save(path)
            raw = sum(len(t.encode()) for t in texts)
            enc = sum(len(d) for d in docs)
            print(
                f"byte-BPE: vocab {vocab}, {raw} bytes -> {enc} tokens "
                f"({raw / enc:.2f} bytes/token), saved {path}"
            )
    else:
        docs = synthetic_corpus(int(os.environ.get("DOCS", 2000)), vocab)
    # Pack at seq_len + 1: the shifted next-token pairs then span exactly
    # seq_len positions — divisible by a live `seq` axis.
    toks, seg, _ = pack_documents(docs, seq_len=seq_len + 1)
    if hvt.is_primary():
        print(
            f"packed {len(docs)} docs -> {toks.shape[0]} rows x "
            f"{toks.shape[1]}, "
            f"occupancy {packing_efficiency(seg):.3f}"
        )
    x, y, w = next_token_pairs(toks, seg)
    seg_x = seg[:, :-1]
    # Tokens ⊕ ids and targets ⊕ 0/1 loss weights ride the (x, y) feed.
    xs = np.stack([x, seg_x], axis=-1)
    ys = np.stack([y, w.astype(np.int32)], axis=-1)

    model = PackedLM(
        TransformerLM(
            vocab_size=vocab,
            d_model=int(os.environ.get("DMODEL", 128)),
            n_heads=4,
            n_layers=int(os.environ.get("NLAYERS", 2)),
            dropout=0.0,
            compute_dtype=torch.bfloat16,
            sharding=ShardingConfig(mesh=mesh),
            device=device,
        )
    )
    # The epoch log's `accuracy` column argmaxes the 2-channel y, as in
    # the JAX script: the masked LOSS is the training signal here.
    batch_spec = mesh_lib.P(
        (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS), mesh_lib.SEQ_AXIS, None
    )
    trainer = hvt.Trainer(
        model,
        hvt.DistributedOptimizer(hvt.adamw(hvt.scale_lr(3e-3))),
        loss=masked_ce,
        mesh=mesh,
        param_specs=param_specs,
        batch_specs=(batch_spec, batch_spec),
        device=device,
    )
    rows_needed = 8 * mesh_lib.dp_size(mesh)
    n = (len(xs) // rows_needed) * rows_needed
    if n == 0:
        raise SystemExit(
            f"corpus packs to only {len(xs)} rows but one global batch "
            f"needs {rows_needed} (batch 8 x dp {mesh_lib.dp_size(mesh)}) "
            "- raise DOCS or lower SEQ_LEN"
        )
    history = trainer.fit(
        x=xs[:n], y=ys[:n],
        batch_size=8,
        epochs=int(os.environ.get("DRIVE_EPOCHS", 0)) or 3,
        steps_per_epoch=int(os.environ.get("DRIVE_STEPS", 0)) or 8,
        # The JAX trainer logs the global batch's loss; the port's ranks
        # log their own data shard's until the epoch logs are averaged.
        callbacks=[hvt.callbacks.BroadcastGlobalVariablesCallback(0),
                   hvt.callbacks.MetricAverageCallback()],
    )
    if hvt.is_primary():
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"masked loss: {first:.3f} -> {last:.3f}")
        print("packed pretraining:", "LEARNING" if last < first else "flat")
    return history


if __name__ == "__main__":
    main()
