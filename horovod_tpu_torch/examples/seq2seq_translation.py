"""Sequence-to-sequence transduction, end to end: text → BPE → seq2seq —
the twin of the JAX package's ``examples/seq2seq_translation.py``.

1. `data.tokenizer.ByteBPETokenizer`: train byte-BPE on the raw corpus
   (saved next to the checkpoints for serving-side reuse);
2. `models.seq2seq.Seq2SeqTransformer`: teacher-forced training through the
   Trainer's dict-batch feeding (``x={"src", "tgt"}``), on a data mesh or a
   ``data × seq`` mesh (all three attention sites as rings over ``seq``);
3. `make_seq2seq_generate_fn`: encode once, a BOS prefill that writes each
   decoder block's cross-K/V cache, then captured single-token steps.

The task is synthetic word-level REVERSAL ("alpha beta gamma" → "gamma
beta alpha"): the content must flow through cross-attention, since the
alignment is position-reversed.

Run:
    python -m horovod_tpu_torch.examples.seq2seq_translation
    HVT_MESH="data=2,seq=2" python -m horovod_tpu_torch.launch run \\
        --nprocs 4 -- python -m horovod_tpu_torch.examples.seq2seq_translation

    HVT_MESH="data=4,model=2" python -m horovod_tpu_torch.launch run \
        --nprocs 8 -- python -m horovod_tpu_torch.examples.seq2seq_translation

On a live ``seq`` axis the twin passes ``batch_specs`` (every part's dim 1
over ``seq``): the JAX script passes none, since its default layout
computes the same global arithmetic, while the port keeps that default
refused (ROADMAP queue A item 12.4). On a live ``model`` or ``fsdp`` axis
(the JAX script's ``HVT_MESH="data=4,model=2"``) the model holds its
Megatron and FSDP parts (`models.seq2seq`), and the decode runs on
``clone(sharding=ShardingConfig())``, the gathered weights, as the JAX
script decodes.

Knobs: DOCS, DRIVE_EPOCHS, DMODEL, PS_MODEL_PATH, HVT_MESH, as in the JAX
script, plus ``HVT_DEVICE`` (``cuda``, the default, or ``cpu``). ``main()``
returns ``(history, accuracy)``.
"""

import os

import numpy as np

import horovod_tpu_torch as hvt
from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data.tokenizer import ByteBPETokenizer
from horovod_tpu_torch.models.decoding import make_rng
from horovod_tpu_torch.models.seq2seq import (
    Seq2SeqTransformer,
    make_seq2seq_generate_fn,
    param_specs,
)
from horovod_tpu_torch.models.transformer import ShardingConfig
from horovod_tpu_torch.parallel import mesh as mesh_lib

PAD, BOS, EOS = 0, 1, 2
WORDS = [
    "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
    "iota", "kappa", "lambda", "mu", "nu", "xi",
]


def corpus(n: int, seed: int = 0):
    """(source sentence, word-reversed target) string pairs."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        ws = list(rng.choice(WORDS, size=rng.randint(2, 6)))
        pairs.append((" ".join(ws), " ".join(reversed(ws))))
    return pairs


def encode_pairs(tok, pairs, max_len: int):
    """Fixed-shape (src, tgt_in, labels) arrays; EOS-terminated, PAD-tailed.
    Label PAD positions are trained to PAD (the plain CE loss stays
    usable)."""
    n = len(pairs)
    src = np.full((n, max_len), PAD, np.int32)
    tgt_in = np.full((n, max_len), PAD, np.int32)
    labels = np.full((n, max_len), PAD, np.int32)
    for i, (s, t) in enumerate(pairs):
        se = (tok.encode(s) + [tok.special_id("<eos>")])[:max_len]
        te = (tok.encode(t) + [tok.special_id("<eos>")])[:max_len]
        src[i, : len(se)] = se
        labels[i, : len(te)] = te
        tgt_in[i, 0] = BOS
        tgt_in[i, 1 : len(te)] = te[:-1]
    return src, tgt_in, labels


def main():
    spec = mesh_lib.MeshSpec.from_string(os.environ.get("HVT_MESH"))
    hvt.init(device=registry.get_str("HVT_DEVICE"))
    device = runtime.device()
    mesh = mesh_lib.build_mesh(spec)
    model_dir = os.path.join(
        os.environ.get("PS_MODEL_PATH", "./models"), "seq2seq-reversal"
    )
    os.makedirs(model_dir, exist_ok=True)

    n_docs = int(os.environ.get("DOCS", 8192))
    pairs = corpus(n_docs)
    # Merge budget sized so every word collapses to ~1 token; with too few
    # merges 4-5-word sentences overflow max_len and truncation drops the
    # EOS and the source tail.
    tok = ByteBPETokenizer.train(
        (s for p in pairs for s in p), vocab_size=256 + 128 + 1,
        specials=("<eos>",),
    )
    if hvt.is_primary():
        tok.save(os.path.join(model_dir, "tokenizer.json"))
    max_len = 16
    # Refuse (don't truncate) pairs that can't fit: a clipped pair is
    # unanswerable and would poison the accuracy gate.
    fit_pairs = [
        p for p in pairs
        if max(len(tok.encode(p[0])), len(tok.encode(p[1]))) < max_len
    ]
    if hvt.is_primary() and len(fit_pairs) < len(pairs):
        print(f"dropped {len(pairs) - len(fit_pairs)} overlong pairs")
    pairs = fit_pairs
    src, tgt_in, labels = encode_pairs(tok, pairs, max_len)
    if hvt.is_primary():
        print(
            f"byte-BPE vocab {tok.vocab_size}; {n_docs} pairs at "
            f"max_len {max_len}"
        )

    # Model vocab padded up to a multiple of 8 (a column-parallel lm_head
    # shards its vocab dim over `model`); unused ids cost nothing.
    model_vocab = -(-tok.vocab_size // 8) * 8
    model = Seq2SeqTransformer(
        vocab_size=model_vocab,
        d_model=int(os.environ.get("DMODEL", 96)),
        n_heads=4,
        n_enc_layers=2,
        n_dec_layers=2,
        dropout=0.0,
        pad_id=PAD,
        sharding=ShardingConfig(mesh=mesh),
        device=device,
    )
    # LR scales by the DATA-parallel degree (the global batch grows only
    # with dp).
    dp = mesh_lib.dp_size(mesh)
    batch_specs = None
    if mesh.seq_shards > 1:
        part = mesh_lib.P(
            (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS), mesh_lib.SEQ_AXIS
        )
        batch_specs = (part, part)
    trainer = hvt.Trainer(
        model,
        hvt.DistributedOptimizer(hvt.adam(1e-3 * dp)),
        loss="sparse_categorical_crossentropy",
        mesh=mesh,
        param_specs=param_specs,
        batch_specs=batch_specs,
        device=device,
    )
    epochs = int(os.environ.get("DRIVE_EPOCHS", 6))
    history = trainer.fit(
        x={"src": src, "tgt": tgt_in}, y=labels,
        epochs=epochs, batch_size=16,
        callbacks=[
            hvt.callbacks.BroadcastGlobalVariablesCallback(0),
            # The scaled LR from a cold start can land this task in a
            # copy-instead-of-reverse minimum on wide data meshes.
            hvt.callbacks.LearningRateWarmupCallback(
                warmup_epochs=2, world_size=dp
            ),
        ],
        verbose=1,
    )

    # Held-out generation: greedy decode must produce the reversal.
    test_pairs = [
        p for p in corpus(48, seed=999)
        if max(len(tok.encode(p[0])), len(tok.encode(p[1]))) < max_len
    ][:32]
    tsrc, _, tlabels = encode_pairs(tok, test_pairs, max_len)
    gen = make_seq2seq_generate_fn(
        # Decode on no mesh: the gathered weights (a collective).
        model.clone(sharding=ShardingConfig()),
        max_new_tokens=max_len, bos_id=BOS, eos_id=tok.special_id("<eos>"),
    )
    out = gen(tsrc, make_rng(0, model.device)).cpu().numpy()
    # Token accuracy over the real (non-PAD) label positions.
    mask = tlabels != PAD
    acc = float((out[mask] == tlabels[mask]).mean())
    if hvt.is_primary():
        eos = tok.special_id("<eos>")
        for i in range(2):
            row = list(out[i])
            row = row[: row.index(eos)] if eos in row else row
            print("src:", test_pairs[i][0])
            print("out:", tok.decode([t for t in row if t > EOS]))
        print(f"held-out reversal token accuracy: {acc:.3f}")
        print("REVERSAL " + ("LEARNED" if acc > 0.8 else "NOT LEARNED"))
    return history, acc


if __name__ == "__main__":
    main()
