"""Long-context LM training with sequence + tensor parallelism — the twin
of the JAX package's ``examples/lm_long_context.py``.

A decoder-only transformer whose activations are sharded along the mesh's
``seq`` axis (attention as the flash ring, or Ulysses), whose projections
are tensor-parallel over ``model`` (Megatron: this rank's heads and MLP
features, f/g around them), whose weights are FSDP shards over ``fsdp``,
and whose batch is data-parallel — in one step.

The task is long-range recall (`data.datasets.copy_task`): the second half
of every sequence repeats the first half, so a model can only drive the
second half's loss toward 0 by attending across the sequence shards. The
report prints the recall-half loss and the irreducible first-half loss
(``LEARNED`` when the recall half falls below half of it), then the greedy
KV-cache decode of the repeated half from a first-half prompt and its
exact-match rate.

Run (one process a rank, through the port's launcher):

    python -m horovod_tpu_torch.examples.lm_long_context
    HVT_MESH="data=2,seq=2,model=2" python -m horovod_tpu_torch.launch run \\
        --nprocs 8 -- python -m horovod_tpu_torch.examples.lm_long_context
    HVT_MESH="data=2,fsdp=4" python -m horovod_tpu_torch.launch run \\
        --nprocs 8 -- python -m horovod_tpu_torch.examples.lm_long_context
    HVT_MESH="data=2,expert=4" MOE_EVERY=2 python -m \\
        horovod_tpu_torch.launch run --nprocs 8 -- \\
        python -m horovod_tpu_torch.examples.lm_long_context

Pipeline parallelism: a ``pipe`` axis switches to the pipelined model
(`models.pipelined_lm.PipelinedLM`: stage stacks over ``pipe``, the GPipe
schedule or ``SCHEDULE=1f1b``, ``N_MICRO`` microbatches, Megatron TP
inside each stage when ``model`` > 1 and the flash ring over ``seq``
inside each stage when ``seq`` > 1), as the JAX script does:

    HVT_MESH="data=2,pipe=4" N_MICRO=8 python -m horovod_tpu_torch.launch \\
        run --nprocs 8 -- python -m horovod_tpu_torch.examples.lm_long_context
    HVT_MESH="data=2,pipe=2,model=2" SCHEDULE=1f1b python -m \\
        horovod_tpu_torch.launch run --nprocs 8 -- \\
        python -m horovod_tpu_torch.examples.lm_long_context
    HVT_MESH="data=2,pipe=2,seq=2" python -m horovod_tpu_torch.launch \\
        run --nprocs 8 -- python -m horovod_tpu_torch.examples.lm_long_context

Knobs, as in the JAX script: HVT_MESH, SEQ_LEN, VOCAB, DMODEL, NLAYERS,
ATTN (ring|ulysses), REMAT=1, LOGITS=bf16, FUSED_CE=<n_chunks>, MOE_EVERY
and N_EXPERTS (with the mesh's ``expert`` axis), DRIVE_STEPS,
DRIVE_EPOCHS, and HVT_DEVICE_CACHE (the device-staged fit, under JAX's
rule: only where no pipe/seq/model/expert axis is live), and on a ``pipe``
mesh N_MICRO (default 4) and SCHEDULE (``gpipe``, the default, or
``1f1b``); plus ``HVT_DEVICE`` (``cuda``, the default, or ``cpu``).
``MOE_EVERY`` with a live ``model`` axis raises naming item 18.

The greedy decode (the `TransformerLM` branch only, as in JAX): JAX runs it
only at ``process_count() == 1``, where its params are addressable. The
port runs one process a rank, so every rank gathers the parameters into an
unsharded clone (`TransformerLM.unsharded`, a collective) and rank 0
decodes alone. ``main()`` returns the fit's history and the report's
numbers (``exact_match`` None where no decode ran).
"""

import os

import numpy as np
import torch

import horovod_tpu_torch as hvt
from horovod_tpu_torch import metrics, runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data import datasets
from horovod_tpu_torch.models import pipelined_lm
from horovod_tpu_torch.models.decoding import generate
from horovod_tpu_torch.models.transformer import (
    ShardingConfig,
    TransformerLM,
    param_specs,
)
from horovod_tpu_torch.parallel import mesh as mesh_lib


def main():
    spec = mesh_lib.MeshSpec.from_string(os.environ.get("HVT_MESH"))
    hvt.init(device=registry.get_str("HVT_DEVICE"))
    metrics.init()
    device = runtime.device()
    mesh = mesh_lib.build_mesh(spec)
    seq_len = int(os.environ.get("SEQ_LEN", 512))
    vocab = int(os.environ.get("VOCAB", 64))
    attn = os.environ.get("ATTN", "ring")
    batch_spec = mesh_lib.P(
        (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS), mesh_lib.SEQ_AXIS
    )

    if mesh.shape[mesh_lib.PIPE_AXIS] > 1:
        # pipe > 1 switches to the pipelined model: stage stacks over
        # `pipe`, the GPipe (or SCHEDULE=1f1b) microbatch schedule,
        # Megatron TP inside each stage when `model` > 1 and the flash
        # ring inside each stage when `seq` > 1 (pp x sp, each rank
        # holding its column block of the batch: batch_spec).
        model = pipelined_lm.PipelinedLM(
            vocab_size=vocab,
            d_model=int(os.environ.get("DMODEL", 256)),
            n_heads=8,
            n_layers=int(os.environ.get("NLAYERS", 4)),
            n_micro=int(os.environ.get("N_MICRO", 4)),
            mesh=mesh,
            schedule=os.environ.get("SCHEDULE", "gpipe"),
            device=device,
        )
        trainer = hvt.Trainer(
            model,
            hvt.DistributedOptimizer(hvt.adam(3e-3)),
            loss="sparse_categorical_crossentropy",
            mesh=mesh,
            param_specs=pipelined_lm.param_specs,
            batch_specs=(batch_spec, batch_spec),
            device=device,
        )
    else:
        trainer = _transformer_trainer(mesh, vocab, attn, batch_spec,
                                       device)
    return _train_and_report(trainer, mesh, seq_len, vocab, device)


def _transformer_trainer(mesh, vocab, attn, batch_spec, device):
    model = TransformerLM(
        vocab_size=vocab,
        d_model=int(os.environ.get("DMODEL", 256)),
        n_heads=8,
        n_layers=int(os.environ.get("NLAYERS", 4)),
        dropout=0.0,
        sharding=ShardingConfig(mesh=mesh, attn=attn),
        moe_every=int(os.environ.get("MOE_EVERY", 0)),
        n_experts=int(os.environ.get("N_EXPERTS", 8)),
        # Memory knobs for long context (REMAT=1, LOGITS=bf16).
        remat=runtime.env_flag("REMAT"),
        logits_dtype=(torch.bfloat16 if os.environ.get("LOGITS", "") == "bf16"
                      else torch.float32),
        # FUSED_CE=<n_chunks>: the fused chunked-CE head, the logits never
        # materialized (ops/fused_ce.py).
        fused_head_chunks=int(os.environ.get("FUSED_CE", 0)),
        device=device,
    )
    return hvt.Trainer(
        model,
        hvt.DistributedOptimizer(hvt.adam(3e-3)),
        loss="module" if int(os.environ.get("FUSED_CE", 0))
        else "sparse_categorical_crossentropy",
        mesh=mesh,
        param_specs=param_specs,
        batch_specs=(batch_spec, batch_spec),
        device=device,
    )


def _train_and_report(trainer, mesh, seq_len, vocab, device):
    x, y = datasets.copy_task(4096, seq_len, vocab_size=vocab, seed=0)
    epochs = int(os.environ.get("DRIVE_EPOCHS", 0)) or 4
    steps = int(os.environ.get("DRIVE_STEPS", 0)) or 64

    # HVT_DEVICE_CACHE=1: the dataset staged on the device, one shuffled
    # order an epoch (where no model axis is live, as in JAX: the
    # seq-sharded layout needs the streamed path's batch_specs handling).
    device_cache = runtime.env_flag("HVT_DEVICE_CACHE") and not (
        mesh_lib.has_live_model_axes(mesh))
    if device_cache:
        fit_kwargs = {"cache": "device"}
        if int(os.environ.get("DRIVE_STEPS", 0)):  # honor an explicit budget
            fit_kwargs["steps_per_epoch"] = steps
    else:
        fit_kwargs = {"steps_per_epoch": steps}
    history = trainer.fit(
        x=x, y=y,
        batch_size=max(1, 16 // mesh_lib.dp_size(mesh)),
        epochs=epochs,
        callbacks=[
            hvt.callbacks.BroadcastGlobalVariablesCallback(0),
            hvt.callbacks.MetricAverageCallback(),
            hvt.callbacks.MetricsPushCallback(),
        ],
        verbose=1 if hvt.rank() == 0 else 0,
        **fit_kwargs,
    )

    # Recall-half report on held-out sequences.
    xt, yt = datasets.copy_task(64, seq_len, vocab_size=vocab, seed=99)
    probs = trainer.predict(xt, batch_size=8)
    ll = np.log(np.take_along_axis(probs, yt[..., None], axis=-1)[..., 0]
                + 1e-9)
    half = seq_len // 2
    recall_loss = float(-ll[:, half:].mean())
    context_loss = float(-ll[:, : half - 2].mean())
    metrics.push("recall_loss", recall_loss)
    if hvt.rank() == 0:
        print(f"first-half (irreducible) loss: {context_loss:.4f}")
        print(f"recall-half loss:              {recall_loss:.4f}")
        print("long-range recall:", "LEARNED"
              if recall_loss < 0.5 * context_loss
              else "not yet (train longer)")

    # Generation proof: greedy KV-cache decode from the first-half prompt
    # must reproduce the repeated half — the recall the loss measures,
    # through the prefill and the captured decode steps (models/decoding).
    exact = None
    if isinstance(trainer.module, TransformerLM) and half > 1:
        plain = trainer.module.unsharded()  # every rank: a collective
        if hvt.rank() == 0:
            prompt = torch.as_tensor(xt[:8, : half + 1], device=device)
            out = generate(plain, prompt, half - 1,
                           include_prompt=False).cpu().numpy()
            exact = float((out == xt[:8, half + 1:]).mean())
            metrics.push("decode_exact_match", exact)
            print(f"greedy-decode recall exact-match: {exact:.3f}")
    return {"history": history, "recall_loss": recall_loss,
            "context_loss": context_loss, "exact_match": exact}


if __name__ == "__main__":
    main()
