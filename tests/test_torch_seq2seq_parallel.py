"""The encoder-decoder family on a live ``seq`` axis: ``tests/
test_seq2seq.py``'s ``TestSequenceParallel`` at ``data=1, seq=2`` and
``data=2, seq=2`` (two and four gloo ranks through the port's launcher, one
launch each; JAX's own test uses ``data=2, seq=4``), against JAX's
``shard_map`` model on the same mesh of the CPU devices:

* logits and every gradient of ``mean(logits²)`` from the same weights,
  with a pad tail of 4 on row 0 of the source, so that a padded memory
  block rotates around the cross-attention ring: the encoder's segmented
  non-causal ring and the decoder's causal ring are `ring_flash_attention`,
  the cross-attention `ring_cross_attention`, with global RoPE positions;
* the training loss falls on the ``dp × sp`` mesh (a dict-batch fit with
  ``batch_specs``), every rank's parameters bit-equal at the end;
* ``attn="dense"`` and decode mode refused with JAX's errors.

Tolerances: JAX's own for this case, 3e-5 absolute on the logits and 5e-5
on the gradients (f32 on both sides, ring merges in other orders).
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.models import seq2seq as jseq
from horovod_tpu.models.transformer import ShardingConfig as JShard
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models.convert import (
    seq2seq_params_from_flax, seq2seq_params_to_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
VALUE_ATOL, GRAD_ATOL = 3e-5, 5e-5
VOCAB, PAD, BOS = 32, 0, 1
ROWS, S, T = 4, 16, 16
CFG = dict(vocab_size=VOCAB, d_model=64, n_heads=4, n_enc_layers=2,
           n_dec_layers=2, dropout=0.0)

CHILD = r'''
import hashlib, json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(os.environ["MESH"]))
data = np.load(os.path.join(out, "data.npz"))
dp, di, n, ci = (mesh.data_shards, mesh.data_index, mesh.seq_shards,
                 mesh.seq_index)
b = data["src"].shape[0] // dp
rows = slice(di * b, (di + 1) * b)


def local(a):
    t = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(a[rows, ci * t:(ci + 1) * t]))


res = {"coords": np.array([di, ci])}
model = tseq.Seq2SeqTransformer(**cfg, device="cpu", seed=1,
                                sharding=ttr.ShardingConfig(mesh=mesh))
batch = {"src": local(data["src"]), "tgt": local(data["tgt"])}
logits = model(batch)
res["logits"] = logits.detach().numpy()
((logits ** 2).sum() / (data["tgt"].size * cfg["vocab_size"])).backward()
for pn, p in model.named_parameters():
    res["g." + pn] = c.all_reduce_sum(p.grad, mesh.grad_group).numpy()

# A dict-batch fit on the dp x sp mesh (the copy task).
part = tmesh.P(("data", "fsdp"), "seq")
fm = tseq.Seq2SeqTransformer(**cfg, device="cpu", seed=2,
                             sharding=ttr.ShardingConfig(mesh=mesh))
trainer = ht.Trainer(fm, ht.DistributedOptimizer(ht.adam(3e-3)),
                     loss="sparse_categorical_crossentropy", mesh=mesh,
                     batch_specs=(part, part), device="cpu")
hist = trainer.fit(x={"src": data["fsrc"], "tgt": data["ftgt"]},
                   y=data["fy"], batch_size=8, epochs=2, verbose=0,
                   callbacks=[callbacks.MetricAverageCallback()])
res["fit.losses"] = np.array([e["loss"] for e in hist])
digest = hashlib.sha256()
for p in fm.parameters():
    digest.update(p.detach().numpy().tobytes())
res["fit.digest"] = np.frombuffer(digest.digest(), np.uint8)


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


dense = tseq.Seq2SeqTransformer(**cfg, device="cpu", sharding=(
    ttr.ShardingConfig(mesh=mesh, attn="dense")))
res["refuse.dense"] = refusal(lambda: dense(batch))
mem, valid = model.encode(batch["src"])
res["refuse.decode"] = refusal(lambda: model.decode_tokens(
    batch["tgt"][:, :1], mem, valid, max_decode_len=8))
np.savez(os.path.join(out, f"rank{ht.rank()}.npz"), **res)
'''


def _data(tmp):
    rng = np.random.RandomState(8)
    src = rng.randint(3, VOCAB, (ROWS, S)).astype(np.int32)
    src[0, -4:] = PAD
    tgt = rng.randint(3, VOCAB, (ROWS, T)).astype(np.int32)
    fsrc = rng.randint(3, VOCAB, (128, S)).astype(np.int32)
    fy = fsrc.copy()
    ftgt = np.concatenate([np.full((128, 1), BOS, np.int32), fy[:, :-1]], 1)
    d = dict(src=src, tgt=tgt, fsrc=fsrc, ftgt=ftgt, fy=fy)
    np.savez(tmp / "data.npz", **d)
    return d


def _start(tmp, nprocs, mesh):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), MESH=mesh, CFG=json.dumps(CFG))
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, tmp, nprocs):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nprocs)]


def _jax_refs(d, data, seq):
    """JAX's model on a ``data × seq`` mesh of the CPU devices (shard_map
    rings), from the port's seed-1 weights: logits, gradients, and its
    refusals."""
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=1)
    params = seq2seq_params_to_flax(tm.state_dict(), tm)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=data, seq=seq),
                            devices=jax.devices()[:data * seq])
    jm = jseq.Seq2SeqTransformer(sharding=JShard(mesh=mesh), **CFG)
    batch = {"src": jnp.asarray(d["src"]), "tgt": jnp.asarray(d["tgt"])}
    logits = jax.jit(lambda p, b: jm.apply({"params": p}, b))(params, batch)
    grads = jax.jit(jax.grad(lambda p: (jm.apply(
        {"params": p}, batch).astype(jnp.float32) ** 2).mean()))(params)
    refusals = {}
    for key, fn in (
            ("dense", lambda: jseq.Seq2SeqTransformer(
                sharding=JShard(mesh=mesh, attn="dense"), **CFG).init(
                jax.random.PRNGKey(0), batch)),
            ("decode", lambda: jm.clone(decode=True, max_decode_len=8).init(
                jax.random.PRNGKey(0),
                {"src": batch["src"], "tgt": batch["tgt"][:, :1]}))):
        with pytest.raises(ValueError) as e:
            fn()
        refusals[key] = str(e.value)
    return (np.asarray(logits), seq2seq_params_from_flax(
        jax.device_get(grads), tm), refusals)


def test_seq2seq_on_seq_meshes_matches_jax(tmp_path):
    d = _data(tmp_path)
    runs = {}
    for nprocs, data in ((2, 1), (4, 2)):
        sub = tmp_path / f"w{nprocs}"
        sub.mkdir()
        np.savez(sub / "data.npz", **d)
        runs[nprocs] = (sub, data,
                        _start(sub, nprocs, f"data={data},seq=2"))
    for nprocs, (sub, data, proc) in runs.items():
        logits, grads, refusals = _jax_refs(d, data, 2)
        ranks = _finish(proc, sub, nprocs)
        b, t = ROWS // data, T // 2
        for rec in ranks:
            di, ci = (int(v) for v in rec["coords"])
            want = logits[di * b:(di + 1) * b, ci * t:(ci + 1) * t]
            np.testing.assert_allclose(rec["logits"], want, atol=VALUE_ATOL,
                                       rtol=0)
            for name, g in grads.items():
                np.testing.assert_allclose(rec["g." + name], g.numpy(),
                                           atol=GRAD_ATOL, rtol=0,
                                           err_msg=name)
            assert str(rec["refuse.dense"]) == refusals["dense"]
            assert str(rec["refuse.decode"]) == refusals["decode"]
            losses = rec["fit.losses"]
            assert losses[-1] < losses[0], losses
        assert len({r["fit.digest"].tobytes() for r in ranks}) == 1
