"""The seq2seq model on a live ``model`` or ``fsdp`` axis
(`horovod_tpu_torch.models.seq2seq`), through the port's launcher at four
gloo ranks on the CPU, meshes ``(data=2, model=2)`` and ``(data=2,
fsdp=2)`` in one launch, every rank on its rows of the batch:

* the logits of tests/test_seq2seq.py::TestTP's model and padded batch
  against JAX's model sharded over ``data=2, model=4`` on the conftest's
  eight virtual devices at TestTP's atol 3e-5, and against the one-rank
  port;
* the gradients of a cross-entropy on the gathered logits (gathered,
  summed over the shard groups and divided by dp, as the optimizer does)
  against JAX's gradients and the one-rank port's;
* three SGD ``fit`` steps on dict batches against the one-rank fit (whose
  steps tests/test_torch_seq2seq.py holds against JAX's Trainer): losses
  and every parameter; the steps ran eagerly (gloo);
* cached generation on the cut model (``[B, L, H/tp, D]`` self caches and
  the static cross K/V at the local heads) against JAX's
  `make_seq2seq_generate_fn` from the same weights, and
  ``clone(sharding=ShardingConfig())`` (the gathered weights) against the
  one-rank model;
* in process: every rank's part of every parameter at ``data=2, model=4``
  — the fused ``qkv`` and ``cross_kv`` rows cut per part by heads — equals
  the conversion of JAX's device shard under its ``param_specs``; a
  contiguous cut of ``cross_kv`` would pair the wrong heads.

Tolerances: against JAX's sharded model atol 3e-5 (TestTP); gradients
against JAX 5e-4 relative to each tensor's largest element (as
tests/test_torch_tensor_parallel.py); against the one-rank port 1e-5
relative; parameters after three SGD steps 1e-5 abs; tokens and shards
exactly.
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
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as JP

import horovod_tpu_torch as ht
from horovod_tpu.models import seq2seq as jseq
from horovod_tpu.models.transformer import ShardingConfig as JShardingConfig
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models.convert import (
    seq2seq_params_from_flax, seq2seq_params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
TP_ATOL, JAX_TOL, RTOL, PARAM_ATOL = 3e-5, 5e-4, 1e-5, 1e-5
PAD, BOS = 0, 1
# tests/test_seq2seq.py's model.
CFG = dict(vocab_size=32, d_model=64, n_heads=4, n_enc_layers=2,
           n_dec_layers=2, dropout=0.0)
MESHES = ["data=2,model=2", "data=2,fsdp=2"]
ROWS, S, T, STEPS, LR, NEW = 4, 12, 10, 3, 0.5, 6

CHILD = r'''
import functools, json, os
import numpy as np
import torch
import torch.nn.functional as F
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import seq2seq as tseq
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.models.transformer import (
    ShardingConfig, live_placements,
)
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
data = np.load(os.path.join(out, "data.npz"))
res = {}


def full_grads(module, mesh, specs, scale):
    grads = {}
    for n, p in module.named_parameters():
        group = (mesh.shard_grad_group if "fsdp" in specs.get(n, {}).values()
                 else mesh.grad_group)
        g = p.grad if group is c.SELF else c.all_reduce_sum(p.grad, group)
        grads[n] = g * scale
    return gather_state_dict(grads, mesh, specs)


for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    dp, di = mesh.data_shards, mesh.data_index
    b = data["src"].shape[0] // dp
    mine = slice(di * b, (di + 1) * b)
    res[tag + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
    model = tseq.Seq2SeqTransformer(**cfg, device="cpu", seed=1,
                                    sharding=ShardingConfig(mesh=mesh))
    specs = live_placements(tseq.param_specs(model, mesh), mesh)
    batch = {"src": torch.from_numpy(data["src"][mine]),
             "tgt": torch.from_numpy(data["tgt"][mine])}
    logits = model(batch)
    res[tag + ".logits"] = logits.detach().numpy()
    y = torch.from_numpy(data["y"][mine]).long()
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    y.reshape(-1)).backward()
    for n, g in full_grads(model, mesh, specs, 1.0 / dp).items():
        res[f"{tag}.g.{n}"] = g.numpy()

    gen = tseq.make_seq2seq_generate_fn(model, max_new_tokens=int(
        os.environ["NEW"]), bos_id=1)
    res[tag + ".tokens"] = gen(torch.from_numpy(data["src"])).numpy()
    res[tag + ".gen_eager"] = gen.steps.eager_steps
    memory, valid = model.encode(batch["src"])
    with torch.no_grad():
        _, cache = model.decode_tokens(batch["tgt"][:, :1], memory, valid,
                                       max_decode_len=8)
    res[tag + ".self_cache"] = np.array(cache["Block_0"]["k"].shape)
    res[tag + ".cross_cache"] = np.array(cache["Block_0"]["cross_k"].shape)
    plain = model.clone(sharding=ShardingConfig())
    with torch.no_grad():
        res[tag + ".plain_logits"] = plain(
            {"src": torch.from_numpy(data["src"]),
             "tgt": torch.from_numpy(data["tgt"])}).numpy()

    model = tseq.Seq2SeqTransformer(**cfg, device="cpu", seed=2,
                                    sharding=ShardingConfig(mesh=mesh))
    trainer = ht.Trainer(model, ht.DistributedOptimizer(functools.partial(
        torch.optim.SGD, lr=float(os.environ["LR"]))),
        loss="sparse_categorical_crossentropy", mesh=mesh,
        param_specs=tseq.param_specs, device="cpu")
    batches = [({"src": s[mine], "tgt": t[mine]}, yy[mine]) for s, t, yy in
               zip(data["fit_src"], data["fit_tgt"], data["fit_y"])]
    trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
                callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
    res[tag + ".fit_losses"] = np.array([e["loss"] for e in trainer.history])
    res[tag + ".fit_eager"] = trainer._runner.eager_steps
    for n, t in trainer.state.full_model_state().items():
        res[f"{tag}.fit.{n}"] = t.numpy()

np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _batch(rng, b, s, t, pad_tail):
    """tests/test_seq2seq.py's `_batch`, as numpy."""
    src = rng.randint(3, CFG["vocab_size"], size=(b, s)).astype(np.int32)
    if pad_tail:
        src[:, -pad_tail:] = PAD
    tgt = rng.randint(3, CFG["vocab_size"], size=(b, t)).astype(np.int32)
    return src, tgt


def _data(tmp):
    src, tgt = _batch(np.random.RandomState(4), ROWS, S, T, 3)
    src[1::2, -5:] = PAD  # rows of two padded lengths
    y = np.roll(tgt, -1, axis=1)
    rng = np.random.RandomState(11)
    fit = [_batch(rng, ROWS, S, T, 4) for _ in range(STEPS)]
    fit_src = np.stack([a for a, _ in fit])
    fit_tgt = np.stack([np.concatenate(
        [np.full((ROWS, 1), BOS, np.int32), a[:, :T - 1]], 1) for a, _ in fit])
    fit_y = np.stack([a[:, :T] for a, _ in fit])
    d = dict(src=src, tgt=tgt, y=y, fit_src=fit_src, fit_tgt=fit_tgt,
             fit_y=fit_y)
    np.savez(tmp / "data.npz", **d)
    return d


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), MESHES=json.dumps(MESHES),
               LR=str(LR), NEW=str(NEW))
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(proc, tmp):
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NPROCS)]


def _references(d):
    """The one-rank port and JAX from the port's seed-1 weights: logits,
    the cross-entropy's gradients, JAX's logits on ``data=2, model=4``, the
    greedy tokens; and the one-rank fit from seed 2."""
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=1)
    batch = {"src": torch.from_numpy(d["src"]),
             "tgt": torch.from_numpy(d["tgt"])}
    logits = tm(batch)
    F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                    torch.from_numpy(d["y"]).long().reshape(-1)).backward()
    refs = dict(logits=logits.detach().numpy(),
                grads={n: p.grad.numpy() for n, p in tm.named_parameters()})
    jm = jseq.Seq2SeqTransformer(**CFG)
    params = seq2seq_params_to_flax(tm.state_dict(), tm)
    jbatch = {k: jnp.asarray(v) for k, v in (("src", d["src"]),
                                             ("tgt", d["tgt"]))}

    def loss_fn(p):
        lg = jm.apply({"params": p}, jbatch)
        logp = jax.nn.log_softmax(lg, -1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(d["y"])[..., None], -1).mean()

    refs["jax_grads"] = seq2seq_params_from_flax(
        jax.device_get(jax.grad(loss_fn)(params)), tm)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=2, model=4),
                            jax.devices("cpu"))
    smodel = jseq.Seq2SeqTransformer(
        **CFG, sharding=JShardingConfig(mesh=mesh))
    specs = jseq.param_specs(params, mesh)
    sharded = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        specs, is_leaf=lambda s: isinstance(s, JP))
    refs["jax_tp"] = np.asarray(jax.jit(
        lambda p, b: smodel.apply({"params": p}, b))(sharded, jbatch))
    gen = jseq.make_seq2seq_generate_fn(jm, max_new_tokens=NEW, bos_id=BOS)
    refs["jax_tokens"] = np.asarray(gen(params, jbatch["src"],
                                        jax.random.PRNGKey(0)))
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=2)
    trainer = ht.Trainer(tm, ht.DistributedOptimizer(
        lambda p: torch.optim.SGD(p, lr=LR)),
        loss="sparse_categorical_crossentropy", device="cpu")
    trainer.fit(dataset=[({"src": s, "tgt": t}, y) for s, t, y in zip(
        d["fit_src"], d["fit_tgt"], d["fit_y"])], epochs=STEPS,
        steps_per_epoch=1, verbose=0)
    refs["fit_losses"] = [e["loss"] for e in trainer.history]
    refs["fit_params"] = {n: p.detach().numpy()
                          for n, p in tm.named_parameters()}
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq2seq_tp")
    d = _data(tmp)
    proc = _start(tmp)  # the ranks run while the references compute
    try:
        refs = _references(d)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return dict(data=d, refs=refs, ranks=_finish(proc, tmp))


def _rel_close(got, want, what, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


def _rows(res, mesh):
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    c = res[mesh + ".coords"]
    dp = shape["data"] * shape["fsdp"]
    di = int(c[0]) * shape["fsdp"] + int(c[1])
    b = ROWS // dp
    return slice(di * b, (di + 1) * b)


@pytest.mark.parametrize("mesh", MESHES)
def test_logits_match_jax_tp_and_one_rank(run, mesh):
    refs = run["refs"]
    for res in run["ranks"]:
        rows = _rows(res, mesh)
        got = res[mesh + ".logits"]
        np.testing.assert_allclose(got, refs["jax_tp"][rows], rtol=0,
                                   atol=TP_ATOL)
        _rel_close(got, refs["logits"][rows], "logits vs one rank")


@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_match_jax_and_one_rank(run, mesh):
    refs = run["refs"]
    for res in run["ranks"]:
        for n, g in refs["grads"].items():
            got = res[f"{mesh}.g.{n}"]
            _rel_close(got, refs["jax_grads"][n].numpy(), n + " vs jax",
                       JAX_TOL)
            _rel_close(got, g, n)


@pytest.mark.parametrize("mesh", MESHES)
def test_fit_equals_one_rank_fit(run, mesh):
    refs = run["refs"]
    for res in run["ranks"]:
        _rel_close(res[mesh + ".fit_losses"], refs["fit_losses"], "losses")
        assert int(res[mesh + ".fit_eager"]) == STEPS  # gloo: eager steps
        for n, p in refs["fit_params"].items():
            np.testing.assert_allclose(res[f"{mesh}.fit.{n}"], p,
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("mesh", MESHES)
def test_cached_generation_matches_jax(run, mesh):
    refs = run["refs"]
    heads = CFG["n_heads"] // (2 if "model" in mesh else 1)
    hd = CFG["d_model"] // CFG["n_heads"]
    for res in run["ranks"]:
        np.testing.assert_array_equal(res[mesh + ".tokens"],
                                      refs["jax_tokens"])
        assert int(res[mesh + ".gen_eager"]) == NEW - 1  # gloo: eager
        rows = _rows(res, mesh)
        b = rows.stop - rows.start
        assert tuple(res[mesh + ".self_cache"]) == (b, 8, heads, hd)
        assert tuple(res[mesh + ".cross_cache"]) == (b, S, heads, hd)
        np.testing.assert_array_equal(res[mesh + ".plain_logits"],
                                      refs["logits"])


def test_shards_equal_jax_device_shards_at_model_4():
    """TestTP's mesh in process: each rank's part of every parameter is
    the conversion of JAX's shard on the device at its coordinates; the
    cross K/V rows are cut per part by heads, not contiguously."""
    spec = "data=2,model=4"
    tm = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=3)
    params = seq2seq_params_to_flax(tm.state_dict(), tm)
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    placed = jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(jm, s), jseq.param_specs(params, jm),
        is_leaf=lambda s: isinstance(s, JP)))
    devices = list(jm.devices.reshape(-1))
    full = tm.state_dict()
    name = "decoder.blocks.0.cross_kv.weight"
    for r in range(8):
        mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                                rank=r)
        specs = {n: {d: ax for d, ax in p.items() if ax == "model"}
                 for n, p in tseq.param_specs(full, mesh).items()}
        mine = shard_state_dict(full, mesh, specs)
        # The layout conversion reads each kernel's parts, not its heads:
        # a shard converts through the whole model's kernel table.
        theirs = seq2seq_params_from_flax(jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == devices[r])), placed),
            tm)
        for n, t in mine.items():
            assert torch.equal(t, theirs[n]), (r, n)
        m = mesh.coords["model"]
        contiguous = full[name].narrow(0, 32 * m, 32)
        assert not torch.equal(mine[name], contiguous)


def test_the_model_holds_its_cut_of_the_one_rank_weights():
    one = tseq.Seq2SeqTransformer(**CFG, device="cpu", seed=5)
    for spec in ("data=2,model=4", "data=2,fsdp=2,model=2"):
        for r in range(8):
            mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec),
                                    n_ranks=8, rank=r)
            tm = tseq.Seq2SeqTransformer(
                **CFG, device="cpu", seed=5,
                sharding=tseq.ShardingConfig(mesh=mesh))
            want = shard_state_dict(one.state_dict(), mesh, tm.cuts)
            assert tm.cuts
            for n, t in tm.state_dict().items():
                assert torch.equal(t, want[n]), (spec, r, n)
