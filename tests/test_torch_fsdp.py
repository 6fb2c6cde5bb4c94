"""Weight-gathered FSDP in the port's model and Trainer — "FSDP is a memory
layout, not a different algorithm" — through the port's launcher at four
gloo ranks on the CPU, meshes ``(data=2, fsdp=2)`` and ``(data=1, fsdp=2,
model=2)`` in one launch, each rank on its rows (`parallel.sharding.
shard_batch`: rows ``[4i/dp, 4(i+1)/dp)`` of the 4-row global batch at its
batch shard i).

* logits, the loss and every gathered gradient of one step (each ``fsdp``
  shard's gradient reduce-scattered in the backward and summed over the
  shard gradient group, the rest over the gradient group, divided by dp
  once) against JAX's sharded apply on the same mesh and the port at one
  rank;
* six Adam steps of ``fit`` (``param_specs``, ``batch_specs`` as JAX's
  tests pass them) against the port's pure-data run at one rank on the
  same global batches: JAX's ``test_fsdp_matches_pure_dp_math`` (the
  parameters' summed magnitude within rel 1e-3) and every parameter
  within ``ADAM_RTOL`` (the norm of its difference against its norm);
  the ranks that hold one part end bit-equal;
* local parameter and Adam-moment shapes: each placed dim at its full
  size over the axis, the moments shaped like their parameter;
* the checkpoint across meshes: the ``(data=1, fsdp=2, model=2)`` run
  saves the full layout (one file, as one rank writes it, the Adam
  moments whole), which restores at one rank to the gathered parameters
  bit for bit; the
  one-rank run's checkpoint restores at ``(data=1, fsdp=2, model=2)`` to
  each rank's cut of it, moments included;
* the serving export of the TP + FSDP-trained model, called on the
  sharded model by every rank (it gathers inside; rank 0 writes), equal to
  the plain model's predict, as JAX's
  ``test_tp_fsdp_sharded_export_matches_plain``;
* ``BroadcastGlobalVariablesCallback`` on shards at ``(data=2, fsdp=2)``:
  every part comes from the rank of data coordinate 0 that holds the same
  part, never across ``fsdp``.

Tolerances: f32 on both sides. Against JAX's sharded apply rtol = atol =
5e-4 (JAX's ``test_matches_unsharded_forward``); against the port at one
rank 1e-5 relative to each tensor's largest element (other summation
orders). After six Adam steps (lr 3e-3) each parameter within 1e-4 of
its norm of the pure-data run's: Adam divides each step by the root of
its second moment, so a gradient entry near zero whose summation order
moves it by 1e-7 relative can move its parameter by up to a step's 3e-3;
on the CPU 1 and 2 elements of ~60 k moved by 1.5e-5 and 5.0e-5, the
norms 2.8e-6 and 1.2e-5 apart. Adam is blind to a gradient's scale, so
the one-step gradients above are what hold the reductions' arithmetic.
The export within 1e-6 absolute (the same f32 program on the same
weights).
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

import horovod_tpu_torch as ht
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (
    params_from_flax, params_to_flax, shard_state_dict,
)
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
JAX_TOL, RTOL, ADAM_RTOL, EXPORT_ATOL = 5e-4, 1e-5, 1e-4, 1e-6
ROWS, T, VOCAB, STEPS, LR = 4, 32, 64, 6, 3e-3
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2, dropout=0.0)
MESHES = ["data=2,fsdp=2", "data=1,fsdp=2,model=2"]
TP_FSDP = MESHES[1]

CHILD = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch import checkpoint
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import gather_state_dict
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
lr = float(os.environ["LR"])
data = np.load(os.path.join(out, "data.npz"))
spec = tmesh.P(("data", "fsdp"), "seq")
res = {}


def adam_trainer(model, mesh):
    return ht.Trainer(model, ht.DistributedOptimizer(ht.adam(lr)),
                      loss="sparse_categorical_crossentropy", mesh=mesh,
                      param_specs=ttr.param_specs, batch_specs=(spec, spec),
                      device="cpu")


for tag in json.loads(os.environ["MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    res[tag + ".coords"] = np.array([mesh.coords[a] for a in tmesh.AXES])
    x0, y0 = (torch.from_numpy(sharding.shard_batch(data[k][0], mesh))
              for k in ("x", "y"))
    # One step's logits, loss and gradients, reduced as the optimizer does.
    model = ttr.TransformerLM(**cfg, device="cpu", seed=1,
                              sharding=ttr.ShardingConfig(mesh=mesh))
    trainer = adam_trainer(model, mesh)
    trainer.build()
    with torch.no_grad():
        res[tag + ".logits"] = model(x0).numpy()
    loss, _ = model(x0, labels=y0, train=True, dropout_seed=0)
    res[tag + ".loss"] = loss.detach().numpy()
    loss.mean().backward()
    trainer.tx.reduce_gradients()
    grads = {pn: p.grad for pn, p in model.named_parameters()}
    for pn, g in gather_state_dict(grads, mesh, trainer.placements).items():
        res[f"{tag}.g.{pn}"] = g.numpy()

    # Six Adam steps.
    model = ttr.TransformerLM(**cfg, device="cpu", seed=2,
                              sharding=ttr.ShardingConfig(mesh=mesh))
    trainer = adam_trainer(model, mesh)
    batches = [sharding.shard_batch((xb, yb), mesh)
               for xb, yb in zip(data["x"], data["y"])]
    trainer.fit(dataset=batches, epochs=len(batches), steps_per_epoch=1,
                callbacks=[ht.callbacks.MetricAverageCallback()], verbose=0)
    res[tag + ".losses"] = np.array([e["loss"] for e in trainer.history])
    opt = trainer.tx.optimizer
    for pn, p in model.named_parameters():
        res[f"{tag}.local.{pn}"] = p.detach().numpy()
        res[f"{tag}.moment_shape.{pn}"] = np.array(
            opt.state[p]["exp_avg"].shape)
    # Every rank gathers; only rank 0 writes.
    trainer.state.snapshot_model()
    trainer.tx.snapshot()
    for pn, p in trainer.state.full_model_state().items():
        res[f"{tag}.full.{pn}"] = p.numpy()
    if tag == os.environ["TP_FSDP"]:
        if r == 0:
            checkpoint.save(os.path.join(out, "tp_fsdp.pt"), trainer.state)
        # The one-rank run's checkpoint, restored at this mesh.
        fresh = ttr.TransformerLM(**cfg, device="cpu", seed=7,
                                  sharding=ttr.ShardingConfig(mesh=mesh))
        restored = adam_trainer(fresh, mesh)
        restored.build()
        restored.fit(dataset=batches[:1], epochs=1, steps_per_epoch=1,
                     verbose=0)  # creates the Adam state
        checkpoint.restore(os.path.join(out, "one.pt"), restored.state)
        for pn, p in fresh.named_parameters():
            res["restored." + pn] = p.detach().numpy()
            st = restored.tx.optimizer.state[p]
            res["restored.exp_avg." + pn] = st["exp_avg"].numpy()
        # The export of the sharded model: every rank calls it (it
        # gathers the model whole inside), rank 0 writes.
        res["export_dir"] = checkpoint.export_serving(
            os.path.join(out, "export"), model, input_shape=(2, 8),
            input_dtype=np.int32, timestamp="19700101-000000")

# BroadcastGlobalVariablesCallback at data=2,fsdp=2: the ranks at data 1
# start from other weights; each part comes from its holder at data 0.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(MESHES[0]))
model = ttr.TransformerLM(**cfg, device="cpu",
                          seed=3 + mesh.coords["data"],
                          sharding=ttr.ShardingConfig(mesh=mesh))
trainer = adam_trainer(model, mesh)
trainer.build()
cb = ht.callbacks.BroadcastGlobalVariablesCallback(0)
cb.set_trainer(trainer)
cb.on_train_begin()
for pn, p in model.named_parameters():
    res["bcast." + pn] = p.detach().numpy()
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''.replace("MESHES[0]", repr(MESHES[0]))


def _data(tmp):
    rng = np.random.RandomState(0)
    x = rng.randint(1, VOCAB, (STEPS, ROWS, T)).astype(np.int32)
    y = np.roll(x, -1, axis=2).astype(np.int32)
    np.savez(tmp / "data.npz", x=x, y=y)
    return dict(x=x, y=y)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG), MESHES=json.dumps(MESHES),
               TP_FSDP=TP_FSDP, LR=str(LR))
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


def _adam_trainer(tm):
    return ht.Trainer(tm, ht.DistributedOptimizer(ht.adam(LR)),
                      loss="sparse_categorical_crossentropy", device="cpu")


def _one_rank(d, tmp):
    """The port at one rank on the global batches: one step's logits, loss
    and gradients from the seed-1 weights, and the six-step Adam fit from
    the seed-2 weights, whose checkpoint the launch restores."""
    x, y = torch.from_numpy(d["x"][0]), torch.from_numpy(d["y"][0])
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=1)
    with torch.no_grad():
        logits = tm(x).numpy()
    loss, _ = tm(x, labels=y, train=True, dropout_seed=0)
    loss.mean().backward()
    one = dict(logits=logits, loss=loss.detach().numpy(),
               grads={n: p.grad.numpy() for n, p in tm.named_parameters()})
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=2)
    trainer = _adam_trainer(tm)
    trainer.fit(dataset=list(zip(d["x"], d["y"])), epochs=STEPS,
                steps_per_epoch=1, verbose=0)
    checkpoint.save(str(tmp / "one.pt"), trainer.state)
    one["fit"] = dict(
        losses=[e["loss"] for e in trainer.history],
        params={n: p.detach().numpy() for n, p in tm.named_parameters()},
        exp_avg={n: trainer.tx.optimizer.state[p]["exp_avg"].numpy()
                 for n, p in tm.named_parameters()})
    return one


def _jax_sharded(d, spec):
    nd = tmesh.MeshSpec.from_string(spec).resolve(NPROCS)
    mesh = jmesh.build_mesh(jmesh.MeshSpec(**nd), jax.devices()[:NPROCS])
    x, y = jnp.asarray(d["x"][0]), jnp.asarray(d["y"][0])
    jm = jtr.TransformerLM(**CFG, sharding=jtr.ShardingConfig(mesh=mesh))
    params = params_to_flax(
        ttr.TransformerLM(**CFG, device="cpu", seed=1).state_dict(),
        n_heads=CFG["n_heads"])

    def loss_fn(p):
        loss, _ = jm.apply({"params": p}, x, labels=y)
        return loss.mean(), loss

    logits = jax.jit(lambda p: jm.apply({"params": p}, x))(params)
    (_, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return dict(logits=np.asarray(logits), loss=np.asarray(loss),
                grads=params_from_flax(jax.device_get(grads)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    d = _data(tmp)
    one = _one_rank(d, tmp)  # its checkpoint must exist before the launch
    proc = _start(tmp)
    try:
        jax_refs = {m: _jax_sharded(d, m) for m in MESHES}
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return dict(data=d, jax=jax_refs, one=one, tmp=tmp,
                ranks=_finish(proc, tmp))


def _rel_close(got, want, what, tol=RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max()) / scale
    assert err <= tol, (what, err)


def _rows(a, coords, shape):
    dp = shape["data"] * shape["fsdp"]
    b = a.shape[0] // dp
    i = int(coords[0]) * shape["fsdp"] + int(coords[1])
    return a[i * b:(i + 1) * b]


def _specs(spec, rank):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec),
                            n_ranks=NPROCS, rank=rank)
    tm = ttr.TransformerLM(**CFG, device="cpu")
    return mesh, ttr.live_placements(ttr.param_specs(tm, mesh), mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_step_matches_jax_sharded_and_one_rank(run, mesh):
    jref, one = run["jax"][mesh], run["one"]
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    for res in run["ranks"]:
        coords = res[mesh + ".coords"]
        for what in ("logits", "loss"):
            got = res[f"{mesh}.{what}"]
            np.testing.assert_allclose(got, _rows(jref[what], coords, shape),
                                       rtol=JAX_TOL, atol=JAX_TOL)
            _rel_close(got, _rows(one[what], coords, shape), what)
        for pn, g in one["grads"].items():
            got = res[f"{mesh}.g.{pn}"]
            _rel_close(got, jref["grads"][pn].numpy(), pn + " vs jax",
                       JAX_TOL)
            _rel_close(got, g, pn + " vs one rank")


@pytest.mark.parametrize("mesh", MESHES)
def test_fsdp_fit_matches_pure_dp_math(run, mesh):
    want = run["one"]["fit"]
    total = sum(float(np.abs(p).sum()) for p in want["params"].values())
    for res in run["ranks"]:
        _rel_close(res[mesh + ".losses"], want["losses"], "losses")
        got = sum(float(np.abs(res[f"{mesh}.full.{pn}"]).sum())
                  for pn in want["params"])
        assert got == pytest.approx(total, rel=1e-3)
        for pn, p in want["params"].items():
            diff = np.linalg.norm(res[f"{mesh}.full.{pn}"] - p)
            assert diff <= ADAM_RTOL * np.linalg.norm(p), (pn, diff)
    # The ranks that hold one part (same fsdp and model coordinates) end
    # bit-equal.
    ranks = run["ranks"]
    for a in range(NPROCS):
        for b in range(a + 1, NPROCS):
            ca, cb = ranks[a][mesh + ".coords"], ranks[b][mesh + ".coords"]
            if ca[1] == cb[1] and ca[4] == cb[4]:
                for pn in want["params"]:
                    assert np.array_equal(ranks[a][f"{mesh}.local.{pn}"],
                                          ranks[b][f"{mesh}.local.{pn}"]), pn


@pytest.mark.parametrize("mesh", MESHES)
def test_local_parameter_and_moment_shapes(run, mesh):
    full = {n: p.shape for n, p in run["one"]["fit"]["params"].items()}
    shape = tmesh.MeshSpec.from_string(mesh).resolve(NPROCS)
    _, specs = _specs(mesh, 0)
    on_fsdp = 0
    for res in run["ranks"]:
        for pn, f in full.items():
            want = list(f)
            for dim, ax in specs.get(pn, {}).items():
                want[dim] //= shape[ax]
                on_fsdp += ax == "fsdp"
            assert list(res[f"{mesh}.local.{pn}"].shape) == want, pn
            assert list(res[f"{mesh}.moment_shape.{pn}"]) == want, pn
    # Every >=2-D weight (2 layers × 4 + embedding + head) has an fsdp part.
    assert on_fsdp == NPROCS * (4 * 2 + 2)


def test_checkpoint_round_trip_across_meshes(run):
    # Saved at data=1,fsdp=2,model=2: the full layout, restored at one rank.
    tm = ttr.TransformerLM(**CFG, device="cpu", seed=9)
    trainer = _adam_trainer(tm)
    trainer.build()
    payload = torch.load(run["tmp"] / "tp_fsdp.pt", weights_only=True)
    assert set(payload["model"]) == set(tm.state_dict())
    checkpoint.restore(str(run["tmp"] / "tp_fsdp.pt"), trainer.state)
    for i, p in enumerate(tm.parameters()):
        st = payload["optimizer"]["state"][i]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
    res0 = run["ranks"][0]
    for pn, p in tm.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              res0[f"{TP_FSDP}.full.{pn}"]), pn
    # The one-rank checkpoint restored at data=1,fsdp=2,model=2: each
    # rank's cut, the Adam moments too.
    want = run["one"]["fit"]
    for r, res in enumerate(run["ranks"]):
        mesh, specs = _specs(TP_FSDP, r)
        params = shard_state_dict({n: torch.from_numpy(p) for n, p in
                                   want["params"].items()}, mesh, specs)
        moments = shard_state_dict({n: torch.from_numpy(p) for n, p in
                                    want["exp_avg"].items()}, mesh, specs)
        for pn in want["params"]:
            assert np.array_equal(res["restored." + pn],
                                  params[pn].numpy()), pn
            assert np.array_equal(res["restored.exp_avg." + pn],
                                  moments[pn].numpy()), pn


def test_tp_fsdp_export_matches_plain(run):
    res0 = run["ranks"][0]
    for res in run["ranks"]:
        assert str(res["export_dir"]).endswith("19700101-000000")
    assert os.listdir(run["tmp"] / "export") == ["19700101-000000"]
    plain = ttr.TransformerLM(**CFG, device="cpu")
    plain.load_state_dict({pn: torch.from_numpy(res0[f"{TP_FSDP}.full.{pn}"])
                           for pn in plain.state_dict()})
    fn = checkpoint.load_serving(
        str(run["tmp"] / "export" / "19700101-000000"), device="cpu")
    x = np.arange(16, dtype=np.int32).reshape(2, 8) % VOCAB
    with torch.no_grad():
        want = torch.softmax(plain(torch.from_numpy(x)).float(), -1).numpy()
    np.testing.assert_allclose(fn(x), want, atol=EXPORT_ATOL, rtol=0)


def test_broadcast_callback_on_shards(run):
    ranks = run["ranks"]
    want = ttr.TransformerLM(**CFG, device="cpu", seed=3).state_dict()
    for r, res in enumerate(ranks):
        mesh, specs = _specs(MESHES[0], r)
        mine = shard_state_dict(want, mesh, specs)
        for pn, t in mine.items():
            assert np.array_equal(res["bcast." + pn], t.numpy()), (r, pn)


@pytest.mark.parametrize("ndim,lead", [(1, 0), (3, 0), (3, 1), (4, 2)])
def test_batch_layouts_match_jax(ndim, lead):
    """`parallel.sharding`'s batch layouts are JAX's, and `shard_batch`
    keeps this rank's block of the dim they place on the data axes."""
    from jax.sharding import PartitionSpec

    from horovod_tpu.parallel import sharding as jshard
    from horovod_tpu_torch.parallel import sharding

    jm = jmesh.build_mesh(jmesh.MeshSpec(data=2, fsdp=2, model=2),
                          jax.devices("cpu"))
    want = (jshard.chunk_sharding(jm, ndim, lead) if lead
            else jshard.batch_sharding(jm, ndim)).spec
    got = (sharding.chunk_sharding(ndim, lead) if lead
           else sharding.batch_sharding(ndim))
    assert PartitionSpec(*got) == want
    a = np.arange(8 * 4 ** (ndim - 1)).reshape((8,) + (4,) * (ndim - 1))
    a = np.moveaxis(a, 0, lead)
    for rank in range(8):
        mesh = tmesh.build_mesh(tmesh.MeshSpec(data=2, fsdp=2, model=2),
                                n_ranks=8, rank=rank)
        i = mesh.data_index
        np.testing.assert_array_equal(
            sharding.shard_batch(a, mesh, lead),
            np.take(a, range(2 * i, 2 * i + 2), axis=lead))
