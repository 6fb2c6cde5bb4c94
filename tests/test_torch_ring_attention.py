"""Sequence-parallel attention in the port (`horovod_tpu_torch.ops.attention`:
the dense ring, the flash ring, Ulysses and the cross ring over a process
group) against the JAX package's functions under ``shard_map`` — the cases
of ``tests/test_attention.py`` at n = 2 and n = 4.

The port side runs at n gloo ranks through its launcher, one launch per
world size, every rank computing every case on its sequence shard: the
output and the gradients of q, k and v of ``(out ** 2).sum()``. The JAX
side runs the same global inputs through ``shard_map`` over n of the 8 CPU
devices, its flash kernel through its plain reference (``_dense_with_lse``,
to which JAX's own kernel tests hold the interpret-mode kernel). Cases: causal and non-causal;
packed segments (ids rotating with their blocks, gathered for Ulysses);
windows whose past hops are partly in band, wholly out of band and
skipped; sinks alone and with segments; the cross ring at unequal lengths,
with a padded source and an all-pad source row (zero output). JAX's
refusals run in the launch (heads not divisible by n) and in-process (the
others), and n = 1 in-process is exactly the local path.

Tolerance: f32 on both sides, the same sums in other orders: outputs and
gradients within 1e-5 relative to each tensor's largest element (1e-5
absolute for a tensor whose elements are all below 1).
"""

import functools
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
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.ops import attention as jatt
from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import attention as tatt
from horovod_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
RTOL = 1e-5
B, T, H, D = 2, 32, 4, 8
TQ_CROSS, TK_CROSS = 32, 48

# name: (function, kwargs, inputs) — inputs "self" (q/k/v [B, T, H, D]),
# "seg" (with packed ids), "cross" (q [B, 32], k/v [B, 48]), "cross_pad"
# (q [B, 16], k/v [B, 32], source padded from 20), "cross_allpad" (row 1's
# whole source is padding).
CASES = {
    "ring_dense_causal": ("ring_attention", dict(causal=True), "self"),
    "ring_dense_noncausal": ("ring_attention", dict(causal=False), "self"),
    "ring_dense_window13": ("ring_attention", dict(causal=True, window=13),
                            "self"),
    "flash_causal": ("ring_flash_attention", dict(causal=True), "self"),
    "flash_noncausal": ("ring_flash_attention", dict(causal=False), "self"),
    "flash_seg_causal": ("ring_flash_attention", dict(causal=True), "seg"),
    "flash_seg_noncausal": ("ring_flash_attention", dict(causal=False),
                            "seg"),
    # Windows: at n = 4 (T/n = 8) window 5 has distance 1 in band and 2+
    # skipped, 13 distances 1-2 in band, 20 every past hop in band; window
    # 1 is the diagonal alone (every past hop skipped, n = 2 too).
    "flash_window1": ("ring_flash_attention", dict(causal=True, window=1),
                      "self"),
    "flash_window5": ("ring_flash_attention", dict(causal=True, window=5),
                      "self"),
    "flash_window13": ("ring_flash_attention", dict(causal=True, window=13),
                       "self"),
    "flash_window20": ("ring_flash_attention", dict(causal=True, window=20),
                       "self"),
    "flash_seg_window13": ("ring_flash_attention",
                           dict(causal=True, window=13), "seg"),
    "flash_sinks_5_2": ("ring_flash_attention",
                        dict(causal=True, window=5, sinks=2), "self"),
    "flash_sinks_7_3": ("ring_flash_attention",
                        dict(causal=True, window=7, sinks=3), "self"),
    "flash_sinks_9_7": ("ring_flash_attention",
                        dict(causal=True, window=9, sinks=7), "self"),
    "flash_sinks_seg_9_4": ("ring_flash_attention",
                            dict(causal=True, window=9, sinks=4), "seg"),
    "ulysses_causal": ("ulysses_attention", dict(causal=True), "self"),
    "ulysses_noncausal": ("ulysses_attention", dict(causal=False), "self"),
    "ulysses_seg": ("ulysses_attention", dict(causal=True), "seg"),
    "ulysses_sinks": ("ulysses_attention",
                      dict(causal=True, window=9, sinks=4), "self"),
    "cross": ("ring_cross_attention", {}, "cross"),
    "cross_pad": ("ring_cross_attention", {}, "cross_pad"),
    "cross_allpad": ("ring_cross_attention", {}, "cross_allpad"),
}


def _inputs(kind, seed):
    """Global q, k, v (and ids: (q_ids, kv_ids) for the cross ring, one
    array for self-attention) of a case, from its seed."""
    rng = np.random.RandomState(seed)
    tq, tk = {"cross": (TQ_CROSS, TK_CROSS), "cross_pad": (16, 32),
              "cross_allpad": (16, 32)}.get(kind, (T, T))
    q = rng.randn(B, tq, H, D).astype(np.float32)
    k = rng.randn(B, tk, H, D).astype(np.float32)
    v = rng.randn(B, tk, H, D).astype(np.float32)
    ids = None
    if kind == "seg":
        ids = np.sort(rng.randint(0, 3, size=(B, T)), axis=1).astype(np.int32)
    elif kind in ("cross_pad", "cross_allpad"):
        kv = np.ones((B, tk), np.int32)
        if kind == "cross_pad":
            kv[:, 20:] = 0
        else:
            kv[1, :] = 0
        ids = (np.ones((B, tq), np.int32), kv)
    return q, k, v, ids


CHILD = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.ops import attention as tatt
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r, n = ht.rank(), ht.size()
out = os.environ["OUT"]
mesh = tmesh.build_mesh(tmesh.MeshSpec(data=1, seq=n))
g = mesh.group("seq")
data = np.load(os.path.join(out, "data.npz"))
cases = json.loads(os.environ["CASES"])
res = {}


def mine(a):
    t = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(a[:, r * t:(r + 1) * t]))


for name, (fn, kw, kind) in cases.items():
    q, k, v = (mine(data[f"{name}.{x}"]).requires_grad_()
               for x in ("q", "k", "v"))
    extra = {}
    if kind == "seg":
        extra["segment_ids"] = mine(data[f"{name}.ids"])
    elif kind.startswith("cross_"):
        extra = dict(q_segment_ids=mine(data[f"{name}.q_ids"]),
                     kv_segment_ids=mine(data[f"{name}.kv_ids"]))
    o = getattr(tatt, fn)(q, k, v, group=g, **kw, **extra)
    (o ** 2).sum().backward()
    res[name + ".out"] = o.detach().numpy()
    for x, t in (("q", q), ("k", k), ("v", v)):
        res[f"{name}.d{x}"] = t.grad.numpy()

bad = torch.zeros((2, 32 // n, 3, 8))
try:
    tatt.ulysses_attention(bad, bad, bad, group=g)
    res["heads_refusal"] = ""
except ValueError as e:
    res["heads_refusal"] = str(e)
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _start(tmp, nprocs):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CASES=json.dumps(CASES))
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


def _jax_case(name, n, q, k, v, ids):
    """JAX's output and gradients of q, k, v under shard_map over n
    devices."""
    fn, kw, kind = CASES[name]
    spec, ispec = P(None, "seq", None, None), P(None, "seq")
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    if kind == "seg":
        def local(q, k, v, i):
            return getattr(jatt, fn)(q, k, v, axis_name="seq",
                                     segment_ids=i, **kw)
        extra, in_specs = (jnp.asarray(ids),), (spec,) * 3 + (ispec,)
    elif kind.startswith("cross_"):
        def local(q, k, v, qi, ki):
            return getattr(jatt, fn)(q, k, v, axis_name="seq",
                                     q_segment_ids=qi, kv_segment_ids=ki,
                                     **kw)
        extra = tuple(map(jnp.asarray, ids))
        in_specs = (spec,) * 3 + (ispec, ispec)
    else:
        local = functools.partial(getattr(jatt, fn), axis_name="seq", **kw)
        extra, in_specs = (), (spec,) * 3
    sm = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=spec,
                   check_vma=False)

    def loss(q, k, v):
        o = sm(q, k, v, *extra)
        return (o ** 2).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``get(n)``: the n-rank launch and JAX's results, made once."""
    done: dict = {}

    def get(n):
        if n not in done:
            tmp = tmp_path_factory.mktemp(f"seq{n}")
            arrays, inputs = {}, {}
            for i, (name, (_, _, kind)) in enumerate(CASES.items()):
                q, k, v, ids = _inputs(kind, 100 + i)
                inputs[name] = (q, k, v, ids)
                arrays.update({f"{name}.q": q, f"{name}.k": k,
                               f"{name}.v": v})
                if kind == "seg":
                    arrays[f"{name}.ids"] = ids
                elif ids is not None:
                    arrays[f"{name}.q_ids"], arrays[f"{name}.kv_ids"] = ids
            np.savez(tmp / "data.npz", **arrays)
            proc = _start(tmp, n)  # the ranks run while JAX computes
            # JAX's kernels through their plain references (the dense
            # (out, lse) path its own parity tests hold the kernel to), as
            # the port's CPU tensors take theirs.
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jfa, "supported", lambda *a, **k: False)
                ref = {name: _jax_case(name, n, *inputs[name])
                       for name in CASES}
            done[n] = dict(ranks=_finish(proc, tmp, n), ref=ref)
        return done[n]

    return get


def _rel_close(got, want, what):
    # A tensor that is zero up to rounding (window 1's dq: each query sees
    # itself alone) is held to 1e-5 absolute.
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= RTOL, (what, err)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_under_shard_map(worlds, n, name):
    world = worlds(n)
    o_ref, g_ref = world["ref"][name]
    for r, res in enumerate(world["ranks"]):
        tq = o_ref.shape[1] // n
        tk = g_ref[1].shape[1] // n
        rows, cols = slice(r * tq, (r + 1) * tq), slice(r * tk, (r + 1) * tk)
        _rel_close(res[name + ".out"], o_ref[:, rows], f"{name} out r{r}")
        for x, g, sl in zip("qkv", g_ref, (rows, cols, cols)):
            _rel_close(res[f"{name}.d{x}"], g[:, sl], f"{name} d{x} r{r}")
    if name == "cross_allpad":
        for res in world["ranks"]:
            assert float(np.abs(res[name + ".out"][1]).max()) == 0.0
            assert float(np.abs(res[name + ".out"][0]).max()) > 0.0


@pytest.mark.parametrize("n", [2, 4])
def test_indivisible_heads_refused_as_jax(worlds, n):
    bad = np.zeros((2, 32, 3, 8), np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq", None, None)
    with pytest.raises(ValueError) as ref:
        shard_map(functools.partial(jatt.ulysses_attention, axis_name="seq"),
                  mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                  check_vma=False)(bad, bad, bad)
    for res in worlds(n)["ranks"]:
        assert str(res["heads_refusal"]) == str(ref.value)


def _one_device(fn, **kw):
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    spec = P(None, "seq", None, None)
    return shard_map(functools.partial(fn, axis_name="seq", **kw), mesh=mesh,
                     in_specs=(spec,) * 3, out_specs=spec, check_vma=False)


@pytest.mark.parametrize("fn,kw", [
    ("ring_flash_attention", dict(causal=True)),
    ("ring_flash_attention", dict(causal=True, window=9, sinks=4)),
    ("ring_attention", dict(causal=True)),
    ("ulysses_attention", dict(causal=False)),
    ("ring_cross_attention", {}),
], ids=["flash", "flash_sinks", "ring_dense", "ulysses", "cross"])
def test_group_of_one_is_the_local_path(fn, kw):
    """n = 1 (no process group): the local path exactly, and JAX's
    one-device degenerate ring."""
    q, k, v, _ = _inputs("self", 7)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = getattr(tatt, fn)(tq, tk, tv, **kw)
    if fn == "ring_attention":
        local = tatt.dense_attention(tq, tk, tv, **kw)
        _rel_close(got.numpy(), local.numpy(), "dense")
    else:
        local = tfa.flash_attention(tq, tk, tv, **dict(dict(causal=False),
                                                          **kw))
        if kw.get("sinks"):  # the sink columns merge as a hop of their own
            _rel_close(got.numpy(), local.numpy(), "local")
        else:
            assert torch.equal(got, local)
    ref = _one_device(getattr(jatt, fn), **kw)(q, k, v)
    _rel_close(got.numpy(), np.asarray(ref), "jax n=1")


def test_refusals_match_jax():
    q, k, v, _ = _inputs("self", 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for kw in (dict(causal=True, sinks=4), dict(causal=True, window=9,
                                                sinks=T + 1),
               dict(causal=False, window=4)):
        with pytest.raises(ValueError) as ref:
            _one_device(jatt.ring_flash_attention, **kw)(q, k, v)
        with pytest.raises(ValueError) as port:
            tatt.ring_flash_attention(tq, tk, tv, **kw)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jatt.ring_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  q_segment_ids=jnp.ones((B, T), jnp.int32))
    with pytest.raises(ValueError, match="pair") as port:
        tatt.ring_cross_attention(tq, tk, tv,
                                  q_segment_ids=torch.ones((B, T),
                                                           dtype=torch.int32))
    assert str(port.value) == str(ref.value)
