"""The port's collectives: two gloo ranks launched by the port's launcher
against numpy references, and the fusion-bucket layout against the JAX
package's ``flatten_buckets``/``unflatten_buckets``.

One launch runs every two-rank collective and each rank saves what it got;
the tests below read those files. Tolerance: exact — the inputs are small
integers in f32, so a sum and a mean of two ranks are exact.
"""

import os
import pickle
import signal
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import collectives as jcoll
from horovod_tpu_torch.parallel import collectives as tcoll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


def run_ranks(code: str, nprocs: int, tmp_path, env=None) -> str:
    """Run ``code`` as ``nprocs`` ranks under the port's launcher; its
    output, or a failure naming it. The launch is killed as a group after
    TIMEOUT_S."""
    script = tmp_path / "child.py"
    script.write_text(code)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(nprocs), "--", sys.executable, str(script)]
    child_env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                     OUT=str(tmp_path), **(env or {}))
    proc = subprocess.Popen(cmd, cwd=REPO, env=child_env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"launch timed out after {TIMEOUT_S} s:\n{out}")
    assert proc.returncode == 0, out
    return out


CHILD = r'''
import os, pickle
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.parallel import collectives as c

ht.init(device="cpu")
r = ht.rank()
x = (np.arange(6, dtype=np.float32).reshape(2, 3) + 1) * (r + 1) + r
t = torch.from_numpy(x)
tree = {"b": [torch.full((2,), float(r)), torch.tensor(3.0 * r)],
        "a": torch.arange(4, dtype=torch.float64) * (r + 1)}
res = {
    "mean": c.allreduce(t).numpy(),
    "sum": c.allreduce(x, average=False).numpy(),
    "gather_tiled": c.allgather(t).numpy(),
    "gather_stacked": c.allgather(t, tiled=False).numpy(),
    "gather_scalar": c.allgather(torch.tensor(float(r))).numpy(),
    "bcast": c.broadcast(t, root=1).numpy(),
    "bcast_object": c.broadcast_object({"rank": r, "v": [r] * 3}, root=1),
    "gather_object": c.allgather_object(("r", r)),
    "metric_mean": c.metric_mean({"loss": 1.0 + r, "acc": 0.5 * r}),
    "pmean_tree": c.pmean_pytree(tree),
    "bcast_tree": c.broadcast_pytree(tree, root=1),
    "inplace_sum": (lambda u: (c.allreduce_(u, average=False) is u, u.numpy()))(
        torch.from_numpy(x.copy())),
    "inplace_mean_strided": (lambda u: (c.allreduce_(u) is u, u.numpy().copy()))(
        torch.from_numpy(x.copy()).t()),
    "wire_sum": c.allreduce(torch.tensor([1.0 + 2**-6, 3.0], dtype=torch.bfloat16)
                            * (r + 1), average=False).float().numpy(),
}
# The optimizer's bucketed reduction on the bf16 wire, mean and sum.
for avg in (True, False):
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.zeros(2, 2))
    opt = ht.DistributedOptimizer(torch.optim.SGD([p, q], lr=1.0),
                                  compression="bf16", average=avg)
    assert opt.bucket_bytes == 8  # HVT_BUCKET_BYTES, set by the launch
    p.grad = torch.tensor([1.0 + 2**-12, 3.0, -1.0]) * (r + 1)
    q.grad = torch.full((2, 2), 0.5 + r)
    opt.reduce_gradients()
    res[f"wire_grads_{avg}"] = (p.grad.numpy(), q.grad.numpy())
with open(os.path.join(os.environ["OUT"], f"rank{r}.pkl"), "wb") as f:
    pickle.dump({k: (v if not isinstance(v, dict) or k in ("bcast_object", "metric_mean")
                     else {kk: (vv if not isinstance(vv, list) else [t.numpy() for t in vv])
                           for kk, vv in v.items()}) for k, v in res.items()}, f)
ht.shutdown()
'''


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    run_ranks(CHILD, 2, tmp, env={"HVT_BUCKET_BYTES": "8"})
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _x(r):
    return (np.arange(6, dtype=np.float32).reshape(2, 3) + 1) * (r + 1) + r


@pytest.mark.parametrize("rank", [0, 1])
def test_allreduce_mean_and_sum(results, rank):
    res = results[rank]
    np.testing.assert_array_equal(res["mean"], (_x(0) + _x(1)) / 2)
    np.testing.assert_array_equal(res["sum"], _x(0) + _x(1))


@pytest.mark.parametrize("rank", [0, 1])
def test_allreduce_in_place(results, rank):
    """``allreduce_`` writes into its operand: a contiguous host tensor
    under gloo directly, a transposed view through a staging copy."""
    same, got = results[rank]["inplace_sum"]
    assert same
    np.testing.assert_array_equal(got, _x(0) + _x(1))
    same, got = results[rank]["inplace_mean_strided"]
    assert same
    np.testing.assert_array_equal(got, ((_x(0) + _x(1)) / 2).T)


@pytest.mark.parametrize("rank", [0, 1])
def test_allgather_tiled_and_stacked(results, rank):
    res = results[rank]
    np.testing.assert_array_equal(res["gather_tiled"],
                                  np.concatenate([_x(0), _x(1)]))
    np.testing.assert_array_equal(res["gather_stacked"],
                                  np.stack([_x(0), _x(1)]))
    np.testing.assert_array_equal(res["gather_scalar"], [0.0, 1.0])


@pytest.mark.parametrize("rank", [0, 1])
def test_broadcast_from_root_1(results, rank):
    res = results[rank]
    np.testing.assert_array_equal(res["bcast"], _x(1))
    assert res["bcast_object"] == {"rank": 1, "v": [1, 1, 1]}
    tree = res["bcast_tree"]
    np.testing.assert_array_equal(tree["a"], np.arange(4) * 2.0)
    np.testing.assert_array_equal(tree["b"][0], [1.0, 1.0])
    assert float(tree["b"][1]) == 3.0
    assert np.asarray(tree["a"]).dtype == np.float64


@pytest.mark.parametrize("rank", [0, 1])
def test_object_collectives_and_metric_mean(results, rank):
    res = results[rank]
    assert res["gather_object"] == [("r", 0), ("r", 1)]
    assert res["metric_mean"] == {"loss": 1.5, "acc": 0.25}
    tree = res["pmean_tree"]
    np.testing.assert_array_equal(tree["a"], np.arange(4) * 1.5)
    np.testing.assert_array_equal(tree["b"][0], [0.5, 0.5])
    assert float(tree["b"][1]) == 1.5


@pytest.mark.parametrize("rank", [0, 1])
def test_bf16_wire_reduction(results, rank):
    """The sum runs in bf16 (1 + 2^-12 rounds to 1 on the wire); the mean
    is the f32 division of the bf16 sum by the world size."""
    res = results[rank]
    bf = ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        res["wire_sum"],
        (np.array([1.0 + 2**-6, 3.0], bf).astype(np.float32) * 3
         ).astype(bf).astype(np.float32))
    p0 = np.array([1.0 + 2**-12, 3.0, -1.0], np.float32)
    for avg in (True, False):
        p_sum = (p0.astype(bf) + (2 * p0).astype(bf)).astype(np.float32)
        q_sum = np.full((2, 2), 0.5 + 1.5, np.float32)
        p, q = res[f"wire_grads_{avg}"]
        np.testing.assert_array_equal(p, p_sum / 2 if avg else p_sum)
        np.testing.assert_array_equal(q, q_sum / 2 if avg else q_sum)


def test_collectives_are_the_identity_without_a_process_group():
    x = np.ones((2, 2), np.float32)
    assert tcoll.allreduce(x) is x
    assert tcoll.broadcast_object({"a": 1}) == {"a": 1}
    assert tcoll.allgather_object(3) == [3]
    assert tcoll.metric_mean({"loss": 2.0}) == {"loss": 2.0}
    tree = {"a": torch.ones(2)}
    assert tcoll.pmean_pytree(tree) is tree


# -- fusion buckets against the JAX package ------------------------------------


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "dense": {"kernel": rng.randn(5, 7).astype(np.float32),
                  "bias": rng.randn(7).astype(np.float32)},
        "half": rng.randn(3, 4).astype(np.float16),
        "count": np.array(3, np.int32),
        "scalar": np.array(2.5, np.float32),
        "layers": [rng.randn(9).astype(np.float32),
                   rng.randint(0, 9, (2, 3)).astype(np.int32)],
    }


@pytest.mark.parametrize("bucket_bytes,reverse", [
    (None, False), (None, True), (24, False), (24, True), (7, False),
    (64, True),
], ids=["default", "default-rev", "24B", "24B-rev", "7B", "64B-rev"])
def test_flatten_buckets_match_jax(bucket_bytes, reverse):
    tree = _tree(0)
    jb, jspec = jcoll.flatten_buckets(
        {k: jnp.asarray(v) if not isinstance(v, (dict, list)) else v
         for k, v in tree.items()}, bucket_bytes, reverse=reverse)
    tb, tspec = tcoll.flatten_buckets(tree, bucket_bytes, reverse=reverse)
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert [g for g in tspec[3]] == [g for g in jspec[3]]  # leaf groups
    back = tcoll.unflatten_buckets(tb, tspec)
    leaves, _ = tcoll.tree_flatten(back)
    want, _ = tcoll.tree_flatten(tree)
    for a, b in zip(leaves, want):
        assert a.shape == b.shape and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_unflatten_buckets_casts_back_and_checks_counts():
    tree = {"w": np.ones((2, 3), np.float32)}
    buckets, spec = tcoll.flatten_buckets(tree)
    wire = [b.to(torch.bfloat16) for b in buckets]
    assert tcoll.unflatten_buckets(wire, spec)["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="do not match"):
        tcoll.unflatten_buckets(buckets + buckets, spec)
    with pytest.raises(ValueError, match="positive"):
        tcoll.flatten_buckets(tree, 0)
