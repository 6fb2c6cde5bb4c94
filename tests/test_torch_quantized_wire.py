"""The port's quantized and hierarchical reduction against the JAX package's,
at two and four gloo ranks.

One launch of two ranks and one of four run every case; each rank saves
what it got and the tests read those files. The JAX side puts the same
per-rank inputs through `shard_map` over the first 2 or 4 of the test
mesh's 8 CPU devices.

Tolerances:
* exact wires (f32, and bf16 where the same partial sums are cast): equal
  to JAX's to one f32 ulp of the largest input magnitude times the group
  size (addition order only);
* quantized wires: each rank's quantized payload equals JAX's bit for bit
  (`_quantize` on the same array); delivered sums within one f32 ulp of
  the largest dequantized term per summed term. In `reduce_gradients` and
  the two-hop sum the delivered leaves and the residuals equal JAX's to
  four f32 ulps of the largest partial sum's magnitude, except at most
  `QUANTIZED_MAX_FLIPS` elements a rank and case, each within one step of the
  delivering hop's grid (an ulp of a partial sum that flipped a
  re-quantization; `test_torch_reduction_layout.assert_equal_but_flips`);
* the one-shot gather-sum within one quantum of the two-shot;
* the error-mass identity: the ranks' errors summed equal the true sum
  minus the delivered sum to 1e-6 of the inputs' largest magnitude.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import compat
from horovod_tpu.parallel import collectives as jcoll
from horovod_tpu_torch.parallel import collectives as tcoll

from test_torch_collectives import run_ranks
from test_torch_reduction_layout import assert_equal_but_flips

P = jax.sharding.PartitionSpec
WIRES = {"none": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
QMAX = {"int8": 127.0, "fp8": 448.0}
N_VEC = 37
BUCKET_BYTES = 96
#: Elements of one rank's outputs in one quantized case (delivered leaves
#: and residuals, about a hundred) that may differ from JAX's by one
#: rounding flip.
QUANTIZED_MAX_FLIPS = 4


def vec(r, n=N_VEC, seed=0):
    return (np.random.RandomState(1000 * seed + r).randn(n) * (1 + r)
            ).astype(np.float32)


def grad_tree(r, seed=0):
    rng = np.random.RandomState(500 + 17 * seed + r)
    return {"w": rng.randn(8, 6).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "s": np.float32(rng.randn()),
            "k": rng.randn(3, 4, 4).astype(np.float32)}


def residual_tree(r):
    t = grad_tree(r, seed=9)
    return {k: (v * 1e-2).astype(np.float32) for k, v in t.items()}


# Cases of reduce_gradients: (name, kwargs) — wire names, dcn, scatter,
# residual. The scatter cases' dp is the world size.
def reduce_cases(n):
    cases = [("dense_f32", dict()), ("dense_bf16", dict(wire="bf16")),
             ("dense_int8_res", dict(wire="int8", residual=True)),
             ("dense_fp8", dict(wire="fp8")),
             ("scatter_f32", dict(scatter=True)),
             ("scatter_bf16", dict(wire="bf16", scatter=True)),
             ("scatter_int8_res", dict(wire="int8", scatter=True,
                                       residual=True))]
    if n == 4:
        cases += [("hier_int8_ici_res", dict(dcn=2, wire="none",
                                             ici="int8", residual=True)),
                  ("hier_scatter_ici_int8_res",
                   dict(dcn=2, ici="int8", scatter=True, residual=True)),
                  ("hier_scatter_bf16", dict(dcn=2, wire="bf16",
                                             scatter=True))]
    return cases


CHILD = r'''
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.parallel import collectives as c, mesh
sys.path.insert(0, os.environ["TESTS"])
from test_torch_quantized_wire import (vec, grad_tree, residual_tree,
                                       reduce_cases, WIRES, BUCKET_BYTES)

ht.init(device="cpu")
r, n = ht.rank(), ht.size()
res = {}
T = lambda a: torch.from_numpy(np.asarray(a))
npy = lambda t: t.detach().numpy().copy()
for w in ("int8", "fp8"):
    wd = WIRES[w][1]
    tot, err = c.quantized_group_sum(T(vec(r)), wd)
    res[f"qgs_{w}"] = (npy(tot), npy(err))
    one, _ = c._quantized_gather_sum(T(vec(r)), wd)
    res[f"gather_{w}"] = npy(one)
    ici_g, dcn_g, ici_pos, dcn_pos = mesh.hier_groups(2)
    group, pos = (dcn_g, dcn_pos) if n == 2 else (ici_g, ici_pos)
    tot, err = c.quantized_group_sum(T(vec(r, seed=1)), wd, group=group,
                                     group_position=pos)
    res[f"qgs_group_{w}"] = (npy(tot), npy(err))
if n == 4:
    assert mesh.dcn_factor() == 2  # HVT_DCN_FACTOR
    for wn, (_, wd) in WIRES.items():
        for inn, (_, idt) in WIRES.items():
            out, err = c._hierarchical_psum_err(
                T(vec(r, seed=2)), 2, wire_dtype=wd, ici_wire_dtype=idt,
                residual=T(vec(r, seed=3) * 1e-2))
            res[f"hier_{wn}_{inn}"] = (npy(out), npy(err))
for name, kw in reduce_cases(n):
    tree = {k: T(v) for k, v in grad_tree(r).items()}
    resid = ({k: T(v) for k, v in residual_tree(r).items()}
             if kw.get("residual") else None)
    out = c.reduce_gradients(
        tree, dcn=kw.get("dcn", 1), wire_dtype=WIRES[kw.get("wire", "none")][1],
        ici_wire_dtype=WIRES[kw.get("ici", "none")][1],
        bucket_bytes=BUCKET_BYTES, reverse=True, residual=resid,
        scatter=n if kw.get("scatter") else None)
    if resid is not None:
        out, new_res = out
        res[f"rg_{name}_res"] = {k: npy(v) for k, v in new_res.items()}
    res[f"rg_{name}"] = {k: npy(v) for k, v in out.items()}
# A residual on an exact scatter reduction is refused.
try:
    c.reduce_gradients({k: T(v) for k, v in grad_tree(r).items()},
                       scatter=n, residual={k: T(v) for k, v in
                                            residual_tree(r).items()})
    res["refused"] = False
except ValueError:
    res["refused"] = True
with open(os.path.join(os.environ["OUT"], f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
ht.shutdown()
'''


def _launch(tmp_path_factory, n):
    tmp = tmp_path_factory.mktemp(f"qwire{n}")
    env = {"TESTS": os.path.dirname(os.path.abspath(__file__))}
    if n == 4:
        env["HVT_DCN_FACTOR"] = "2"
    run_ranks(CHILD, n, tmp, env=env)
    out = []
    for r in range(n):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _launch(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _launch(tmp_path_factory, 4)


@pytest.fixture
def results(request):
    return request.getfixturevalue(f"ranks{request.param}")


def on_mesh(fn, n, *stacked):
    """``fn`` over the first ``n`` CPU devices, each device getting its row
    of every stacked input; returns the per-device outputs stacked."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))

    def body(*xs):
        out = fn(*jax.tree.map(lambda a: a[0], xs))
        return jax.tree.map(lambda a: a[None], out)

    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"), check_vma=False))
    return jax.tree.map(np.asarray, f(*stacked))


def ulp(x):
    return np.spacing(np.float32(np.max(np.abs(x))))


def stack(fn, n, **kw):
    return jax.tree.map(lambda *a: np.stack(a), *[fn(r, **kw)
                                                 for r in range(n)])


@pytest.mark.parametrize("results", [2, 4], indirect=True, ids=["2r", "4r"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_group_sum_matches_jax(results, wire):
    n = len(results)
    jw = WIRES[wire][0]
    xs = stack(vec, n)
    for r in range(n):  # the payloads, bit for bit
        jp, js = jcoll._quantize(jnp.asarray(xs[r]), jw)
        tp, ts = tcoll._quantize(torch.from_numpy(xs[r]), WIRES[wire][1])
        np.testing.assert_array_equal(np.asarray(jp).astype(np.float32),
                                      tp.float().numpy())
        assert float(js) == float(ts)
    got = on_mesh(lambda v: jcoll.quantized_group_sum(v, "data", jw), n, xs)
    tol = n * ulp(xs) * n
    for r in range(n):
        tot, err = results[r][f"qgs_{wire}"]
        np.testing.assert_allclose(tot, got[0][r], rtol=0, atol=tol)
        np.testing.assert_allclose(err, got[1][r], rtol=0, atol=tol)
        np.testing.assert_array_equal(tot, results[0][f"qgs_{wire}"][0])


@pytest.mark.parametrize("results", [2, 4], indirect=True, ids=["2r", "4r"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_group_sum_in_groups_matches_jax(results, wire):
    n = len(results)
    jw = WIRES[wire][0]
    xs = stack(vec, n, seed=1)
    ici_g, dcn_g = jcoll._hier_groups(n, 2)
    groups = dcn_g if n == 2 else ici_g
    ici = n // 2

    def fn(v):
        pos = (jax.lax.axis_index("data") // ici if n == 2
               else jax.lax.axis_index("data") % ici)
        return jcoll.quantized_group_sum(v, "data", jw,
                                         axis_index_groups=groups,
                                         group_position=pos)

    got = on_mesh(fn, n, xs)
    tol = 2 * ulp(xs) * 2
    for r in range(n):
        tot, err = results[r][f"qgs_group_{wire}"]
        np.testing.assert_allclose(tot, got[0][r], rtol=0, atol=tol)
        np.testing.assert_allclose(err, got[1][r], rtol=0, atol=tol)


@pytest.mark.parametrize("results", [2, 4], indirect=True, ids=["2r", "4r"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_error_mass_identity(results, wire):
    """Summed over the ranks, the errors are the true sum minus what was
    delivered: nothing is lost, whatever the wire rounds."""
    n = len(results)
    xs = stack(vec, n).astype(np.float64)
    delivered = results[0][f"qgs_{wire}"][0].astype(np.float64)
    errs = sum(results[r][f"qgs_{wire}"][1].astype(np.float64)
               for r in range(n))
    np.testing.assert_allclose(errs, xs.sum(0) - delivered, rtol=0,
                               atol=1e-6 * np.abs(xs).max())


@pytest.mark.parametrize("results", [2, 4], indirect=True, ids=["2r", "4r"])
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_one_shot_gather_sum_within_a_quantum_of_two_shot(results, wire):
    n = len(results)
    xs = stack(vec, n)
    two = results[0][f"qgs_{wire}"][0]
    # Shot 2 re-quantizes the reduced chunks: at most half a quantum of
    # the largest chunk's scale (int8 rounds; e4m3 keeps 3 mantissa bits
    # of the value, within a quantum of the largest's scale too).
    quantum = np.abs(xs.sum(0)).max() / QMAX[wire] * (
        1 if wire == "int8" else 64)
    for r in range(n):
        np.testing.assert_allclose(results[r][f"gather_{wire}"], two,
                                   rtol=0, atol=quantum + ulp(xs) * n)


def test_hierarchical_psum_all_wire_pairs_match_jax(ranks4):
    n = 4
    xs = stack(vec, n, seed=2)
    rs = (stack(vec, n, seed=3) * np.float32(1e-2)).astype(np.float32)
    for wn, (jw, _) in WIRES.items():
        for inn, (ji, _) in WIRES.items():
            got = on_mesh(lambda v, r: jcoll._hierarchical_psum_err(
                v, "data", 2, wire_dtype=jw, ici_wire_dtype=ji, residual=r),
                n, xs, rs)
            # The quantum of the last quantized hop, where one ulp of a
            # partial sum may flip a re-quantization.
            big = np.abs(xs).sum(0).max()
            q = max((big / QMAX[w] * (1 if w == "int8" else 32)
                     for w in (wn, inn) if w in QMAX), default=0.0)
            if wn == "bf16":
                q = max(q, big * 2.0 ** -8)
            for r in range(n):
                flips = 0
                out, err = ranks4[r][f"hier_{wn}_{inn}"]
                if q == 0.0:  # exact wires: addition order only
                    for a, b in ((out, got[0][r]), (err, got[1][r])):
                        np.testing.assert_allclose(
                            a, b, rtol=0, atol=2 * n * ulp(xs),
                            err_msg=f"{wn}/{inn}")
                    continue
                for a, b, what in ((out, got[0][r], "sum"),
                                   (err, got[1][r], "error")):
                    flips += assert_equal_but_flips(
                        a, b, big, q, QUANTIZED_MAX_FLIPS - flips,
                        f"{wn}/{inn} rank {r} {what}")
            if wn != "none" or inn not in QMAX:
                # A cast hop rounds without charging; a quantized dcn hop
                # runs in each of the ici parallel dcn groups, which each
                # charge their own copy of the sum.
                continue
            # Per-hop charging: the ici hop's errors telescope over the
            # world.
            total = (xs.astype(np.float64) + rs).sum(0)
            errs = sum(ranks4[r][f"hier_{wn}_{inn}"][1].astype(np.float64)
                       for r in range(n))
            np.testing.assert_allclose(
                errs, total - ranks4[0][f"hier_{wn}_{inn}"][0], rtol=0,
                atol=1e-5 * np.abs(xs).max(), err_msg=f"{wn}/{inn}")


def _case_ids(n):
    return [name for name, _ in reduce_cases(n)]


@pytest.mark.parametrize("results,name", [
    *[(2, c) for c in _case_ids(2)], *[(4, c) for c in _case_ids(4)]],
    indirect=["results"])
def test_reduce_gradients_matches_jax(results, name):
    n = len(results)
    kw = dict(reduce_cases(n))[name]
    trees = stack(grad_tree, n)
    res = stack(residual_tree, n) if kw.get("residual") else None

    def fn(t, r=None):
        return jcoll.reduce_gradients(
            t, data_axis="data", extra_axes=(), dcn=kw.get("dcn", 1),
            wire_dtype=WIRES[kw.get("wire", "none")][0],
            ici_wire_dtype=WIRES[kw.get("ici", "none")][0],
            bucket_bytes=BUCKET_BYTES, reverse=True, residual=r,
            scatter=n if kw.get("scatter") else None)

    got = on_mesh(fn, n, trees, res) if res is not None else on_mesh(
        fn, n, trees)
    if res is not None:
        got, got_res = got
    mags = max(np.abs(v).max() for v in trees.values())
    quantized = kw.get("wire") in QMAX or kw.get("ici") in QMAX
    # One step of the grid of the last quantized hop at its largest scale
    # (a re-quantized partial sum of up to n terms): int8's is the scale,
    # e4m3's 32 scales near its max.
    q = max((mags * n / QMAX[w] * (1 if w == "int8" else 32)
             for w in (kw.get("wire"), kw.get("ici")) if w in QMAX),
            default=0.0)
    tol = 2 * n * np.spacing(np.float32(mags * n))
    if kw.get("wire") == "bf16":
        tol = mags * n * 2.0 ** -8
    for r in range(n):
        flips = 0
        mine = results[r][f"rg_{name}"]
        outs = [(mine[k], got[k][r], f"leaf {k}") for k in mine]
        if res is not None:
            outs += [(v, got_res[k][r], f"residual {k}")
                     for k, v in results[r][f"rg_{name}_res"].items()]
        for a, b, what in outs:
            assert a.shape == b.shape, (what, a.shape, b.shape)
            if quantized:
                flips += assert_equal_but_flips(
                    a, b, mags * n, q, QUANTIZED_MAX_FLIPS - flips,
                    f"{name} rank {r} {what}")
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                           err_msg=f"{name} rank {r} {what}")


@pytest.mark.parametrize("results", [2, 4], indirect=True, ids=["2r", "4r"])
def test_exact_scatter_equals_dense_cut_locally(results):
    """The scatter reduction of an exact wire hands each rank exactly its
    block of the dense reduction (f32 at two ranks: the same two-term
    sums, bit for bit)."""
    n = len(results)
    for r in range(n):
        dense, scat = results[r]["rg_dense_f32"], results[r]["rg_scatter_f32"]
        cut = tcoll.slice_zero1_local(
            {k: torch.from_numpy(v) for k, v in dense.items()}, n, r)
        for k in dense:
            if n == 2:
                np.testing.assert_array_equal(scat[k], cut[k].numpy())
            else:
                np.testing.assert_allclose(scat[k], cut[k].numpy(), rtol=0,
                                           atol=1e-5)
        assert results[r]["refused"]
