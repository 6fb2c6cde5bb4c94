"""The ZeRO-1 scatter layout and the quantized wire's quantization, the
port's against the JAX package's on the same numpy trees, in one process.

Tolerances: exact for the layout functions, which only move elements, and
for `_quantize` / `_dequantize` against JAX's op by op, which run the same
f32 operations (a division by a tensor, a reciprocal, a product, a clamp,
round half to even or the e4m3 cast). The world-of-one reduction against
JAX's jitted one: exact for the f32 and bf16 wires; for int8/fp8 the
delivered sum and the new residual equal JAX's to four f32 ulps of the
inputs' largest magnitude (XLA fuses the residual's sum and difference,
which rounds once where the port rounds twice), except at most
`MAX_FLIPS` elements of the tree, each within one step of the wire's grid
at the largest scale (an ulp may flip a rounding; that element's payload
then differs from JAX's by one step). A residual is at most half a step,
so four ulps see a residual that is zero, of the wrong sign or off by a
scale.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import collectives as jcoll
from horovod_tpu_torch.parallel import collectives as tcoll


#: Elements of a reduced tree allowed to differ from JAX's by one rounding
#: flip (see `assert_equal_but_flips`).
MAX_FLIPS = 2


def assert_equal_but_flips(got, want, mag, quantum, max_flips, err_msg=""):
    """``got`` equals ``want`` to four f32 ulps of ``mag`` (the inputs'
    largest magnitude), except at most ``max_flips`` elements, each within
    ``quantum`` (one step of the wire's grid: a rounding that went the
    other way). Returns how many elements flipped."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    off = gap > 4 * np.spacing(np.float32(mag))
    assert off.sum() <= max_flips, (
        f"{err_msg}: {int(off.sum())} of {got.size} elements differ "
        f"(at most {max_flips} may), largest {gap.max()}")
    assert np.all(gap[off] <= quantum * (1 + 1e-6)), (
        f"{err_msg}: a flipped element is {gap[off].max()} off, more than "
        f"one quantum {quantum}")
    return int(off.sum())


def make_tree(seed=0):
    """Scatter leaves on their first and a later dim, tail leaves (odd
    sizes), 0-d leaves, a zero-size leaf and two dtypes."""
    rng = np.random.RandomState(seed)
    return {
        "dense": {"kernel": rng.randn(16, 24).astype(np.float32),
                  "bias": rng.randn(24).astype(np.float32)},
        "conv": rng.randn(3, 3, 5, 8).astype(np.float32),
        "odd": rng.randn(7).astype(np.float32),
        "scalar": np.float32(rng.randn()),
        "half": [rng.randn(9, 4).astype(np.float16),
                 rng.randn(3).astype(np.float16),
                 np.float16(rng.randn())],
        "empty": np.zeros((0, 3), np.float32),
    }


def torch_tree(tree):
    leaves, treedef = tcoll.tree_flatten(tree)
    return tcoll.tree_unflatten(treedef, [torch.from_numpy(np.asarray(l))
                                          for l in leaves])


def assert_leaves_equal(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl, _ = tcoll.tree_flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("bucket_bytes", [16, 200, 1 << 20])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_scatter_layout_matches_jax(dp, bucket_bytes, reverse):
    tree = make_tree()
    jb, js = jcoll.flatten_scatter_buckets(tree, dp, bucket_bytes,
                                           reverse=reverse)
    tb, ts = tcoll.flatten_scatter_buckets(torch_tree(tree), dp,
                                           bucket_bytes, reverse=reverse)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The spec: shapes, shard dims, dp and every bucket's pieces.
    assert js[1] == ts[1] and js[3] == ts[3] and js[4] == ts[4]
    assert js[5] == ts[5]
    assert jcoll.bucket_families(js) == tcoll.bucket_families(ts)
    assert jcoll.bucket_tail_spans(js) == tcoll.bucket_tail_spans(ts)
    for leaf in jax.tree_util.tree_leaves(tree):
        assert (jcoll.zero1_shard_dim(np.shape(leaf), dp)
                == tcoll.zero1_shard_dim(np.shape(leaf), dp))
    # Whole buckets back to the tree (the residual's path).
    assert_leaves_equal(jcoll.unflatten_scatter_full(jb, js),
                        tcoll.unflatten_scatter_full(tb, ts))
    # Shard s's rows back to its blocks, the tail columns gathered from
    # every shard's rows (what a reduce-scatter and the tail all-gather
    # deliver).
    for s in range(dp):
        jent, tent = [], []
        for a, b, sp in zip(jb, tb, jcoll.bucket_tail_spans(js)):
            ja = np.asarray(a).reshape(dp, -1)
            tm = b.reshape(dp, -1)
            if sp:
                cols = np.concatenate([ja[:, c:c + w] for c, w in sp], 1)
                jent.append((ja[s], cols.reshape(-1)))
                tent.append((tm[s], torch.from_numpy(cols.reshape(-1))))
            else:
                jent.append(ja[s])
                tent.append(tm[s])
        jloc = jcoll.unflatten_scatter_buckets(jent, js)
        tloc = tcoll.unflatten_scatter_buckets(tent, ts)
        assert_leaves_equal(jloc, tloc)
        # The local blocks are the dense leaves cut at shard s.
        cut = tcoll.slice_zero1_local(torch_tree(tree), dp, s)
        assert_leaves_equal(jloc, cut)


def test_scatter_layout_refuses_mismatches():
    tb, ts = tcoll.flatten_scatter_buckets(torch_tree(make_tree()), 2, 64)
    with pytest.raises(ValueError, match="do not match"):
        tcoll.unflatten_scatter_full(tb[:-1], ts)
    with pytest.raises(ValueError, match="do not match"):
        tcoll.unflatten_scatter_buckets(tb[:-1], ts)
    with pytest.raises(ValueError, match="positive"):
        tcoll.flatten_scatter_buckets(torch_tree(make_tree()), 2, 0)
    with pytest.raises(ValueError, match=">= 1"):
        tcoll.flatten_scatter_buckets(torch_tree(make_tree()), 0, 64)


QUANT_INPUTS = {
    "normal": np.random.RandomState(3).randn(1000).astype(np.float32) * 3,
    "tiny": np.random.RandomState(4).randn(33).astype(np.float32) * 1e-5,
    "halves": (np.arange(-20, 21, dtype=np.float32) + 0.5) / 20.5,
    "all_zero": np.zeros(17, np.float32),
    "matrix": np.random.RandomState(5).randn(4, 9).astype(np.float32),
}


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(QUANT_INPUTS))
def test_quantize_matches_jax(wire, name):
    v = QUANT_INPUTS[name]
    jw = jnp.int8 if wire == "int8" else jnp.float8_e4m3fn
    tw = torch.int8 if wire == "int8" else torch.float8_e4m3fn
    jp, js = jcoll._quantize(jnp.asarray(v), jw)
    tp, ts = tcoll._quantize(torch.from_numpy(v), tw)
    assert tp.dtype == tw and tp.shape == v.shape
    jbits = np.asarray(jp).view(np.int8 if wire == "int8" else np.uint8)
    tbits = tp.view(torch.int8 if wire == "int8" else torch.uint8).numpy()
    np.testing.assert_array_equal(jbits, tbits)  # the payload, bit for bit
    assert np.float32(js) == ts.item()
    np.testing.assert_array_equal(np.asarray(jcoll._dequantize(jp, js)),
                                  tcoll._dequantize(tp, ts).numpy())
    if name == "all_zero":
        assert ts.item() == 0.0 and not tp.float().any()
    if wire == "int8":
        assert tp.abs().max() <= 127
    else:
        assert np.abs(np.asarray(jp).astype(ml_dtypes.float8_e4m3fn)
                      .astype(np.float32)).max() <= 448


@pytest.mark.parametrize("wire", [None, torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
def test_world_of_one_reduction_matches_jax_on_one_device(wire):
    """`reduce_gradients` without a process group (a world of one) against
    JAX's over a one-device mesh: the quantized wires quantize there too.
    The residual comes back as what the two shots rounded away."""
    from horovod_tpu import compat

    jwire = {None: None, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8,
             torch.float8_e4m3fn: jnp.float8_e4m3fn}[wire]
    tree = {k: v for k, v in make_tree(1).items() if k != "half"}
    res = jax.tree.map(lambda a: (np.asarray(a) * 0.01).astype(np.float32),
                       make_tree(2))
    res = {k: v for k, v in res.items() if k != "half"}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    P = jax.sharding.PartitionSpec
    f = jax.jit(compat.shard_map(
        lambda t, r: jcoll.reduce_gradients(
            t, data_axis="data", extra_axes=(), wire_dtype=jwire,
            bucket_bytes=64, reverse=True, residual=r),
        mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))
    jout, jres = f(tree, res)
    tout, tres = tcoll.reduce_gradients(
        torch_tree(tree), wire_dtype=wire, bucket_bytes=64, reverse=True,
        residual=torch_tree(res))
    if wire in (None, torch.bfloat16):
        assert_leaves_equal(jout, tout)
        assert_leaves_equal(jres, tres)
        return
    amax = max(np.abs(np.asarray(a, np.float32) + np.asarray(b)).max()
               for a, b in zip(jax.tree_util.tree_leaves(tree),
                               jax.tree_util.tree_leaves(res)) if np.size(a))
    # One step of the grid at the largest scale: int8's is the scale, and
    # e4m3's near its max (448 = 1.75 · 2^8) is 2^5 = 32 scales.
    quantum = amax / 127.0 if wire == torch.int8 else amax / 448.0 * 32
    for a, b in ((jout, tout), (jres, tres)):
        jl, (tl, _) = jax.tree_util.tree_leaves(a), tcoll.tree_flatten(b)
        flips = 0
        for x, y in zip(jl, tl):
            flips += assert_equal_but_flips(y.numpy(), x, amax, quantum,
                                            MAX_FLIPS - flips)
