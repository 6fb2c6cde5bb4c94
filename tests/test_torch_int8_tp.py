"""int8 on a live ``model``, ``fsdp`` or ``expert`` axis
(`horovod_tpu_torch.models.quant`), through the port's launcher at four
gloo ranks on the CPU, meshes ``(data=2, model=2)``, ``(data=2, fsdp=2)``
and ``(data=2, expert=2)`` in one launch:

* `int8_dot_general` over a contraction cut in two over ``model``: the
  amaxes are maxima over the group and the int32 partial products are
  summed there before the scaling, so the result is bit-equal to the
  one-device product, in f32 and bf16; `collectives.all_reduce_sum`
  carries int32 exactly (operands near 2^28, past f32's 2^24) and
  `collectives.all_reduce_max` takes the group's maximum;
* the ``int8_compute`` prefill's logits at ``model=2`` (the row-parallel
  layers' int8 products summed over ``model``, the LM head's vocab rows
  gathered) and at ``fsdp=2`` (the weights gathered at use) against JAX's
  int8 model and the one-rank port;
* ``quantized_cache`` greedy decoding at ``model=2`` (``[B, L, H_kv/tp,
  D]`` int8 with its per-(position, local head) scales) on
  tests/test_quant.py::TestQuantizedCache::test_tp_mesh_matches_single_device's
  model and prompt: tokens equal to JAX's on its ``data=4, model=2`` mesh;
* `quantize_params` of a cut model: each rank's values and scales are its
  part of the whole tree's — the port's one-rank tree exactly, and JAX's
  tree (values exactly, scales within one f32 ulp as
  tests/test_torch_quant.py holds them) — with ``attn_out``'s heads and
  ``mlp_down``'s inputs reduced over ``model``, the embedding's vocab over
  ``fsdp`` and the MoE stacks' experts over ``expert``. The stacks'
  scales at ``expert=2`` are held bit for bit against JAX's tree, which
  reduces them over all E (a reduction over a rank's own experts gives
  other int8 values);
* ``int8_compute`` on an MoE model keeps JAX's own ``ValueError`` on a
  mesh too.

Tolerances: the int8 product and the shards exactly; logits against JAX
1e-5 abs (tests/test_torch_quant.py's INT8_LOGITS_ATOL: the f32 sums
around the int8 products run in other orders) and against the one-rank
port the same; tokens exactly.
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

from horovod_tpu.models import decoding as jdec
from horovod_tpu.models import quant as jquant
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import quant as tquant
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_to_flax, qparams_from_flax
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding as shard_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150
NPROCS = 4
INT8_LOGITS_ATOL = 1e-5
# tests/test_torch_quant.py's model, GQA so kv_proj's rows are fused.
CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, dropout=0.0)
QUANT_KW = {"data=2,model=2": dict(n_kv_heads=2),
            "data=2,fsdp=2": dict(n_kv_heads=2),
            "data=2,expert=2": dict(moe_every=2, n_experts=4)}
INT8_MESHES = ["data=2,model=2", "data=2,fsdp=2"]
# tests/test_quant.py's cache model: VOCAB 32, d 64, 4 heads, 2 layers.
CACHE_CFG = dict(vocab_size=32, d_model=64, n_heads=4, n_layers=2,
                 dropout=0.0)
CACHE_NEW = 8

CHILD = r'''
import json, os
import numpy as np
import torch
import horovod_tpu_torch as ht
from horovod_tpu_torch.models import quant, transformer as ttr
from horovod_tpu_torch.models.decoding import make_generate_fn
from horovod_tpu_torch.parallel import collectives as c
from horovod_tpu_torch.parallel import mesh as tmesh

ht.init(device="cpu")
r = ht.rank()
out = os.environ["OUT"]
cfg = json.loads(os.environ["CFG"])
data = np.load(os.path.join(out, "data.npz"))
res = {}

# The exact sums and maxima of the wire.
big = torch.tensor([2 ** 28 + 7 * r, -(2 ** 28) - r, 3], dtype=torch.int32)
res["sum"] = c.all_reduce_sum(big).numpy()
res["max"] = c.all_reduce_max(torch.tensor([float(r), -float(r)])).numpy()

mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,model=2"))
group, m = mesh.group("model"), mesh.coords["model"]
k = data["x"].shape[1] // 2
for dt in ("float32", "bfloat16"):
    td = getattr(torch, dt)
    x = torch.from_numpy(data["x"][:, m * k:(m + 1) * k]).to(td)
    w = torch.from_numpy(data["w"][:, m * k:(m + 1) * k]).to(td)
    res["dot." + dt] = quant.int8_dot_general(
        x, w, out_dtype=torch.float32, group=group).numpy()

toks = torch.from_numpy(data["toks"])
for tag in json.loads(os.environ["INT8_MESHES"]):
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    model = ttr.TransformerLM(**cfg, int8_compute=True, device="cpu",
                              seed=1, sharding=ttr.ShardingConfig(mesh=mesh))
    with torch.no_grad():
        res[tag + ".int8_logits"] = model(toks).numpy()
    try:
        ttr.TransformerLM(**cfg, int8_compute=True, moe_every=2,
                          n_experts=4, device="cpu",
                          sharding=ttr.ShardingConfig(mesh=mesh))
        res[tag + ".moe_refusal"] = ""
    except ValueError as e:
        res[tag + ".moe_refusal"] = str(e)

for tag, kw in json.loads(os.environ["QUANT_KW"]).items():
    mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string(tag))
    model = ttr.TransformerLM(**cfg, **kw, device="cpu", seed=1,
                              sharding=ttr.ShardingConfig(mesh=mesh))
    for name, leaf in quant.quantize_params(model, min_size=16).items():
        if quant.is_qleaf(leaf):
            res[f"{tag}.q.{name}"] = leaf["int8_q"].numpy()
            res[f"{tag}.s.{name}"] = leaf["scale"].numpy()
        else:
            res[f"{tag}.p.{name}"] = leaf.numpy()

# The int8 cache at model=2 from the test's weights.
mesh = tmesh.build_mesh(tmesh.MeshSpec.from_string("data=2,model=2"))
cache_cfg = json.loads(os.environ["CACHE_CFG"])
model = ttr.TransformerLM(**cache_cfg, device="cpu",
                          sharding=ttr.ShardingConfig(mesh=mesh))
full = {k[3:]: torch.from_numpy(v) for k, v in data.items()
        if k.startswith("sd.")}
from horovod_tpu_torch.models.convert import shard_state_dict
model.load_state_dict(shard_state_dict(full, mesh, model.cuts))
gen = make_generate_fn(model, max_new_tokens=int(os.environ["CACHE_NEW"]),
                       quantized_cache=True)
res["cache_tokens"] = gen(torch.from_numpy(data["prompt"])).numpy()
cache = model.clone(quantized_cache=True).new_cache(4, 16)
res["cache_shape"] = np.array(cache["Block_0"]["k"].shape)
res["cache_scale_shape"] = np.array(cache["Block_0"]["k_scale"].shape)
res["coords.model"] = mesh.coords["model"]
np.savez(os.path.join(out, f"rank{r}.npz"), **res)
'''


def _meshes(tag):
    return [tmesh.build_mesh(tmesh.MeshSpec.from_string(tag),
                             n_ranks=NPROCS, rank=r) for r in range(NPROCS)]


def _cache_params():
    """tests/test_quant.py's cache model weights (JAX's init at key 0)."""
    jm = jtr.TransformerLM(**CACHE_CFG)
    prompt = np.random.RandomState(0).randint(
        1, CACHE_CFG["vocab_size"], (4, 8)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(prompt))["params"]
    return jm, params, prompt


def _data(tmp):
    from horovod_tpu_torch.models.convert import params_from_flax

    rng = np.random.RandomState(2)
    x = rng.randn(5, 48).astype(np.float32)
    w = rng.randn(40, 48).astype(np.float32)  # [N, K]
    toks = np.random.RandomState(3).randint(
        0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    _, params, prompt = _cache_params()
    sd = params_from_flax(jax.device_get(params))
    np.savez(tmp / "data.npz", x=x, w=w, toks=toks, prompt=prompt,
             **{"sd." + k: v.numpy() for k, v in sd.items()})
    return dict(x=x, w=w, toks=toks, prompt=prompt)


def _start(tmp):
    cmd = [sys.executable, "-m", "horovod_tpu_torch.launch", "run",
           "--nprocs", str(NPROCS), "--", sys.executable, "-c", CHILD]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               OUT=str(tmp), CFG=json.dumps(CFG),
               QUANT_KW=json.dumps(QUANT_KW),
               INT8_MESHES=json.dumps(INT8_MESHES),
               CACHE_CFG=json.dumps(CACHE_CFG), CACHE_NEW=str(CACHE_NEW))
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
    refs = {}
    for dt in ("float32", "bfloat16"):
        td = getattr(torch, dt)
        refs["dot." + dt] = tquant.int8_dot_general(
            torch.from_numpy(d["x"]).to(td), torch.from_numpy(d["w"]).to(td),
            out_dtype=torch.float32).numpy()
    tm = ttr.TransformerLM(**CFG, int8_compute=True, device="cpu", seed=1)
    with torch.no_grad():
        refs["int8_one"] = tm(torch.from_numpy(d["toks"])).numpy()
    jm = jtr.TransformerLM(**CFG, int8_compute=True)
    params = params_to_flax(tm.state_dict(), n_heads=CFG["n_heads"])
    refs["int8_jax"] = np.asarray(jm.apply({"params": params},
                                           jnp.asarray(d["toks"])))
    for tag, kw in QUANT_KW.items():
        one = ttr.TransformerLM(**CFG, **kw, device="cpu", seed=1)
        refs[tag + ".port"] = tquant.quantize_params(one, min_size=16)
        refs[tag + ".jax"] = qparams_from_flax(jax.device_get(
            jquant.quantize_params(params_to_flax(
                one.state_dict(), n_heads=CFG["n_heads"]), min_size=16)))
        refs[tag + ".specs"] = ttr.param_specs(one, _meshes(tag)[0])
    jm, params, prompt = _cache_params()
    mesh = jmesh.build_mesh(jmesh.MeshSpec(data=4, model=2),
                            jax.devices("cpu"))
    sharded = jtr.TransformerLM(**CACHE_CFG,
                                sharding=jtr.ShardingConfig(mesh=mesh))
    refs["cache_jax"] = np.asarray(jdec.make_generate_fn(
        sharded, max_new_tokens=CACHE_NEW, quantized_cache=True)(
        params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    refs["cache_jax_plain"] = np.asarray(jdec.make_generate_fn(
        jm, max_new_tokens=CACHE_NEW, quantized_cache=True)(
        params, jnp.asarray(prompt), jax.random.PRNGKey(0)))
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_tp")
    d = _data(tmp)
    proc = _start(tmp)  # the ranks run while the references compute
    try:
        refs = _references(d)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    return dict(data=d, refs=refs, ranks=_finish(proc, tmp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_product_over_a_cut_contraction_is_bit_equal(run, dtype):
    want = run["refs"]["dot." + dtype]
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["dot." + dtype], want)


def test_int32_sum_and_max_over_the_wire_are_exact(run):
    rs = np.arange(NPROCS)
    want = np.array([4 * 2 ** 28 + 7 * rs.sum(), -4 * 2 ** 28 - rs.sum(),
                     12], dtype=np.int64)
    for res in run["ranks"]:
        assert res["sum"].dtype == np.int32
        np.testing.assert_array_equal(res["sum"].astype(np.int64), want)
        np.testing.assert_array_equal(res["max"], [NPROCS - 1, 0])


@pytest.mark.parametrize("mesh", INT8_MESHES)
def test_int8_compute_prefill_matches_jax_and_one_rank(run, mesh):
    refs = run["refs"]
    for res in run["ranks"]:
        got = res[mesh + ".int8_logits"]
        np.testing.assert_allclose(got, refs["int8_jax"], rtol=0,
                                   atol=INT8_LOGITS_ATOL)
        np.testing.assert_allclose(got, refs["int8_one"], rtol=0,
                                   atol=INT8_LOGITS_ATOL)


@pytest.mark.parametrize("mesh", INT8_MESHES)
def test_int8_compute_on_moe_keeps_jax_refusal(run, mesh):
    from horovod_tpu_torch.models.quant import refuse_moe_int8_compute

    with pytest.raises(ValueError) as want:
        refuse_moe_int8_compute()
    for res in run["ranks"]:
        assert str(res[mesh + ".moe_refusal"]) == str(want.value)


def test_quantized_cache_tokens_equal_jax_at_its_mesh(run):
    refs = run["refs"]
    np.testing.assert_array_equal(refs["cache_jax"], refs["cache_jax_plain"])
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["cache_tokens"], refs["cache_jax"])
        # Local kv heads: 4 heads over model=2.
        assert tuple(res["cache_shape"]) == (4, 16, 2, 16)
        assert tuple(res["cache_scale_shape"]) == (4, 16, 2)


def _cut_leaf(leaf, name, placement, mesh, whole_shape):
    """This rank's part of a whole quantized leaf: the values cut as the
    weight; the scale along each placed dim where it spans the weight's
    (a reduced dim is 1 there, whole on every rank)."""
    q = shard_lib.shard_tensor(leaf["int8_q"], name, placement, mesh)
    s = leaf["scale"]
    if s.dim() == len(whole_shape):
        kept = {d: ax for d, ax in placement.items()
                if s.shape[d] == whole_shape[d]}
        s = shard_lib.shard_tensor(s, name, kept, mesh)
    elif name.endswith("attn_out.weight"):
        # [d, 1, D] over [d, H·D]: only dim 0 can be cut (fsdp).
        s = shard_lib.shard_tensor(s, name, {
            d: ax for d, ax in placement.items() if d == 0}, mesh)
    return q, s


@pytest.mark.parametrize("mesh", list(QUANT_KW))
def test_quantize_params_parts_are_the_cut_of_the_whole_tree(run, mesh):
    refs = run["refs"]
    port, jtree = refs[mesh + ".port"], refs[mesh + ".jax"]
    specs = refs[mesh + ".specs"]
    reduced_on_ranks = 0
    for r, (res, tm) in enumerate(zip(run["ranks"], _meshes(mesh))):
        live = ttr.live_placements(specs, tm)
        for name, leaf in port.items():
            if not tquant.is_qleaf(leaf):
                assert np.array_equal(res[f"{mesh}.p.{name}"], leaf.numpy())
                continue
            shape = tuple(leaf["int8_q"].shape)
            place = live.get(name, {})
            q, s = _cut_leaf(leaf, name, place, tm, shape)
            jq, js = _cut_leaf(jtree[name], name, place, tm, shape)
            got_q, got_s = res[f"{mesh}.q.{name}"], res[f"{mesh}.s.{name}"]
            np.testing.assert_array_equal(got_q, q.numpy(), err_msg=name)
            np.testing.assert_array_equal(got_s, s.numpy(), err_msg=name)
            np.testing.assert_array_equal(got_q, jq.numpy(), err_msg=name)
            if name.endswith((".moe_up", ".moe_down")):
                np.testing.assert_array_equal(got_s, js.numpy(),
                                              err_msg=name)
            else:
                np.testing.assert_array_max_ulp(got_s, js.numpy(),
                                                maxulp=1)
            dim = tquant._reduced_dim(name)
            reduced_on_ranks += dim in place
    # The cut reduced dims that need a group-wide maximum are there:
    # attn_out and mlp_down on model, the embedding on fsdp, the expert
    # stacks on expert.
    assert reduced_on_ranks >= NPROCS * (2 if mesh != "data=2,fsdp=2"
                                         else 1)
