"""The port's meshes (`horovod_tpu_torch.parallel.mesh`) against the JAX
package's: `MeshSpec.from_string`/`resolve` with every error text, each
rank's coordinates against the device ids of JAX's `build_mesh` over the 8
virtual CPU devices, `dp_size` and `has_live_model_axes`, and
`models.transformer.param_specs` placements against JAX's PartitionSpecs
for a dense and an MoE LM (the divisibility error included).

The port's meshes here are layouts (``build_mesh(..., n_ranks=8,
rank=r)``): coordinates without subgroups. The subgroups are checked at
gloo ranks in tests/test_torch_expert_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import mesh as tmesh

SPECS = ["", "data=8", "data=2,expert=4", "data=2,seq=2,expert=2",
         "data=2,fsdp=2,model=2", "expert=8,data=1", "pipe=2,data=-1",
         "data=-1,model=2,expert=2"]
BAD_SPECS = ["data", "data=2,bogus=4", "data=x", "data=-1,seq=-1",
             "data=3", "data=2,model=2"]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_meshspec_parse_and_resolve_match_jax(spec):
    """The same sizes, or the same error text, at 8 devices."""
    def port():
        return tmesh.MeshSpec.from_string(spec).resolve(8)

    def ref():
        return jmesh.MeshSpec.from_string(spec).resolve(8)

    assert _outcome(port) == _outcome(ref)


def test_axes_and_env_grammar(monkeypatch):
    assert tmesh.AXES == jmesh.AXES
    for name in ("DATA_AXIS", "FSDP_AXIS", "PIPE_AXIS", "SEQ_AXIS",
                 "MODEL_AXIS", "EXPERT_AXIS"):
        assert getattr(tmesh, name) == getattr(jmesh, name)
    monkeypatch.setenv("HVT_MESH", "data=2,expert=4")
    assert tmesh.MeshSpec.from_env() == tmesh.MeshSpec(data=2, expert=4)
    monkeypatch.setenv("HVT_MESH", "")
    assert tmesh.MeshSpec.from_env() == tmesh.MeshSpec()


def test_mesh_order_knob_checked_as_in_jax(monkeypatch):
    monkeypatch.setenv("HVT_MESH_ORDER", "torus")
    with pytest.raises(ValueError) as port:
        tmesh.build_mesh(tmesh.MeshSpec(), n_ranks=8, rank=0)
    with pytest.raises(ValueError) as ref:
        jmesh.build_mesh(jmesh.MeshSpec(), jax.devices("cpu"))
    assert str(port.value) == str(ref.value)
    monkeypatch.setenv("HVT_MESH_ORDER", "flat")
    assert tmesh.build_mesh(tmesh.MeshSpec(data=2, expert=4), n_ranks=8,
                            rank=5).coords["expert"] == 1


@pytest.mark.parametrize("spec", SPECS[1:])
def test_rank_coordinates_match_jax_device_ids(spec):
    """Rank r sits where JAX's mesh holds device id r: the flat row-major
    layout, ``expert`` innermost."""
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        tm = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                              rank=r)
        assert tm.layout_only
        where = tuple(int(i[0]) for i in np.nonzero(ids == r))
        assert tuple(tm.coords[ax] for ax in tmesh.AXES) == where
        assert dict(tm.shape) == dict(jm.shape)
        assert tmesh.dp_size(tm) == jmesh.dp_size(jm)
        assert tmesh.has_live_model_axes(tm) == jmesh.has_live_model_axes(jm)
        assert tm.data_shards == jmesh.dp_size(jm)
        assert tm.data_index == (tm.coords["data"] * tm.shape["fsdp"]
                                 + tm.coords["fsdp"])


@pytest.mark.parametrize("spec", ["data=2,expert=4", "data=2,seq=2,expert=2",
                                  "data=2,fsdp=2,model=2"])
def test_axis_groups_are_jax_mesh_slices(spec):
    """Each axis's rank lists are the device-id lines of JAX's mesh along
    that axis; the batch group is the (data, fsdp) slab."""
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    shape = tmesh.MeshSpec.from_string(spec).resolve(8)
    for ax in tmesh.AXES:
        i = tmesh.AXES.index(ax)
        want = np.moveaxis(ids, i, -1).reshape(-1, shape[ax])
        assert tmesh.axis_rank_lists(shape, ax) == want.tolist()
    slab = np.moveaxis(ids, [0, 1], [-2, -1]).reshape(
        -1, shape["data"] * shape["fsdp"])
    assert tmesh.axis_rank_lists(shape, ("data", "fsdp")) == slab.tolist()


def test_layout_mesh_has_no_groups():
    tm = tmesh.build_mesh(tmesh.MeshSpec(data=2, expert=4), n_ranks=8,
                          rank=3)
    with pytest.raises(RuntimeError, match="another world"):
        tm.group("expert")
    # Size-1 axes need no group.
    from horovod_tpu_torch.parallel import collectives

    assert tm.group("seq") is collectives.SELF
    one = tmesh.data_parallel_mesh()
    assert not one.layout_only and one.batch_group is None
    assert tmesh.dp_size() == 1 and tmesh.dp_size(one) == 1


# -- param_specs -----------------------------------------------------------------

VOCAB, D, HEADS = 32, 16, 4


def _flax_path(name: str) -> tuple:
    """The flax params path of a `TransformerLM` state-dict name."""
    parts = name.split(".")
    top = {"embed.weight": ("Embed_0", "embedding"),
           "ln_f.scale": ("LayerNorm_0", "scale"),
           "lm_head.weight": ("lm_head", "kernel")}
    if name in top:
        return top[name]
    blk = f"Block_{parts[1]}"
    rest = parts[2:]
    if rest[0] in ("ln_attn", "ln_mlp"):
        return (blk, {"ln_attn": "LayerNorm_0",
                      "ln_mlp": "LayerNorm_1"}[rest[0]], "scale")
    if rest[0] == "moe":
        return ((blk, "moe", "router", "kernel") if rest[1] == "router"
                else (blk, "moe", rest[1]))
    return (blk, rest[0], "kernel")


def _port_dim(name: str, flax_dim: int, flax_ndim: int) -> int:
    """Where a flax kernel dim sits in the port's tensor: expert weights
    and 1-D leaves as they are; an `nn.Linear` weight is [out, in], so a
    flax output-side dim is the port's dim 0 and the input side dim 1."""
    if ".moe.moe_" in name or flax_ndim == 1:
        return flax_dim
    if name.endswith("attn_out.weight"):  # flax [H, hd, d]: heads are input
        return 1
    if name == "embed.weight":
        return flax_dim
    return 0 if flax_dim >= 1 else 1


def _models(**kw):
    cfg = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=2,
               dropout=0.0, **kw)
    jm = jtr.TransformerLM(**cfg)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    return params, ttr.TransformerLM(**cfg, device="cpu")


@pytest.mark.parametrize("spec", ["data=2,expert=4", "data=2,expert=2,model=2",
                                  "data=2,fsdp=2,model=2", "data=8"])
@pytest.mark.parametrize("kind", ["dense", "moe", "gqa"])
def test_param_specs_match_jax(spec, kind):
    kw = {"dense": {}, "gqa": {"n_kv_heads": 2},
          "moe": {"moe_every": 2, "n_experts": 4}}[kind]
    params, tm = _models(**kw)
    jm = jmesh.build_mesh(jmesh.MeshSpec.from_string(spec),
                          jax.devices("cpu"))
    tmsh = tmesh.build_mesh(tmesh.MeshSpec.from_string(spec), n_ranks=8,
                            rank=0)
    want = jtr.param_specs(params, jm)
    got = ttr.param_specs(tm, tmsh)
    assert got == ttr.param_specs(tm.state_dict(), tmsh)
    assert len(got) == len(jax.tree.leaves(params))
    for name, placement in got.items():
        path = _flax_path(name)
        jspec = want
        for key in path:
            jspec = jspec[key]
        leaf = params
        for key in path:
            leaf = leaf[key]
        jaxes = {ax: d for d, ax in enumerate(tuple(jspec)) if ax is not None}
        assert set(placement.values()) == set(jaxes), (name, placement, jspec)
        for ax, d in jaxes.items():
            if ax == "fsdp":
                continue  # first divisible free dim, in each layout's order
            assert placement[_port_dim(name, d, np.ndim(leaf))] == ax, name


def test_param_specs_divisibility_error_matches_jax():
    params, tm = _models(moe_every=2, n_experts=6)
    spec = "data=2,expert=4"
    with pytest.raises(ValueError) as port:
        ttr.param_specs(tm, tmesh.build_mesh(
            tmesh.MeshSpec.from_string(spec), n_ranks=8, rank=0))
    with pytest.raises(ValueError) as ref:
        jtr.param_specs(params, jmesh.build_mesh(
            jmesh.MeshSpec.from_string(spec), jax.devices("cpu")))
    assert str(port.value) == str(ref.value)
