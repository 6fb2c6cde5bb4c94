"""flax variables ⇄ `TransformerLM` / `MnistCNN` / `ResNetCIFAR` / `ViT`
state_dicts.

The input of `params_from_flax` is the JAX model's ``params`` tree as
nested dicts of numpy arrays (``jax.device_get`` of it) — this module
reads plain arrays and imports nothing of JAX. Leaf layouts on the flax
side:

* ``Block_i/qkv/kernel [d, H, 3D]`` — split PER HEAD along the last axis:
  q, k, v = ``[..., :D]``, ``[..., D:2D]``, ``[..., 2D:]``;
* ``Block_i/q_proj/kernel [d, H, D]``, ``Block_i/kv_proj/kernel
  [d, H_kv, 2D]`` (k = ``[..., :D]``, v = ``[..., D:]``) under GQA;
* ``Block_i/attn_out/kernel [H, D, d]``, ``mlp_up [d, 4d]``,
  ``mlp_down [4d, d]``, ``lm_head/kernel [d, vocab]``,
  ``Embed_0/embedding [vocab, d]``, ``LayerNorm_*/scale [d]``;
* an MoE block's ``Block_i/moe/{router/kernel [d, E], moe_up [E, d, 4d],
  moe_down [E, 4d, d]}`` in place of ``mlp_up``/``mlp_down`` — the port's
  ``blocks.i.moe.router.weight [E, d]`` (transposed) and ``moe_up``/
  ``moe_down`` as they are.

`shard_state_dict` cuts a full state dict to one rank's placements
(`models.transformer.param_specs` on a `parallel.mesh.Mesh`) and
`gather_state_dict` gathers them back.

The torch side keeps `nn.Linear`'s ``[out, in]`` weights. `params_to_flax`
is the exact inverse (pure reshapes and transposes). `ema_from_flax`
carries a JAX EMA shadow across: the params conversion applied to the
shadow tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _heads_to_linear(kernel) -> np.ndarray:
    """``[d, H, D]`` → ``[H*D, d]``."""
    kernel = np.asarray(kernel)
    return kernel.reshape(kernel.shape[0], -1).T


def params_from_flax(tree) -> dict:
    """flax ``params`` tree → `TransformerLM` state_dict (f32 tensors)."""
    return _lm_from_flax(tree, _t)


def _lm_from_flax(tree, _t) -> dict:
    """The `TransformerLM` layout of a flax ``params``-shaped tree, each
    leaf through ``_t`` (numpy → tensor)."""
    sd = {
        "embed.weight": _t(tree["Embed_0"]["embedding"]),
        "ln_f.scale": _t(tree["LayerNorm_0"]["scale"]),
        "lm_head.weight": _t(np.asarray(tree["lm_head"]["kernel"]).T),
    }
    n_layers = sum(1 for k in tree if k.startswith("Block_"))
    for i in range(n_layers):
        blk = tree[f"Block_{i}"]
        pre = f"blocks.{i}."
        if "qkv" in blk:
            qkv = np.asarray(blk["qkv"]["kernel"])
            d = qkv.shape[-1] // 3
            sd[pre + "qkv.weight"] = _t(np.concatenate([
                _heads_to_linear(qkv[..., j * d:(j + 1) * d]) for j in range(3)
            ]))
        else:
            kv = np.asarray(blk["kv_proj"]["kernel"])
            d = kv.shape[-1] // 2
            sd[pre + "q_proj.weight"] = _t(
                _heads_to_linear(blk["q_proj"]["kernel"])
            )
            sd[pre + "kv_proj.weight"] = _t(np.concatenate(
                [_heads_to_linear(kv[..., :d]), _heads_to_linear(kv[..., d:])]
            ))
        attn_out = np.asarray(blk["attn_out"]["kernel"])
        sd[pre + "attn_out.weight"] = _t(
            attn_out.reshape(-1, attn_out.shape[-1]).T
        )
        sd[pre + "ln_attn.scale"] = _t(blk["LayerNorm_0"]["scale"])
        sd[pre + "ln_mlp.scale"] = _t(blk["LayerNorm_1"]["scale"])
        if "moe" in blk:
            moe = blk["moe"]
            sd[pre + "moe.router.weight"] = _t(
                np.asarray(moe["router"]["kernel"]).T)
            sd[pre + "moe.moe_up"] = _t(moe["moe_up"])
            sd[pre + "moe.moe_down"] = _t(moe["moe_down"])
            continue
        sd[pre + "mlp_up.weight"] = _t(np.asarray(blk["mlp_up"]["kernel"]).T)
        sd[pre + "mlp_down.weight"] = _t(
            np.asarray(blk["mlp_down"]["kernel"]).T
        )
    return sd


def qparams_from_flax(qtree) -> dict:
    """The JAX package's `quantize_params` tree (``{"int8_q", "scale"}``
    leaves and passthrough arrays, as numpy) → the port's
    `quant.quantize_params` tree: the int8 values through the same
    layout as `params_from_flax` (dtype kept), the scales with them
    (attn_out's ``[1, D, d]`` becomes ``[d, 1, D]``, the grouping
    `quant.dequantize_params` expects)."""

    def split(tree, key):
        if isinstance(tree, dict) and "int8_q" in tree:
            return np.asarray(tree[key])
        if isinstance(tree, dict):
            return {k: split(v, key) for k, v in tree.items()}
        a = np.asarray(tree)
        return a if key == "int8_q" else np.zeros((1,) + a.shape[1:], a.dtype)

    def keep(a):
        return torch.from_numpy(np.array(a))

    values = _lm_from_flax(split(qtree, "int8_q"), keep)
    scales = _lm_from_flax(split(qtree, "scale"), keep)
    out = {}
    for name, v in values.items():
        if v.dtype != torch.int8:
            out[name] = v.float()
            continue
        sc = scales[name].float()
        if name.endswith("attn_out.weight"):  # [d, D] -> [d, 1, D]
            sc = sc.reshape(sc.shape[0], 1, -1)
        out[name] = {"int8_q": v, "scale": sc.contiguous()}
    return out


def _linear_to_heads(weight, n_heads: int) -> np.ndarray:
    """``[H*D, d]`` → ``[d, H, D]``."""
    w = weight.T
    return w.reshape(w.shape[0], n_heads, -1)


def params_to_flax(state_dict, *, n_heads: int) -> dict:
    """`TransformerLM` state_dict → flax ``params`` tree of f32 numpy
    arrays; the exact inverse of `params_from_flax`. ``n_heads`` is the
    query head count (the state_dict's fused shapes do not carry it)."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    tree = {
        "Embed_0": {"embedding": sd["embed.weight"]},
        "LayerNorm_0": {"scale": sd["ln_f.scale"]},
        "lm_head": {"kernel": np.ascontiguousarray(sd["lm_head.weight"].T)},
    }
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    d_model = sd["embed.weight"].shape[1]
    head_dim = d_model // n_heads
    for i in range(n_layers):
        pre = f"blocks.{i}."
        blk = {}
        if pre + "qkv.weight" in sd:
            q, k, v = np.split(sd[pre + "qkv.weight"], 3)
            blk["qkv"] = {"kernel": np.ascontiguousarray(np.concatenate(
                [_linear_to_heads(x, n_heads) for x in (q, k, v)], axis=-1
            ))}
        else:
            kw, vw = np.split(sd[pre + "kv_proj.weight"], 2)
            h_kv = kw.shape[0] // head_dim
            blk["q_proj"] = {"kernel": np.ascontiguousarray(
                _linear_to_heads(sd[pre + "q_proj.weight"], n_heads)
            )}
            blk["kv_proj"] = {"kernel": np.ascontiguousarray(np.concatenate(
                [_linear_to_heads(kw, h_kv), _linear_to_heads(vw, h_kv)],
                axis=-1,
            ))}
        blk["attn_out"] = {"kernel": np.ascontiguousarray(
            sd[pre + "attn_out.weight"].T.reshape(n_heads, head_dim, d_model)
        )}
        blk["LayerNorm_0"] = {"scale": sd[pre + "ln_attn.scale"]}
        blk["LayerNorm_1"] = {"scale": sd[pre + "ln_mlp.scale"]}
        if pre + "moe.moe_up" in sd:
            blk["moe"] = {
                "router": {"kernel": np.ascontiguousarray(
                    sd[pre + "moe.router.weight"].T)},
                "moe_up": sd[pre + "moe.moe_up"],
                "moe_down": sd[pre + "moe.moe_down"],
            }
        else:
            blk["mlp_up"] = {
                "kernel": np.ascontiguousarray(sd[pre + "mlp_up.weight"].T)}
            blk["mlp_down"] = {
                "kernel": np.ascontiguousarray(sd[pre + "mlp_down.weight"].T)
            }
        tree[f"Block_{i}"] = blk
    return tree


def _live(mesh, specs) -> dict:
    return {name: {d: ax for d, ax in spec.items() if mesh.shape[ax] > 1}
            for name, spec in specs.items()}


def shard_state_dict(state_dict, mesh, specs) -> dict:
    """This rank's part of a full state dict: each tensor cut along every
    placement of ``specs`` (`models.transformer.param_specs`) on a live
    axis of ``mesh``, at this rank's coordinate there; the rest as it
    is."""
    out = {}
    for name, t in state_dict.items():
        for dim, ax in _live(mesh, specs).get(name, {}).items():
            per = t.shape[dim] // mesh.shape[ax]
            t = t.narrow(dim, per * mesh.coords[ax], per)
        out[name] = t
    return out


def gather_state_dict(state_dict, mesh, specs) -> dict:
    """Inverse of `shard_state_dict`: every sharded tensor all-gathered
    over its axis's subgroup (a collective of that group; every rank of
    the mesh calls it at one point)."""
    from horovod_tpu_torch.parallel import collectives

    out = {}
    for name, t in state_dict.items():
        for dim, ax in sorted(_live(mesh, specs).get(name, {}).items(),
                              reverse=True):
            parts = collectives.all_gather_tensor(t.detach(),
                                                  mesh.group(ax))
            t = torch.cat(list(parts), dim=dim)
        out[name] = t
    return out


# -- MnistCNN -----------------------------------------------------------------
#
# flax side: ``Conv_0``/``Conv_1`` kernels HWIO ``[3, 3, in, out]``,
# ``Dense_0`` ``[9216, 128]`` over the NHWC flatten, ``Dense_1`` ``[128, 10]``;
# all with ``bias``. Torch side: conv weights OIHW, linear weights
# ``[out, in]``. `MnistCNN` flattens in NHWC order too, so Dense_0 needs no
# row permutation.

_CNN_LAYERS = (("Conv_0", "conv1"), ("Conv_1", "conv2"),
               ("Dense_0", "dense1"), ("Dense_1", "dense2"))


def cnn_params_from_flax(tree) -> dict:
    """flax ``MnistCNN`` params tree → `MnistCNN` state_dict (f32)."""
    sd = {}
    for flax_name, name in _CNN_LAYERS:
        kernel = np.asarray(tree[flax_name]["kernel"])
        perm = (3, 2, 0, 1) if kernel.ndim == 4 else (1, 0)
        sd[f"{name}.weight"] = _t(np.ascontiguousarray(kernel.transpose(perm)))
        sd[f"{name}.bias"] = _t(tree[flax_name]["bias"])
    return sd


def cnn_params_to_flax(state_dict) -> dict:
    """`MnistCNN` state_dict → flax params tree of f32 numpy arrays; the
    exact inverse of `cnn_params_from_flax`."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    tree = {}
    for flax_name, name in _CNN_LAYERS:
        w = sd[f"{name}.weight"]
        perm = (2, 3, 1, 0) if w.ndim == 4 else (1, 0)
        tree[flax_name] = {"kernel": np.ascontiguousarray(w.transpose(perm)),
                           "bias": sd[f"{name}.bias"]}
    return tree


# -- EMA shadows --------------------------------------------------------------


def ema_from_flax(payload, params_from=cnn_params_from_flax) -> dict:
    """A JAX ``ExponentialMovingAverage`` payload (``{"shadow": flax params
    tree, "count": n}``, the content of its ``ema.msgpack`` as numpy
    arrays) → the port's (``{"shadow": state_dict, "count": n}``, what
    `training.ema.save_payload` writes): ``params_from`` — the model's
    params conversion (`cnn_params_from_flax`, `params_from_flax`) —
    applied to the shadow tree."""
    return {"shadow": params_from(payload["shadow"]),
            "count": int(payload["count"])}


# -- ResNetCIFAR --------------------------------------------------------------
#
# flax side: ``params`` and ``batch_stats`` trees. Top level ``Conv_0``
# (HWIO kernel), ``BatchNorm_0`` (``scale``/``bias``; stats ``mean``/``var``),
# ``BasicBlock_i`` and ``Dense_0`` (``[64, classes]`` kernel, bias). Inside a
# block, in flax's creation order: ``Conv_0``, ``BatchNorm_0``, ``Conv_1``,
# ``BatchNorm_1`` and, where it projects, ``Conv_2``/``BatchNorm_2``. Torch
# side: `ResNetCIFAR`'s ``conv``, ``bn``, ``blocks.i.{conv1, bn1, conv2, bn2,
# proj_conv, proj_bn}``, ``fc``; OIHW conv weights, BN ``weight``/``bias``
# and buffers ``running_mean``/``running_var``.

_BLOCK_LAYERS = (("Conv_0", "conv1"), ("BatchNorm_0", "bn1"),
                 ("Conv_1", "conv2"), ("BatchNorm_1", "bn2"),
                 ("Conv_2", "proj_conv"), ("BatchNorm_2", "proj_bn"))


def _resnet_layers(flax_names):
    """``(flax path, torch prefix)`` of every conv and BN layer, given the
    top-level names of the flax params tree (which blocks exist)."""
    layers = [(("Conv_0",), "conv"), (("BatchNorm_0",), "bn")]
    n_blocks = sum(1 for k in flax_names if k.startswith("BasicBlock_"))
    for i in range(n_blocks):
        layers += [((f"BasicBlock_{i}", f), f"blocks.{i}.{t}")
                   for f, t in _BLOCK_LAYERS]
    return layers


def _get(tree, path):
    for key in path:
        if key not in tree:
            return None
        tree = tree[key]
    return tree


def _put(tree, path, leaf):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def resnet_from_flax(variables) -> dict:
    """flax ``ResNetCIFAR`` variables ``{"params", "batch_stats"}`` (numpy
    trees) → `ResNetCIFAR` state_dict (f32)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for path, pre in _resnet_layers(params):
        p = _get(params, path)
        if p is None:  # a block without a projection
            continue
        if "kernel" in p:
            sd[f"{pre}.weight"] = _t(np.ascontiguousarray(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
        else:
            s = _get(stats, path)
            sd.update({f"{pre}.weight": _t(p["scale"]),
                       f"{pre}.bias": _t(p["bias"]),
                       f"{pre}.running_mean": _t(s["mean"]),
                       f"{pre}.running_var": _t(s["var"])})
    sd["fc.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["fc.bias"] = _t(params["Dense_0"]["bias"])
    return sd


def resnet_to_flax(state_dict) -> dict:
    """`ResNetCIFAR` state_dict → ``{"params", "batch_stats"}`` trees of
    f32 numpy arrays; the exact inverse of `resnet_from_flax`."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    params: dict = {}
    stats: dict = {}
    for path, pre in _resnet_layers([f"BasicBlock_{i}"
                                     for i in range(n_blocks)]):
        if f"{pre}.weight" not in sd:
            continue
        if f"{pre}.running_mean" in sd:
            _put(params, path, {"scale": sd[f"{pre}.weight"],
                                "bias": sd[f"{pre}.bias"]})
            _put(stats, path, {"mean": sd[f"{pre}.running_mean"],
                               "var": sd[f"{pre}.running_var"]})
        else:
            _put(params, path, {"kernel": np.ascontiguousarray(
                sd[f"{pre}.weight"].transpose(2, 3, 1, 0))})
    params["Dense_0"] = {"kernel": np.ascontiguousarray(sd["fc.weight"].T),
                         "bias": sd["fc.bias"]}
    return {"params": params, "batch_stats": stats}


# -- ViT ----------------------------------------------------------------------
#
# flax side: ``embed`` (``[p·p·C, d]``), optional ``cls`` ``[1, 1, d]``,
# ``pos_embed`` ``[1, T, d]``, ``Block_i/{LayerNorm_0, qkv, attn_out,
# LayerNorm_1, mlp_up, mlp_down}`` — ``qkv`` a DenseGeneral with kernel
# ``[d, H, 3·hd]`` and bias ``[H, 3·hd]``, ``attn_out`` kernel ``[H, hd,
# d]`` — the final ``LayerNorm_0`` and ``head``. Torch side: `ViT`'s
# ``embed``, ``cls``, ``pos_embed``, ``blocks.i.{ln1, qkv, attn_out, ln2,
# mlp_up, mlp_down}``, ``ln_f``, ``head``; `nn.Linear` weights ``[out,
# in]``, the qkv rows in flax's (head, 3·hd) order — a pure reshape.

_VIT_BLOCK = (("LayerNorm_0", "ln1"), ("qkv", "qkv"),
              ("attn_out", "attn_out"), ("LayerNorm_1", "ln2"),
              ("mlp_up", "mlp_up"), ("mlp_down", "mlp_down"))


def _vit_layers(n_layers):
    """``(flax path, torch prefix)`` of every dense and LayerNorm layer."""
    layers = [(("embed",), "embed"), (("LayerNorm_0",), "ln_f"),
              (("head",), "head")]
    for i in range(n_layers):
        layers += [((f"Block_{i}", f), f"blocks.{i}.{t}") for f, t in _VIT_BLOCK]
    return layers


def vit_from_flax(tree) -> dict:
    """flax ``ViT`` params tree (numpy) → `ViT` state_dict (f32)."""
    sd = {"pos_embed": _t(tree["pos_embed"])}
    if "cls" in tree:
        sd["cls"] = _t(tree["cls"])
    n_layers = sum(1 for k in tree if k.startswith("Block_"))
    for path, pre in _vit_layers(n_layers):
        p = _get(tree, path)
        if "scale" in p:
            sd[f"{pre}.scale"] = _t(p["scale"])
        else:  # the kernel as [in, out]: attn_out contracts [H, hd]
            k = np.asarray(p["kernel"])
            k = (k.reshape(-1, k.shape[-1]) if pre.endswith("attn_out")
                 else k.reshape(k.shape[0], -1))
            sd[f"{pre}.weight"] = _t(np.ascontiguousarray(k.T))
        sd[f"{pre}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))
    return sd


def vit_to_flax(state_dict, *, n_heads: int) -> dict:
    """`ViT` state_dict → flax params tree of f32 numpy arrays; the exact
    inverse of `vit_from_flax`. ``n_heads`` restores the per-head axes."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    tree: dict = {"pos_embed": sd["pos_embed"]}
    if "cls" in sd:
        tree["cls"] = sd["cls"]
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    d = sd["embed.weight"].shape[0]
    for path, pre in _vit_layers(n_layers):
        bias = sd[f"{pre}.bias"]
        if f"{pre}.scale" in sd:
            leaf = {"scale": sd[f"{pre}.scale"], "bias": bias}
        else:
            w = np.ascontiguousarray(sd[f"{pre}.weight"].T)  # [in, out]
            if pre.endswith(".qkv"):
                w, bias = w.reshape(d, n_heads, -1), bias.reshape(n_heads, -1)
            elif pre.endswith(".attn_out"):
                w = w.reshape(n_heads, -1, d)
            leaf = {"kernel": w, "bias": bias}
        _put(tree, path, leaf)
    return tree
