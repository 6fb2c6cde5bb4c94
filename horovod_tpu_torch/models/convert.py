"""flax variables ⇄ `TransformerLM` / `MnistCNN` / `ResNetCIFAR` / `ViT` /
`Seq2SeqTransformer` / `LoRAModel` state_dicts.

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
(`models.transformer.param_specs` on a `parallel.mesh.Mesh`; the fused
``qkv``/``kv_proj`` rows per part by heads, `parallel.sharding`) and
`gather_state_dict` gathers them back; `params_from_flax` of a tree and
`shard_state_dict` of the result give a rank its shard, and
`params_to_flax` takes the gathered state.

The torch side keeps `nn.Linear`'s ``[out, in]`` weights. `params_to_flax`
is the exact inverse (pure reshapes and transposes). `ema_from_flax`
carries a JAX EMA shadow across: the params conversion applied to the
shadow tree.

`kernel_to_weight` / `weight_to_kernel` are those layouts one kernel at a
time (`FlaxKernel` names a kernel's path and kind; `flax_kernels` lists a
model's), on arrays and tensors alike: the LM and seq2seq converters are
built on them, and a LoRA merge lays a delta shaped like the flax kernel
onto the port's weight through them. `lora_params_from_flax` carries a JAX
``LoRAModel`` tree (base and adapters) across.
"""

from __future__ import annotations

import typing

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def params_from_flax(tree) -> dict:
    """flax ``params`` tree → `TransformerLM` state_dict (f32 tensors)."""
    return _lm_from_flax(tree, _t)


def _lm_from_flax(tree, _t) -> dict:
    """The `TransformerLM` layout (`lm_kernels`) of a flax
    ``params``-shaped tree, each leaf through ``_t`` (numpy → tensor)."""
    blocks = [tree[f"Block_{i}"]
              for i in range(sum(1 for k in tree if k.startswith("Block_")))]
    if blocks and "qkv" in blocks[0]:
        h = h_kv = np.shape(blocks[0]["qkv"]["kernel"])[1]
    else:
        h = np.shape(blocks[0]["q_proj"]["kernel"])[1] if blocks else 1
        h_kv = np.shape(blocks[0]["kv_proj"]["kernel"])[1] if blocks else 1
    layout = _lm_layout(h, h_kv, ["moe" in blk for blk in blocks])
    return {name: _t(kernel_to_weight(np.asarray(_tree_get(tree, fk.path)),
                                      fk))
            for name, fk in layout.items()}


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


def params_to_flax(state_dict, *, n_heads: int) -> dict:
    """`TransformerLM` state_dict → flax ``params`` tree of f32 numpy
    arrays; the exact inverse of `params_from_flax`. ``n_heads`` is the
    query head count (the state_dict's fused shapes do not carry it)."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    n_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    h_kv = n_heads
    if "blocks.0.kv_proj.weight" in sd:
        head_dim = sd["embed.weight"].shape[1] // n_heads
        h_kv = sd["blocks.0.kv_proj.weight"].shape[0] // (2 * head_dim)
    layout = _lm_layout(n_heads, h_kv, [f"blocks.{i}.moe.moe_up" in sd
                                        for i in range(n_layers)])
    tree: dict = {}
    for name, fk in layout.items():
        _put(tree, fk.path,
             np.ascontiguousarray(weight_to_kernel(sd[name], fk)))
    return tree


def shard_state_dict(state_dict, mesh, specs) -> dict:
    """This rank's part of a full state dict: each tensor cut along every
    placement of ``specs`` (`models.transformer.param_specs`) on a live
    axis of ``mesh``, at this rank's coordinate there, ``qkv``/``kv_proj``
    per part by heads on ``model`` (`parallel.sharding.shard_tensor`); the
    rest as it is."""
    from horovod_tpu_torch.parallel import sharding

    return {name: sharding.shard_tensor(t, name, specs.get(name, {}), mesh)
            for name, t in state_dict.items()}


def gather_state_dict(state_dict, mesh, specs) -> dict:
    """Inverse of `shard_state_dict`: every sharded tensor all-gathered
    over its axis's subgroup (`parallel.sharding.gather_tensor`; a
    collective of that group, every rank of the mesh calls it at one
    point)."""
    from horovod_tpu_torch.parallel import sharding

    return {name: sharding.gather_tensor(t, name, specs.get(name, {}), mesh)
            for name, t in state_dict.items()}


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


# -- one flax kernel <-> one port weight ---------------------------------------
#
# The layouts of the converters above, one kernel at a time, on numpy arrays
# and on tensors alike (a LoRA merge lays a delta shaped like the flax kernel
# onto the port's weight inside the forward, with autograd). ``kind``:
#
# * ``heads_in``  ``[d, H, parts·D]`` → ``[parts·H·D, d]``: the kernel split
#   per head into ``parts`` (qkv: q | k | v; kv_proj, cross_kv: k | v), each
#   part's heads in order, one part after another;
# * ``heads_out`` ``[H, D, d]`` → ``[d, H·D]`` (attn_out, cross_out);
# * ``dense``     ``[in, out]`` → ``[out, in]`` (MLP, LM head, router);
# * ``same``      as it is (embeddings, scales, expert weights).


class FlaxKernel(typing.NamedTuple):
    """Where one port weight lives in the flax tree: ``path`` (the dict
    keys down to the leaf), ``kind`` and ``parts`` (above), ``heads``
    (the head count of a ``heads_*`` kernel)."""

    path: tuple
    kind: str = "same"
    parts: int = 1
    heads: int = 1

    def flax_shape(self, weight_shape) -> tuple:
        """The flax kernel's shape, from the port weight's."""
        out, inp = (tuple(weight_shape) + (0,))[:2]
        if self.kind == "heads_in":
            return (inp, self.heads, out // self.heads)
        if self.kind == "heads_out":
            return (self.heads, inp // self.heads, out)
        if self.kind == "dense":
            return tuple(reversed(weight_shape))
        return tuple(weight_shape)


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def kernel_to_weight(kernel, fk: FlaxKernel):
    """A flax kernel (array or tensor) in the port's weight layout."""
    if fk.kind == "heads_in":
        d = kernel.shape[-1] // fk.parts
        return _cat([kernel[..., j * d:(j + 1) * d]
                     .reshape(kernel.shape[0], -1).T
                     for j in range(fk.parts)])
    if fk.kind == "heads_out":
        return kernel.reshape(-1, kernel.shape[-1]).T
    if fk.kind == "dense":
        return kernel.T
    return kernel


def weight_to_kernel(weight, fk: FlaxKernel):
    """Inverse of `kernel_to_weight`."""
    shape = fk.flax_shape(weight.shape)
    if fk.kind == "heads_in":
        rows = weight.shape[0] // fk.parts
        blocks = [weight[j * rows:(j + 1) * rows].T.reshape(
            shape[0], fk.heads, -1) for j in range(fk.parts)]
        if isinstance(weight, torch.Tensor):
            return torch.cat(blocks, dim=-1)
        return np.concatenate(blocks, axis=-1)
    if fk.kind == "heads_out":
        return weight.T.reshape(shape)
    if fk.kind == "dense":
        return weight.T
    return weight


def lm_kernels(model) -> dict:
    """Port parameter name → `FlaxKernel` of a `TransformerLM`: the layout
    `params_from_flax` and `params_to_flax` apply."""
    return _lm_layout(model.n_heads, model.n_kv_heads or model.n_heads,
                      [blk.use_moe for blk in model.blocks])


def _lm_layout(h: int, h_kv: int, moe) -> dict:
    """`lm_kernels` of an LM of ``h`` query and ``h_kv`` key/value heads
    whose block i is an MoE block where ``moe[i]``."""
    out = {"embed.weight": FlaxKernel(("Embed_0", "embedding")),
           "ln_f.scale": FlaxKernel(("LayerNorm_0", "scale")),
           "lm_head.weight": FlaxKernel(("lm_head", "kernel"), "dense")}
    for i, use_moe in enumerate(moe):
        b, pre = f"Block_{i}", f"blocks.{i}."
        out[pre + "ln_attn.scale"] = FlaxKernel((b, "LayerNorm_0", "scale"))
        out[pre + "ln_mlp.scale"] = FlaxKernel((b, "LayerNorm_1", "scale"))
        if h_kv == h:
            out[pre + "qkv.weight"] = FlaxKernel((b, "qkv", "kernel"),
                                                 "heads_in", 3, h)
        else:
            out[pre + "q_proj.weight"] = FlaxKernel(
                (b, "q_proj", "kernel"), "heads_in", 1, h)
            out[pre + "kv_proj.weight"] = FlaxKernel(
                (b, "kv_proj", "kernel"), "heads_in", 2, h_kv)
        out[pre + "attn_out.weight"] = FlaxKernel(
            (b, "attn_out", "kernel"), "heads_out", 1, h)
        if use_moe:
            out[pre + "moe.router.weight"] = FlaxKernel(
                (b, "moe", "router", "kernel"), "dense")
            out[pre + "moe.moe_up"] = FlaxKernel((b, "moe", "moe_up"))
            out[pre + "moe.moe_down"] = FlaxKernel((b, "moe", "moe_down"))
        else:
            for layer in ("mlp_up", "mlp_down"):
                out[pre + layer + ".weight"] = FlaxKernel(
                    (b, layer, "kernel"), "dense")
    return out


def seq2seq_kernels(model) -> dict:
    """Port parameter name → `FlaxKernel` of a `Seq2SeqTransformer`: the
    flax tree's ``encoder``/``decoder``, each with ``embed``, ``Block_i``
    and a final ``LayerNorm_0``, and the decoder's ``lm_head``; a decoder
    block's LayerNorms are ``LayerNorm_0..2`` in call order."""
    h = model.n_heads
    out = {}
    for part, n, norms in (
            ("encoder", model.n_enc_layers, ("ln_attn", "ln_mlp")),
            ("decoder", model.n_dec_layers,
             ("ln_self", "ln_cross", "ln_mlp"))):
        out[f"{part}.embed.weight"] = FlaxKernel((part, "embed",
                                                  "embedding"))
        out[f"{part}.ln_f.scale"] = FlaxKernel((part, "LayerNorm_0",
                                                "scale"))
        for i in range(n):
            b, pre = (part, f"Block_{i}"), f"{part}.blocks.{i}."
            for j, ln in enumerate(norms):
                out[pre + ln + ".scale"] = FlaxKernel(
                    b + (f"LayerNorm_{j}", "scale"))
            out[pre + "qkv.weight"] = FlaxKernel(b + ("qkv", "kernel"),
                                                 "heads_in", 3, h)
            out[pre + "attn_out.weight"] = FlaxKernel(
                b + ("attn_out", "kernel"), "heads_out", 1, h)
            for layer in ("mlp_up", "mlp_down"):
                out[pre + layer + ".weight"] = FlaxKernel(
                    b + (layer, "kernel"), "dense")
            if part == "decoder":
                out[pre + "cross_q.weight"] = FlaxKernel(
                    b + ("cross_q", "kernel"), "heads_in", 1, h)
                out[pre + "cross_kv.weight"] = FlaxKernel(
                    b + ("cross_kv", "kernel"), "heads_in", 2, h)
                out[pre + "cross_out.weight"] = FlaxKernel(
                    b + ("cross_out", "kernel"), "heads_out", 1, h)
    out["decoder.lm_head.weight"] = FlaxKernel(
        ("decoder", "lm_head", "kernel"), "dense")
    return out


def flax_kernels(module) -> dict:
    """Port parameter name → `FlaxKernel` for a `TransformerLM`, a
    `Seq2SeqTransformer`, or any other module, whose parameters are taken
    as their own kernels (``same``, the path their dotted name)."""
    from horovod_tpu_torch.models.seq2seq import Seq2SeqTransformer
    from horovod_tpu_torch.models.transformer import TransformerLM

    if isinstance(module, TransformerLM):
        return lm_kernels(module)
    if isinstance(module, Seq2SeqTransformer):
        return seq2seq_kernels(module)
    return {name: FlaxKernel(tuple(name.split(".")))
            for name, _ in module.named_parameters()}


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def seq2seq_params_from_flax(tree, model) -> dict:
    """flax ``Seq2SeqTransformer`` params tree (numpy) → the state_dict of
    ``model`` (a `Seq2SeqTransformer` of the same configuration), f32."""
    return {name: _t(np.ascontiguousarray(kernel_to_weight(
        np.asarray(_tree_get(tree, fk.path)), fk)))
        for name, fk in seq2seq_kernels(model).items()}


def seq2seq_params_to_flax(state_dict, model) -> dict:
    """The exact inverse of `seq2seq_params_from_flax`: f32 numpy arrays."""
    tree: dict = {}
    for name, fk in seq2seq_kernels(model).items():
        w = state_dict[name].detach().cpu().float().numpy()
        _put(tree, fk.path, np.ascontiguousarray(weight_to_kernel(w, fk)))
    return tree


def lora_params_from_flax(tree, model) -> dict:
    """A JAX ``LoRAModel`` params tree ``{"base", "lora"}`` (numpy) → the
    state_dict of ``model`` (a port `models.lora.LoRAModel` of the same
    configuration): each base weight through its kernel's layout
    (``model.kernels``), each adapter's ``a [m, r]`` and ``b [r, n]`` as
    they are, found at its kernel's flax path."""
    sd = {}
    for name, fk in model.kernels.items():
        sd[f"base.{name}"] = _t(kernel_to_weight(
            np.asarray(_tree_get(tree["base"], fk.path)), fk))
        if name in model.adapted:
            ab = _tree_get(tree["lora"], fk.path)
            for leaf in ("a", "b"):
                sd[f"lora.{name}.{leaf}"] = _t(ab[leaf])
    return sd
