"""LoRA — low-rank adapter fine-tuning (Hu et al., arXiv:2106.09685), port
of `horovod_tpu.models.lora`.

Every target kernel ``W`` gains adapters ``A [m, r]`` (gaussian, std
1/√r) and ``B [r, n]`` (zeros), and the model runs with ``W + (alpha/r)·
A@B``. Only A and B train: the optimizer's state covers them alone.

The adapter's geometry is the JAX package's, defined on the *flax kernel's*
shape: ``m = shape[0]``, ``n = prod(shape[1:])`` and the delta is ``(A@B)
.reshape(kernel.shape)``. For ``qkv`` ``[d, H, 3·D]`` the n columns are in
(head, q|k|v, D) order; for ``attn_out`` ``[H, D, d]`` m is H, so the delta
is rank r over an ``[H, D·d]`` matrix. The port's weights are ``[out,
in]`` with other row orders, so an adapter keeps JAX's A and B as they
are, and the merge lays ``scale · A@B`` onto the port's weight through the
converter's layout of that kernel (`convert.kernel_to_weight`; a model's
kernels are `convert.flax_kernels`). A rank-r delta on the port's own
``[out, in]`` would be another model for ``qkv`` and ``attn_out``.
`convert.lora_params_from_flax` carries JAX adapters across.

`LoRAModel` wraps any module: its parameters are ``base.<inner name>`` and
``lora.<inner name>.a`` / ``.b``. The forward runs the inner module on the
merged weights (`torch.func.functional_call`), so the inner module's
buffers update in place through the wrapper (JAX's ``inner_state`` carry:
BatchNorm statistics, say), keyword arguments (``train``, ``labels``,
``dropout_seed``, ``segment_ids``) pass through, and what its layers sow
(the MoE aux loss, ``moe_drop_rate``) reaches the Trainer as it does
without the wrapper. `merge_params` folds the adapters into a plain inner
state dict for decoding, export and serving with the original module.

On a mesh, as JAX's `param_specs` places them: the adapters skip the
Megatron and expert rules, so on a live ``model`` axis they stay whole on
every rank, and this rank's merged weight is ``W_part +
cut(enter_group(scale · A@B))``: the delta laid onto the whole weight,
cut as the inner model cuts that weight (`parallel.sharding`, fused rows
per head), behind Megatron's f, whose backward sums the adapters'
gradients over ``model`` as JAX's gradients of a replicated leaf are. On
a live ``fsdp`` axis the adapters are placed by JAX's ``fsdp`` rule on
their own shapes, gathered at use (`parallel.sharding.weight`), and the
delta is cut to the base's ``fsdp`` shard. An adapter on an expert stack
sharded over ``expert`` raises naming ROADMAP queue A item 17.

Freezing: `freeze_base(factory)` is an optimizer factory over the adapters
alone; the base parameters stop requiring gradients, so the backward
computes none and the reduction carries none. JAX computes and reduces the
base gradients and then zeroes the update; on the exact wires both compute
the same adapters. On an int8 or fp8 wire JAX's buckets hold the base's
gradients too, so its per-bucket scales would differ: that composition,
and ZeRO-1's, raise naming ROADMAP queue A item 17.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.parallel import collectives, sharding as shard_lib
from horovod_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS,
)

# Default target selection: 2-D+ kernels named like projection/matmul
# weights. Embeddings and norms stay frozen-only (the LoRA paper's recipe).
DEFAULT_TARGETS = (
    "qkv", "q_proj", "kv_proj", "attn_out", "mlp_up", "mlp_down", "lm_head",
)

#: The attribute `LoRAModel` sets on its adapter parameters; `freeze_base`
#: trains what carries it.
ADAPTER_TAG = "_hvt_lora_adapter"

_ITEM = "ROADMAP queue A item 17 (LoRA with quantized wires and ZeRO-1)"


def _match(targets, fk: convert.FlaxKernel, shape) -> bool:
    """JAX's rule: a kernel of two or more dims (in its flax shape) whose
    path names meet ``targets``; a callable ``targets(path, flax_shape)``
    decides for itself."""
    fshape = fk.flax_shape(shape)
    if callable(targets):
        return bool(targets(fk.path, fshape))
    return len(fshape) >= 2 and bool(set(fk.path) & set(targets))


def init_adapters(module, rank: int, targets=DEFAULT_TARGETS, *,
                  seed: int = 0, kernels: dict | None = None,
                  shapes: dict | None = None) -> dict:
    """``{param name: {"a": [m, r] ~ N(0, 1/r), "b": [r, n] = 0}}`` for the
    parameters of ``module`` its targets match (m, n from the flax
    kernel's shape; ``shapes``: each parameter's whole shape where the
    module holds a part), f32 on the module's device, drawn from a seeded
    CPU generator."""
    kernels = kernels or convert.flax_kernels(module)
    shapes = shapes or {}
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in module.named_parameters():
        fk = kernels[name]
        shape = shapes.get(name, p.shape)
        if not _match(targets, fk, shape):
            continue
        fshape = fk.flax_shape(shape)
        m, n = fshape[0], math.prod(fshape[1:])
        a = torch.randn((m, rank), generator=g) / math.sqrt(rank)
        out[name] = {"a": a.to(p.device),
                     "b": torch.zeros((rank, n), device=p.device)}
    return out


def merge_delta(base: dict, adapters: dict, scale: float, kernels: dict,
                shapes: dict, cut) -> dict:
    """``W + scale · A@B`` per adapted weight of the state dict ``base``
    (the delta in f32, laid onto the port's weight of the whole shape
    ``shapes[name]``, taken to the part ``base`` holds by ``cut(name,
    delta)``, cast to its dtype); the rest as they are."""
    out = dict(base)
    for name, ab in adapters.items():
        w, fk = base[name], kernels[name]
        delta = (ab["a"] @ ab["b"]).reshape(fk.flax_shape(shapes[name]))
        delta = cut(name, convert.kernel_to_weight(delta * scale, fk))
        out[name] = (w.float() + delta).to(w.dtype)
    return out


class _Adapter(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = nn.Parameter(a), nn.Parameter(b)
        self.tag()

    def tag(self) -> None:
        """Mark the adapter's parameters for `freeze_base` (again after a
        cut replaced them)."""
        for p in (self.a, self.b):
            setattr(p, ADAPTER_TAG, True)


class LoRAModel(nn.Module):
    """``inner`` with low-rank adapters on its target kernels (module
    docstring). ``rank``, ``alpha`` and ``targets`` as in JAX; ``seed``
    draws the A matrices."""

    def __init__(self, inner: nn.Module, rank: int = 8, alpha: float = 16.0,
                 targets=DEFAULT_TARGETS, *, seed: int = 0):
        super().__init__()
        from horovod_tpu_torch.models.transformer import (
            _full_shapes, cut_parameters, live_placements, param_specs,
        )

        self.base = inner
        self.rank, self.alpha, self.targets = int(rank), float(alpha), targets
        self.kernels = convert.flax_kernels(inner)
        self.mesh = getattr(getattr(inner, "sharding", None), "mesh", None)
        full = _full_shapes(inner)
        placed = ({} if self.mesh is None else live_placements(
            _inner_specs(inner)(inner, self.mesh), self.mesh))
        adapters = init_adapters(inner, self.rank, targets, seed=seed,
                                 kernels=self.kernels, shapes=full)
        for name in adapters:
            if EXPERT_AXIS in placed.get(name, {}).values():
                local = tuple(inner.get_parameter(name).shape)
                raise NotImplementedError(
                    f"a LoRA adapter on {name!r}, sharded over the mesh "
                    f"({local} of {full[name]}), is not ported — {_ITEM}")
        self.adapted = tuple(adapters)
        # The whole shapes of the adapted weights and their model/fsdp
        # cuts, which the merged deltas follow.
        self.weight_shapes = {n: full[n] for n in adapters}
        self.base_cuts = {n: {d: ax for d, ax in placed.get(n, {}).items()
                              if ax in (MODEL_AXIS, FSDP_AXIS)}
                          for n in adapters}
        self.lora = nn.Module()
        for name, ab in adapters.items():
            node = self.lora
            *owners, leaf = name.split(".")
            for part in owners:
                if part not in node._modules:
                    node.add_module(part, nn.Module())
                node = node._modules[part]
            node.add_module(leaf, _Adapter(ab["a"], ab["b"]))
        if self.mesh is not None and self.mesh.shape[FSDP_AXIS] > 1:
            # JAX's fsdp rule on the adapters' own shapes (the Megatron
            # and expert rules skip them).
            specs = {n: sp for n, sp in param_specs(self, self.mesh).items()
                     if n.startswith("lora.")}
            cut_parameters(self, specs, self.mesh)
            for ad in self.lora.modules():
                if isinstance(ad, _Adapter):
                    ad.tag()

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def adapters(self) -> dict:
        """``{param name: {"a", "b"}}`` — the adapter parameters (this
        rank's ``fsdp`` shards where the mesh cuts them)."""
        out = {}
        for name in self.adapted:
            ad = self.lora.get_submodule(name)
            out[name] = {"a": ad.a, "b": ad.b}
        return out

    def whole_adapters(self) -> dict:
        """`adapters`, each whole: gathered over ``fsdp`` at use, its
        gradient reduce-scattered back (`parallel.sharding.weight`)."""
        out = {}
        for name in self.adapted:
            ad = self.lora.get_submodule(name)
            out[name] = {k: shard_lib.weight(ad, k) for k in ("a", "b")}
        return out

    def _cut(self, name: str, delta):
        """The whole delta of weight ``name`` cut as the inner model holds
        the weight, behind Megatron's f where ``model`` cuts it."""
        spec = self.base_cuts[name]
        if MODEL_AXIS in spec.values():
            delta = collectives.enter_group(delta,
                                            self.mesh.group(MODEL_AXIS))
        return shard_lib.shard_tensor(delta, name, spec, self.mesh)

    def merged(self) -> dict:
        """The adapted weights ``W + scale·A@B`` (differentiable in A and
        B), by inner parameter name: this rank's parts of them on a
        mesh."""
        base = {n: self.base.get_parameter(n) for n in self.adapted}
        return merge_delta(base, self.whole_adapters(), self.scale,
                           self.kernels, self.weight_shapes, self._cut)

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.base, self.merged(), args,
                                          kwargs)

    def unsharded(self) -> "LoRAModel":
        """This model without a mesh, holding its whole base and adapters
        (gathered: a collective every rank of the mesh calls), for export
        and one-rank decoding."""
        plain = LoRAModel(self.base.unsharded(), self.rank, self.alpha,
                          self.targets)
        with torch.no_grad():
            for name, ab in self.whole_adapters().items():
                for leaf, t in ab.items():
                    getattr(plain.lora.get_submodule(name), leaf).copy_(t)
        return plain


def _inner_specs(inner):
    """The placement rules of ``inner``'s family (`param_specs`)."""
    from horovod_tpu_torch.models import seq2seq, transformer

    if isinstance(inner, seq2seq.Seq2SeqTransformer):
        return seq2seq.param_specs
    return transformer.param_specs


def merge_params(model: LoRAModel, *, scale: float | None = None) -> dict:
    """Fold ``model``'s adapters into a plain state dict of its inner
    module (for decoding, export and serving with the original module;
    on a mesh this rank's parts, the adapters gathered over ``fsdp``: a
    collective). ``scale`` defaults to the model's own ``alpha / rank``."""
    if scale is None:
        scale = model.scale
    with torch.no_grad():
        base = {k: v.detach() for k, v in model.base.state_dict().items()}
        adapters = {n: {k: v.detach() for k, v in ab.items()}
                    for n, ab in model.whole_adapters().items()}
        return merge_delta(base, adapters, scale, model.kernels,
                           model.weight_shapes, model._cut)


class _FrozenBase:
    """An optimizer factory over the adapters among the parameters it is
    given; the others stop requiring gradients."""

    def __init__(self, factory):
        self.factory = factory

    def __call__(self, params):
        params = list(params)
        train = [p for p in params if getattr(p, ADAPTER_TAG, False)]
        if not train:
            raise ValueError(
                "freeze_base: no LoRA adapter among the parameters — wrap "
                "the model in LoRAModel")
        for p in params:
            if not getattr(p, ADAPTER_TAG, False):
                p.requires_grad_(False)
        return self.factory(train)

    @staticmethod
    def check_reduction(quantized: bool, zero1: bool) -> None:
        """`DistributedOptimizer.bind`'s check of the gradient reduction
        this factory's optimizer is given."""
        if quantized or zero1:
            raise NotImplementedError(
                "freeze_base (LoRA) with "
                + ("an int8/fp8 wire" if quantized
                   else "ZeRO-1 (shard_update)")
                + " is not ported: JAX's buckets and shards hold the frozen "
                "base's gradients too, where the port reduces the adapters "
                f"alone — {_ITEM}")


def freeze_base(factory) -> _FrozenBase:
    """``factory`` (an optimizer factory such as `training.optimizer.adamw`)
    on the adapters alone: the optimizer carries state only for them and
    the base gets no update and no gradient. Wrap the result in
    `DistributedOptimizer` (gradient averaging is orthogonal); with an
    int8/fp8 wire or ZeRO-1 it raises naming ROADMAP queue A item 17."""
    return _FrozenBase(factory)
