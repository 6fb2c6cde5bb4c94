"""DistributedOptimizer — gradient-averaging wrap of a torch optimizer;
port of `horovod_tpu.training.optimizer` and of the JAX trainer's explicit
boundary reduction.

After the backward, each rank packs its gradients into dtype-homogeneous
buckets of at most ``HVT_BUCKET_BYTES`` (default 64 MB, the JAX layout of
`collectives.flatten_buckets`, leaves last-first by default), sums each
bucket over the ranks on its wire (a staged `collectives.Reduction`; an
exact bucket is summed in place), divides by the world size (and by K
with ``average_aggregated_gradients``), and unpacks. The wires
(`collectives.reduce_dense_bucket`): f32 as it is; ``bf16``/``fp16`` cast
f32 buckets for the sum and back; ``int8``/``fp8`` cast the gradients to
f32 and run the quantized two-shot sum with an f32 residual per parameter
(error feedback); with a dcn factor above 1 the sum is two-hop, with
``compression_ici`` on its first hop. Under ZeRO-1 (`training.zero1`,
``bind(shard_update=True)``) an exact wire reduce-scatters each bucket of
the scatter layout into this rank's shards and a quantized one reduces
dense and cuts locally; the updated shards are then all-gathered into the
parameters. A single process without a process group runs the same
arithmetic over a world of 1 (the wire round-trip and the quantization
included). The reduction comes in stages (`pack_gradients`,
`communicate`, `apply`; under ZeRO-1 also `communicate_params`,
`unpack_params`) so that a captured CUDA-graph step can hold all of them,
or, where the collectives go through the host (gloo), leave the
communicating ones out of its graphs. With ``overlap`` each bucket is
reduced from the backward's post-accumulate-grad hooks as soon as its
gradients are final (`arm_overlap`), the same arithmetic.

On CUDA an optimizer with a ``capturable`` form runs in it, with every
group's learning rate a device tensor that `set_scale` fills: a captured
step then reads the epoch's update scale at each replay, and an eager
CUDA step computes bit for bit what the replay does.

Gradient accumulation (``backward_passes_per_step=K``) follows the JAX
Trainer's contract: the `Trainer` runs K microbatch backwards into the f32
``.grad`` (a local sum), then one reduction and one optimizer step; the K
gradients are summed (Horovod's default) or averaged
(``average_aggregated_gradients=True``).

`adam`, `adadelta` and `adamw` are optax's factories with optax's defaults
stated: torch's `Adam`/`Adadelta`/`AdamW` apply the same updates (eps
outside the square root for the Adams; Adadelta's rho and eps inside both
roots).
"""

from __future__ import annotations

import functools
import typing

import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.parallel import collectives, sharding
from horovod_tpu_torch.parallel.mesh import scale_lr  # noqa: F401 (re-export)
from horovod_tpu_torch.training import zero1

_WIRES = {
    "none": None,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}
#: The residual's key in `DistributedOptimizer.state_dict`.
EF_KEY = "ef_residual"
#: The rank a state dict was cut for (`DistributedOptimizer.cut_for_rank`).
RANK_KEY = "cut_for_rank"


class Compression:
    """Horovod's ``hvd.Compression`` enum: the string knobs
    `DistributedOptimizer` accepts (bf16/fp16 cast the wire; int8/fp8 are
    the quantized wires with error feedback)."""

    none = "none"
    fp16 = "fp16"
    bf16 = "bf16"
    int8 = "int8"
    fp8 = "fp8"


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam`` as a factory ``params -> Adam``, bound by
    `DistributedOptimizer` at `Trainer.build`."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(b1, b2), eps=eps)


def adadelta(learning_rate: float, rho: float = 0.9, eps: float = 1e-6):
    """``optax.adadelta`` as a factory ``params -> Adadelta``."""
    return functools.partial(torch.optim.Adadelta, lr=learning_rate,
                             rho=rho, eps=eps)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw`` as a factory ``params -> AdamW`` (torch's own
    weight-decay default is 1e-2, optax's 1e-4)."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
        weight_decay=weight_decay,
    )


def _placed(v, p, spec: dict, gather: bool):
    """One state value of placed parameter ``p`` (its local part shaped
    like ``p``, or whole): gathered along each placed dim over its group,
    or cut to this rank's part there (``spec``: dim -> `sharding.Cut`,
    fused rows per part); a value of another shape (a step count) as it
    is."""
    if not isinstance(v, torch.Tensor) or v.dim() != p.dim():
        return v
    for dim, cut in sorted(spec.items(), reverse=gather):
        n = collectives.group_size(cut.group)
        if gather and v.shape[dim] == p.shape[dim]:
            v = sharding.join_dim(
                collectives.all_gather_tensor(v, cut.group).unbind(0), dim,
                cut.parts)
        elif not gather and v.shape[dim] == p.shape[dim] * n:
            v = sharding.cut_dim(v, dim, n, collectives.group_rank(cut.group),
                                 cut.parts).clone()
    return v


class _Step(typing.NamedTuple):
    """One step's reduction: the parameters whose gradients it reduces (in
    its leaf order) and the staged `collectives.Reduction`; ``shard``, the
    reduction of the ``fsdp`` shards' gradients over their own group (or
    None)."""

    params: list
    index: dict
    reduction: collectives.Reduction
    shard: "_Step | None" = None


class DistributedOptimizer:
    """Wrap ``optimizer`` so updates consume cross-rank-averaged gradients.

    Args:
      optimizer: a `torch.optim.Optimizer`, or a factory ``params ->
        Optimizer`` (such as `adam`) bound at `bind`.
      average: mean (True, Horovod's default) or sum over the ranks.
      backward_passes_per_step: K microbatch backwards per optimizer step
        (the `Trainer` runs them); one reduction per K.
      average_aggregated_gradients: average the K accumulated gradients
        instead of summing them (Horovod's default is the sum).
      compression: the wire of the reduction (of its dcn hop when it is
        two-hop): ``"none"``, ``"bf16"``/``"fp16"`` (f32 gradients cast
        for the sum and back), or ``"int8"``/``"fp8"`` (the quantized
        two-shot `collectives.quantized_group_sum`, one f32 scale per
        bucket, with error feedback). A quantized wire quantizes in a
        world of one too, as the JAX package's does over one device.
      compression_ici: the wire of the two-hop reduction's ici hop (any
        of the above); inert when the dcn factor is 1.
      error_feedback: with a quantized wire on either hop, carry this
        rank's untransmitted remainder (an f32 residual per parameter)
        into the next step's quantization. It lives in `state_dict`
        under ``"ef_residual"``, one row per rank.

    The fusion-bucket size is ``HVT_BUCKET_BYTES`` (default 64 MB), or the
    `Trainer`'s ``bucket_bytes=``, which sets ``self.bucket_bytes``;
    ``self.bucket_reverse`` (``HVT_BUCKET_ORDER``, default ``reverse``)
    walks the leaves last-first; the `Trainer` sets ``self.dcn`` (the
    two-hop factor, `parallel.mesh.dcn_factor`), ``self.overlap`` and, with
    ``shard_update``, binds a ZeRO-1 update (`training.zero1`).
    """

    def __init__(self, optimizer, average: bool = True,
                 backward_passes_per_step: int = 1,
                 average_aggregated_gradients: bool = False,
                 compression: str = "none", compression_ici: str = "none",
                 error_feedback: bool = True):
        for knob, value in (("compression", compression),
                            ("compression_ici", compression_ici)):
            if value not in _WIRES:
                raise ValueError(
                    f"unknown {knob} {value!r}; expected one of "
                    f"{sorted(_WIRES)}"
                )
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.average = average
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.average_aggregated_gradients = bool(average_aggregated_gradients)
        self.wire_dtype = _WIRES[compression]
        self.ici_wire_dtype = _WIRES[compression_ici]
        self.quantized = collectives.is_quantized_wire(self.wire_dtype)
        self.ef = bool(error_feedback) and (
            self.quantized
            or collectives.is_quantized_wire(self.ici_wire_dtype))
        self.bucket_bytes = (registry.get_int("HVT_BUCKET_BYTES")
                             or collectives.DEFAULT_BUCKET_BYTES)
        order = registry.get_str("HVT_BUCKET_ORDER")
        if order not in ("reverse", "forward"):
            raise ValueError("HVT_BUCKET_ORDER must be 'reverse' or "
                             f"'forward', got {order!r}")
        self.bucket_reverse = order == "reverse"
        self.overlap = False
        self.dcn = None  # the two-hop factor; mesh.dcn_factor() at first use
        # The mesh's group the gradients reduce over (None: the world),
        # the number of batch shards (None: the world's size), the
        # parameters placed on live mesh axes, {param: {dim: sharding.Cut}},
        # and the `fsdp` shards, whose gradients (reduce-scattered over
        # `fsdp` in the backward) sum over `shard_group` instead (the
        # `Trainer` sets them all on a mesh).
        self.group = None
        self.dp = None
        self.placements: dict = {}
        self.shard_group = None
        self.shard_params: set = set()
        self.zero1 = None
        self.residual = None  # per bound parameter, this rank's f32 remainder
        self._model_params: list = []
        self._plans: dict = {}
        self._armed = None
        self._snapshot = None
        self._hooked = False
        self._factory = None
        self.optimizer = None
        if isinstance(optimizer, torch.optim.Optimizer):
            self._set(optimizer)
            self._model_params = list(self._params())
            self.bind(self._model_params)
        elif callable(optimizer):
            self._factory = optimizer
        else:
            raise TypeError(
                "optimizer must be a torch.optim.Optimizer or a factory "
                f"params -> Optimizer, got {type(optimizer).__name__}"
            )

    def _set(self, optimizer, base_lrs=None) -> None:
        self.optimizer = optimizer
        self._base_lrs = base_lrs or [float(g["lr"])
                                      for g in optimizer.param_groups]
        # Bumped whenever the optimizer's state tensors are rebound (a
        # load that could not copy in place): captured CUDA graphs hold
        # their addresses and must be captured again.
        self.generation = 0
        self._place_hyperparameters()

    def _place_hyperparameters(self) -> None:
        """On CUDA, a group whose optimizer has a ``capturable`` form takes
        it, with its learning rate a 0-d f32 tensor on the parameters'
        device (`set_scale` fills it): the step then runs inside a CUDA
        graph and reads the current scale at every replay. The eager CUDA
        step takes the same form, so the two agree bit for bit. Elsewhere
        the learning rate is a float."""
        for group, base in zip(self.optimizer.param_groups, self._base_lrs):
            dev = group["params"][0].device if group["params"] else None
            if dev is not None and dev.type == "cuda" \
                    and "capturable" in group:
                group["capturable"] = True
                lr = group["lr"]
                if not (isinstance(lr, torch.Tensor) and lr.device == dev
                        and lr.dtype == torch.float32 and lr.dim() == 0):
                    group["lr"] = torch.tensor(base, dtype=torch.float32,
                                               device=dev)
                for p in group["params"]:
                    st = self.optimizer.state.get(p, {})
                    if isinstance(st.get("step"), torch.Tensor):
                        st["step"] = st["step"].to(torch.float32).to(dev)
            else:
                group["lr"] = base

    @property
    def lr_is_tensor(self) -> bool:
        """Whether every group's learning rate lives on the device (the
        capturable form): a captured step then follows `set_scale`."""
        return all(isinstance(g["lr"], torch.Tensor)
                   for g in self.optimizer.param_groups)

    def bind(self, params, shard_update: bool = False) -> torch.optim.Optimizer:
        """The wrapped optimizer, built over ``params`` if it was given as
        a factory (an optimizer built already keeps its own). With
        ``shard_update`` in a world of more than one rank, the update is
        ZeRO-1's (`training.zero1.ShardedUpdate`) and the optimizer
        returned is the inner one, over this rank's shards and the tail
        parameters."""
        if self.optimizer is None:
            check = getattr(self._factory, "check_reduction", None)
            if check is not None:  # a factory with its own rule (LoRA's)
                check(self.quantized or collectives.is_quantized_wire(
                    self.ici_wire_dtype), shard_update and runtime.size() > 1)
            self._set(self._factory(list(params)))
            self._model_params = list(self._params())
        if shard_update and runtime.size() > 1 and self.zero1 is None:
            self.zero1 = zero1.ShardedUpdate(
                self.optimizer, runtime.size(), runtime.rank(),
                self.bucket_bytes, self.bucket_reverse)
            # The bases as given: a learning rate already placed on the
            # card is an f32 tensor, whose value is not the base float.
            self._set(self.zero1.optimizer, self._base_lrs)
        if self.ef and self.residual is None:
            self.residual = [torch.zeros_like(p, dtype=torch.float32)
                             for p in self._model_params]
        return self.optimizer

    def _params(self):
        for group in self.optimizer.param_groups:
            yield from group["params"]

    def zero_grad(self) -> None:
        """Drop the model's gradients (a ZeRO-1 shard keeps its own
        gradient buffer, which every step overwrites)."""
        for p in self._model_params:
            p.grad = None

    # -- state ---------------------------------------------------------------

    @property
    def state_is_collective(self) -> bool:
        """Whether `state_dict` gathers over the ranks: ZeRO-1 shards or
        per-rank residuals in a world of more than one. Every rank must
        then call it at the same point, or read a `snapshot`."""
        return runtime.size() > 1 and (self.zero1 is not None or self.ef
                                       or bool(self.placements))

    def state_dict(self) -> dict:
        """The optimizer's state dict in the replicated optimizer's format,
        every group's learning rate as its base float (never scaled, never
        a device tensor); ZeRO-1 shards gathered back to whole tensors and,
        with error feedback, ``"ef_residual"``: per parameter ``[ranks,
        *shape]``, every rank's residual. Where that is a collective
        (`state_is_collective`) the last `snapshot` is returned while no
        step ran since it."""
        if self._snapshot is not None:
            return self._snapshot
        sd = self.optimizer.state_dict()
        if self.zero1 is not None:
            sd = self.zero1.gather_state(sd)
        if self.placements:
            sd = self._placed_state(sd, gather=True)
        for group, base in zip(sd["param_groups"], self._base_lrs):
            group["lr"] = base
        if self.residual is not None:
            sd[EF_KEY] = [collectives.all_gather_tensor(r)
                          if runtime.is_distributed() else r.unsqueeze(0)
                          for r in self.residual]
        return sd

    def snapshot(self) -> dict:
        """Take `state_dict` now, on every rank (a collective where
        `state_is_collective`), and keep it in host memory until the next
        step: a checkpoint callback that runs on one rank then reads it
        without a collective. The fit takes one at an epoch end where a
        checkpoint callback runs on some rank."""
        self._snapshot = None
        leaves, treedef = collectives.tree_flatten(self.state_dict())
        self._snapshot = collectives.tree_unflatten(treedef, [
            v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for v in leaves])
        return self._snapshot

    def state_changed(self) -> None:
        """Drop the `snapshot` (a step ran, or state was loaded)."""
        self._snapshot = None

    def cut_for_rank(self, state: dict, rank: int) -> dict:
        """``state`` (the `state_dict` format) cut to what rank ``rank``
        loads: its ZeRO-1 shards and its row of the residual.
        `load_state_dict` on that rank takes it as it takes the whole."""
        out = {k: v for k, v in state.items() if k != EF_KEY}
        if self.zero1 is not None:
            out = self.zero1.cut_state(out, rank)
        if EF_KEY in state:
            out[EF_KEY] = [r[rank:rank + 1].clone() for r in state[EF_KEY]]
        out[RANK_KEY] = int(rank)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Adopt ``state`` (the `state_dict` format, or its `cut_for_rank`
        for this rank): ZeRO-1 cuts this rank's shards from it and error
        feedback takes this rank's row of the residual; no collective.
        Where every state tensor exists already with the same shape, the
        values are copied in place, so captured CUDA graphs stay valid;
        otherwise the optimizer loads it and `generation` moves on (graphs
        are captured again)."""
        self.state_changed()
        cut = state.get(RANK_KEY)
        if cut is not None and cut != runtime.rank():
            raise ValueError(f"state cut for rank {cut} loaded on rank "
                             f"{runtime.rank()}")
        if self.residual is not None:
            rows = state.get(EF_KEY)
            if rows is None:
                raise ValueError("loaded state has no error-feedback "
                                 f"residual ({EF_KEY!r})")
            want = 1 if cut is not None else runtime.size()
            if len(rows) != len(self.residual) or any(
                    r.shape[0] != want for r in rows):
                raise NotImplementedError(
                    "the error-feedback residual was saved at another world "
                    "size or for other parameters; re-cutting it is ROADMAP "
                    "queue A item 13 (the elastic reshard)")
            with torch.no_grad():
                for dst, r in zip(self.residual, rows):
                    dst.copy_(r[0 if cut is not None else runtime.rank()])
        state = {k: v for k, v in state.items()
                 if k not in (EF_KEY, RANK_KEY)}
        if self.zero1 is not None and cut is None:
            state = self.zero1.cut_state(state)
        if self.placements:
            state = self._placed_state(state, gather=False)
        self._load_inner(state)

    def _placed_state(self, sd: dict, *, gather: bool) -> dict:
        """``sd`` (the inner optimizer's state-dict format) with the state
        of every placed parameter gathered whole over its groups
        (``gather``, a collective) or cut to this rank's part: the tensors
        shaped like their parameter (Adam's moments), the rest as they
        are."""
        params = list(self._params())
        out = dict(sd)
        out["state"] = {}
        for i, st in sd["state"].items():
            p = params[int(i)]
            spec = self.placements.get(p)
            if spec:
                st = {k: _placed(v, p, spec, gather) for k, v in st.items()}
            out["state"][i] = st
        return out

    def _load_inner(self, state: dict) -> None:
        params = list(self._params())
        incoming = state["state"]
        current = self.optimizer.state
        in_place = bool(current) and len(incoming) == len(current) and all(
            0 <= int(i) < len(params) and params[int(i)] in current
            and set(st) == set(current[params[int(i)]])
            and all(not isinstance(v, torch.Tensor)
                    or (isinstance(current[params[int(i)]][k], torch.Tensor)
                        and current[params[int(i)]][k].shape == v.shape)
                    for k, v in st.items())
            for i, st in incoming.items())
        if len(state["param_groups"]) != len(self.optimizer.param_groups):
            raise ValueError("loaded state has another number of param groups")
        self._base_lrs = [float(g["lr"]) for g in state["param_groups"]]
        if in_place:
            with torch.no_grad():
                for i, st in incoming.items():
                    cur = current[params[int(i)]]
                    for k, v in st.items():
                        if isinstance(v, torch.Tensor):
                            cur[k].copy_(v)
                        else:
                            cur[k] = v
            for group, new in zip(self.optimizer.param_groups,
                                  state["param_groups"]):
                for k, v in new.items():
                    if k not in ("params", "lr", "capturable", "param_names"):
                        group[k] = v
        else:
            self.optimizer.load_state_dict(state)
            self.generation += 1
        self._place_hyperparameters()
        self.set_scale(1.0)

    def replicated_state_dict(self) -> dict:
        """What every rank holds alike, without a collective: the inner
        optimizer's state minus the ZeRO-1 shards (the tail parameters'
        state), its hyperparameters, no residual."""
        sd = self.optimizer.state_dict()
        if self.zero1 is not None:
            sd["state"] = {i: st for i, st in sd["state"].items()
                           if self.zero1.is_tail_index(i)}
        for group, base in zip(sd["param_groups"], self._base_lrs):
            group["lr"] = base
        return sd

    def load_replicated_state_dict(self, state: dict) -> None:
        """Adopt another rank's `replicated_state_dict`; this rank's shards
        and residual stay its own."""
        self.state_changed()
        merged = self.optimizer.state_dict()
        merged["state"] = {**merged["state"], **state["state"]}
        merged["param_groups"] = state["param_groups"]
        self._load_inner(merged)

    def set_scale(self, scale: float = 1.0) -> None:
        """Every group's learning rate becomes its base times ``scale`` —
        JAX's ``update_scale``, which multiplies the whole update (for
        AdamW the decay term too). A device learning rate is filled in
        place (outside any captured graph: the graphs read it)."""
        with torch.no_grad():
            for group, base in zip(self.optimizer.param_groups,
                                   self._base_lrs):
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].fill_(base * scale)
                else:
                    group["lr"] = base * scale

    # -- the reduction ---------------------------------------------------------

    def _exact_and_plain(self) -> bool:
        """Whether the reduction, in a world of one without a process
        group, leaves the gradients as they are (nothing to round, divide,
        quantize or carry)."""
        return (self.wire_dtype is None and not self.ef
                and self._divisor() == 1 and self.zero1 is None)

    def _grad_of(self, p):
        g = p.grad
        return g.float() if (self.quantized or self.ef) else g

    def _grad_dtype(self, p):
        dt = p.grad.dtype if p.grad is not None else p.dtype
        return torch.float32 if (self.quantized or self.ef) else dt

    def _plan_for(self, params) -> collectives.BucketPlan:
        scatter = self.zero1.dp if self.zero1 is not None else None
        key = (tuple((tuple(p.shape), self._grad_dtype(p)) for p in params),
               self.bucket_bytes, self.bucket_reverse, scatter)
        if key not in self._plans:
            if len(self._plans) > 1:  # the main and the shard plans
                self._plans.clear()
            self._plans[key] = collectives.BucketPlan(
                [s for s, _ in key[0]], [d for _, d in key[0]],
                self.bucket_bytes, reverse=self.bucket_reverse,
                scatter=scatter, wire_dtype=self.wire_dtype)
        return self._plans[key]

    def _new_step(self, params, grads, group=None) -> _Step:
        if self.dcn is None:
            from horovod_tpu_torch.parallel import mesh

            self.dcn = mesh.dcn_factor()
        residuals = None
        if self.residual is not None:
            index = {id(p): i for i, p in enumerate(self._model_params)}
            residuals = [self.residual[index[id(p)]] for p in params]
        # The gradients are this step's to overwrite: exact dense buckets
        # are summed in place.
        red = collectives.Reduction(
            self._plan_for(params), grads, residuals, dcn=self.dcn,
            wire_dtype=self.wire_dtype, ici_wire_dtype=self.ici_wire_dtype,
            donate=True, device=params[0].device,
            group=self.group if group is None else group)
        return _Step(params, {id(p): i for i, p in enumerate(params)}, red)

    def arm_overlap(self) -> None:
        """Before the last microbatch's backward of a step: with
        ``overlap`` in a world of more than one rank, each bucket's
        reduction is issued from a post-accumulate-grad hook (registered
        here, the first time) as soon as every gradient in it is final, in
        the order the backward finishes them (reverse bucket order puts
        those first). The arithmetic is the serialized reduction's, bit for
        bit."""
        self._armed = None
        if (not self.overlap or runtime.size() == 1 or self.shard_params
                or self.group is collectives.SELF):
            return
        params = [p for p in self._model_params if p.requires_grad]
        if not params:
            return
        if not self._hooked:
            for p in params:
                p.register_post_accumulate_grad_hook(self._grad_ready)
            self._hooked = True
        self._armed = self._new_step(params, [None] * len(params))

    @torch.no_grad()
    def _grad_ready(self, p) -> None:
        armed = self._armed
        if armed is not None and id(p) in armed.index:
            armed.reduction.leaf_ready(armed.index[id(p)], self._grad_of(p))

    @torch.no_grad()
    def pack_gradients(self):
        """The reduction's first stage: the gradients (f32 for a quantized
        wire or error feedback) and the residual in their buckets, and the
        buffers the reduced buckets land in. Returns the step's reduction,
        or None when there is nothing to reduce (a world of 1 with nothing
        to round, divide or quantize, or no gradients)."""
        self.state_changed()
        armed, self._armed = self._armed, None
        if ((not runtime.is_distributed() or self.group is collectives.SELF)
                and self._exact_and_plain()):
            return None
        params = [p for p in self._model_params if p.grad is not None]
        shard = [p for p in params if id(p) in self.shard_params]
        if shard:
            params = [p for p in params if id(p) not in self.shard_params]
            step = self._pack(params) if params else None
            held = self._pack(shard, self.shard_group)
            if step is None:
                return held
            return step._replace(shard=held)
        if not params:
            return None
        if armed is not None:
            if [id(p) for p in params] == [id(p) for p in armed.params]:
                red = armed.reduction
                for i, p in enumerate(params):
                    if red.leaves[i] is None:
                        red.leaves[i] = self._grad_of(p)
                for k in range(len(red.buckets)):
                    red.assemble(k)
                return armed
            armed.reduction.wait()  # a gradient never came: start over
        return self._pack(params)

    def _pack(self, params, group=None) -> _Step:
        step = self._new_step(params, [self._grad_of(p) for p in params],
                              group)
        for k in range(len(step.reduction.buckets)):
            step.reduction.assemble(k)
        return step

    @torch.no_grad()
    def communicate(self, packed) -> None:
        """The second stage: every bucket not yet issued is reduced over the
        ranks (the identity sum without a process group; a quantized wire
        still quantizes), and the asynchronous ones are collected."""
        while packed is not None:
            packed.reduction.communicate()
            packed = packed.shard

    @torch.no_grad()
    def unpack_gradients(self, packed) -> None:
        """The third stage: the reduced buckets divided, into ``.grad`` (or
        ZeRO-1's shard gradients), and the new residual into place."""
        if packed is None:
            return
        if packed.shard is not None:
            torch._foreach_copy_([p.grad for p in packed.shard.params],
                                 packed.shard.reduction.unpack(
                                     self._divisor())[0])
        local, new_res = packed.reduction.unpack(self._divisor())
        if new_res is not None:
            torch._foreach_copy_(packed.reduction.residuals, new_res)
        if self.zero1 is not None:
            self.zero1.set_grads(self._by_model_param(packed.params, local))
        else:
            torch._foreach_copy_([p.grad for p in packed.params], local)

    def _by_model_param(self, params, leaves) -> list:
        """``leaves`` (one per param of ``params``) in bound-parameter
        order; a parameter without a gradient gets None."""
        index = {id(p): i for i, p in enumerate(params)}
        return [leaves[index[id(p)]] if id(p) in index else None
                for p in self._model_params]

    def _divisor(self) -> int:
        dp = runtime.size() if self.dp is None else self.dp
        return (dp if self.average else 1) * (
            self.backward_passes_per_step
            if self.average_aggregated_gradients else 1)

    def reduce_gradients(self) -> None:
        """Replace every ``.grad`` by its sum over the ranks (through the
        wire), divided by the world size when averaging and by K when
        averaging the accumulated passes: `pack_gradients`, `communicate`,
        `unpack_gradients`."""
        packed = self.pack_gradients()
        self.communicate(packed)
        self.unpack_gradients(packed)

    @torch.no_grad()
    def apply(self, packed):
        """Unpack the reduced gradients and step the optimizer; under
        ZeRO-1, returns the updated shards packed for the parameter
        all-gather (`communicate_params`, `unpack_params`), else None."""
        self.unpack_gradients(packed)
        self.optimizer.step()
        return self.zero1.pack_params() if self.zero1 is not None else None

    @torch.no_grad()
    def communicate_params(self, packed_params) -> None:
        if packed_params is not None:
            self.zero1.communicate_params(packed_params)

    def unpack_params(self, packed_params) -> None:
        if packed_params is not None:
            self.zero1.unpack_params(packed_params)

    def state_bytes(self) -> int:
        """Bytes of the optimizer's state tensors on this rank (ZeRO-1's
        shards; the residual apart)."""
        return sum(v.numel() * v.element_size()
                   for st in self.optimizer.state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))

    def residual_bytes(self) -> int:
        """Bytes of this rank's error-feedback residual."""
        return sum(r.numel() * r.element_size() for r in self.residual or ())

    def step(self, scale: float = 1.0) -> None:
        """Reduce, then one optimizer step with every group's learning rate
        multiplied by ``scale`` (under ZeRO-1, then the parameter
        all-gather); a float learning rate returns to its base after the
        step."""
        if self.optimizer is None:
            raise RuntimeError("bind() the optimizer to parameters first")
        self.set_scale(scale)
        try:
            packed = self.pack_gradients()
            self.communicate(packed)
            packed_params = self.apply(packed)
            self.communicate_params(packed_params)
            self.unpack_params(packed_params)
        finally:
            if not self.lr_is_tensor:
                self.set_scale(1.0)
