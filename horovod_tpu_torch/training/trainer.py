"""Trainer — port of `horovod_tpu.training.trainer`: build, fit, evaluate
and predict, one device per rank, data-parallel over `torch.distributed`.
The feeding paths are `training.feeding`; the captured step is
`training.graphs`.

A step: forward in train mode with the step's dropout seed, loss (the
module's own under ``loss="module"``, else ``loss_fn(logits, y)``),
backward, then the optimizer, which averages the gradients over the ranks
and applies the update scaled by ``update_scale``. With
``backward_passes_per_step=K`` a step runs K microbatch backwards (the
gradients sum in ``.grad``) before the one reduction. Each rank's step
metrics are over its own batch; `MetricAverageCallback` averages the epoch
logs over the ranks.

Module contract: ``module(x, train=bool, dropout_seed=seed)`` returns
logits, ``seed`` an int or a 0-d int64 tensor; with ``loss="module"`` it
also takes ``labels=y`` and returns ``(per_token_loss,
per_token_correct)``, as the port's `TransformerLM` does. ``x`` may be a
dict or tuple of arrays sharing dim 0 (``{"src", "tgt"}`` for the seq2seq
family): every path feeds, cuts and stages it leaf by leaf.

``fit(x=, y=)`` feeds ``ArrayDataset((x, y)).shard(i, dp)`` through
`training_pipeline` (the native engine where it builds, as in JAX) seeded
with ``seed``, epoch-anchored, so its batches are byte-identical to the
JAX trainer's; ``i`` is this rank's batch shard and ``dp`` the number of
shards (the rank and the world size on a pure-data mesh). Options not
ported raise `NotImplementedError` naming their ROADMAP item.

The objective is the JAX Trainer's ``forward_loss``: the mean loss plus
every loss the module sowed (`train_state.sow`; an MoE layer's load
balance), and the step's metrics are ``{loss, accuracy}`` plus the sown
metrics averaged by name (``moe_drop_rate``), whose names are discovered
once by an eval-mode forward of a sample (at `build` with one, else
before the first step) — reserved names and sows gated on ``train`` raise
JAX's errors.

``mesh=`` (a `parallel.mesh.Mesh`) and ``param_specs=`` (a function
``(module, mesh) -> {name: {dim: axis}}`` such as
`models.transformer.param_specs` or `models.pipelined_lm.param_specs`, or
such a dict) place the model: the port carries live ``data``, ``fsdp``,
``pipe``, ``seq``, ``model`` and ``expert`` axes. The batch is sharded
over ``(data, fsdp)`` (JAX's default layout), so every rank of a ``pipe``,
``model``, expert or ``seq`` group feeds the same rows, and gradients
(``model`` and expert shards and replicated parameters alike) sum over
the mesh's gradient group (the ranks that differ on ``data``, ``fsdp`` or
``seq``) divided by ``dp``, once — a pipelined model's stage stacks at
their own ``pipe`` coordinate, its replicated leaves alike, since its
schedule gives every stage the whole gradient of the embedding and of the
head (`parallel.pipeline`). An ``fsdp`` shard's gradient, already
summed over ``fsdp`` by the reduce-scatter in its gather's backward, sums
over the shard gradient group instead (the ranks that differ on ``data``
or ``seq``), divided by ``dp`` alike.

Sequence parallelism (a live ``seq`` axis of n ranks): ``batch_specs=``
gives each batch part's layout in the JAX form, ``P(("data", "fsdp"),
"seq", None)`` (`parallel.mesh.P`) — the layout of JAX's tests and
examples, and the only one the port carries there: every part of two or
more dims must shard dim 1 over ``seq``. JAX's default (``batch_specs``
None: dim 0 over the data axes, the rest replicated) and any other
layout raise naming ROADMAP item 12.4, since the model takes this rank's
columns of its token input. A part sharded on ``seq`` keeps columns
``[c·T/n, (c+1)·T/n)`` on the rank at seq coordinate c, on every feeding
path. The loss is JAX's global one,
``loss_fn(out, y).mean()`` over the global ``[B, T]`` arrays: a named
loss's and ``loss="module"``'s per-token losses are local and are joined
over the ``seq`` group before their mean; a callable loss (not
necessarily token-separable, such as a per-row ratio of sums) sees the
group's full ``out`` and ``y``. Either join is
`collectives.all_gather_tiled`, whose backward keeps this rank's slice:
every rank of the group computes the same loss, and owes the gradient of
its own tokens. Accuracy is joined alike. Dropout seeds are derived from
the batch shard and the seq coordinate, so two sequence shards never draw
the same mask. On a live ``seq`` axis the bucket reductions run after the
backward, never inside it (``overlap_reduction`` is inert there): the
ring's backward shifts would otherwise interleave with them in an order
that differs by rank.

The boundary reduction is the `DistributedOptimizer`'s: its wire
(``compression``, ``compression_ici``, error feedback), the two-hop factor
(`parallel.mesh.dcn_factor`, ``HVT_DCN_FACTOR``), and the Trainer's
``shard_update`` (ZeRO-1, `training.zero1`), ``overlap_reduction`` and
``bucket_order``, as in the JAX Trainer.
"""

from __future__ import annotations


import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data import stream
from horovod_tpu_torch.models.moe import TokenShards
from horovod_tpu_torch.models.transformer import (
    _full_shapes, live_placements,
)
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import sharding as shard_lib
from horovod_tpu_torch.runtime import derive_seed, resolve_device
from horovod_tpu_torch.training import feeding, train_state
from horovod_tpu_torch.training.graphs import StepRunner
from horovod_tpu_torch.training.optimizer import DistributedOptimizer
from horovod_tpu_torch.training.train_state import (
    TrainState, _correct, _resolve_loss,
)

# The batch layout the port carries (`Trainer(batch_specs=...)`): dim 0
# over the batch axes, dim 1 over `seq` or unsharded, the rest unsharded.
_BATCH_AXES = (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)


def _one_spec(spec) -> bool:
    """Whether one layout shards dim 1 over ``seq``; any layout but
    ``P(("data", "fsdp"), "seq" or None, None, ...)`` raises naming its
    ROADMAP item."""
    spec = tuple(spec)
    if (not spec or tuple(np.atleast_1d(spec[0])) != _BATCH_AXES
            or (len(spec) > 1 and spec[1] not in (None, mesh_lib.SEQ_AXIS))
            or any(a is not None for a in spec[2:])):
        raise NotImplementedError(
            f"Trainer(batch_specs=...): the layout {spec!r} is not "
            "ported yet — the port carries P(('data', 'fsdp'), 'seq' "
            "or None, None, ...); ROADMAP queue A item 12.4 (sharded "
            "layouts)")
    return len(spec) > 1 and spec[1] == mesh_lib.SEQ_AXIS


def _seq_parts(batch_specs) -> tuple:
    """For each batch part's spec, whether it shards dim 1 over ``seq``:
    a bool, or for a dict of specs (a dict part's layout leaf by leaf) a
    dict of them. One spec applies to every leaf of a part, as in JAX."""
    if batch_specs is None:
        return ()
    return tuple({k: _one_spec(v) for k, v in spec.items()}
                 if isinstance(spec, dict) else _one_spec(spec)
                 for spec in batch_specs)


class Trainer:
    """build + fit + evaluate + predict for a torch module, one device per
    rank.

    Args:
      module: a `torch.nn.Module` following the contract in the module
        docstring. `build` moves it to ``device``.
      optimizer: a `DistributedOptimizer`, or what one wraps (an optimizer
        or a factory such as `training.optimizer.adam`).
      loss: Keras-style name, ``"module"``, or ``fn(logits, labels) ->
        per-example loss``.
      seed: the root of the per-step dropout seeds and of the ``x=``/``y=``
        shuffle.
      bucket_bytes: the gradient fusion-bucket size; default
        ``HVT_BUCKET_BYTES``, else 64 MB (the JAX Trainer's knob).
      steps_per_execution: Keras's K: the streamed fit runs its steps in
        chunks of K and ``on_batch_end`` fires once per chunk, with the
        chunk's last metrics.
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA is never replaced by
        the CPU silently.
      shard_update: ZeRO-1 (`training.zero1`): the optimizer's state and
        update cut over the ranks, the reduction scattered into that layout
        (a quantized dcn wire reduces dense and cuts locally), the updated
        shards all-gathered back into the replicated parameters. A no-op
        in a world of one.
      overlap_reduction: issue each bucket's reduction from the last
        microbatch's backward as soon as its gradients are final (default
        ``HVT_OVERLAP_REDUCTION``, else on); the arithmetic is the
        serialized form's. Where the collectives sit between captured
        graphs (gloo) it changes nothing.
      bucket_order: ``"reverse"`` (default ``HVT_BUCKET_ORDER``, else
        reverse: the leaves last-first, the order the backward finishes
        them) or ``"forward"``.
      mesh: a `parallel.mesh.Mesh` (default: every rank on ``data``).
      param_specs: the placements of the parameters on ``mesh``
        (``pipe``, ``model``, ``fsdp`` and ``expert``). A module that holds
        parameter shards (MoE experts, a `TransformerLM` built on a
        ``model`` or ``fsdp`` mesh, a `PipelinedLM` on a ``pipe`` mesh)
        needs them.
      batch_specs: one layout a batch part, ``(x_spec, y_spec)``, in the
        JAX form (module docstring); required on a live ``seq`` axis.
    """

    def __init__(self, module, optimizer,
                 loss="sparse_categorical_crossentropy", seed: int = 0,
                 device="cuda", bucket_bytes: int | None = None,
                 steps_per_execution: int = 1, shard_update: bool = False,
                 overlap_reduction: bool | None = None,
                 bucket_order: str | None = None, mesh=None,
                 param_specs=None, batch_specs=None):
        self._seq_parts = _seq_parts(batch_specs)
        self.batch_specs = batch_specs
        if mesh is not None:
            if mesh.seq_shards > 1 and batch_specs is None:
                raise NotImplementedError(
                    "Trainer(mesh=...) on a live 'seq' axis needs "
                    "batch_specs= with dim 1 over 'seq', P(('data', "
                    "'fsdp'), 'seq', None); the default layout (the rest "
                    "replicated) is not ported yet — ROADMAP queue A item "
                    "12.4 (sharded layouts)")
            if mesh.layout_only:
                raise ValueError(f"Trainer(mesh={mesh!r}): the mesh was "
                                 "built for another world than this one")
        self.mesh = mesh
        self.param_specs = param_specs
        self.placements: dict = {}  # parameter name -> live {dim: axis}
        self.device = resolve_device(device)
        self.module = module
        self.tx = (optimizer if isinstance(optimizer, DistributedOptimizer)
                   else DistributedOptimizer(optimizer))
        self._refuse_with_placements(shard_update)
        if bucket_bytes:
            self.tx.bucket_bytes = int(bucket_bytes)
        if bucket_order is not None:  # else the optimizer's HVT_BUCKET_ORDER
            if bucket_order not in ("reverse", "forward"):
                raise ValueError("bucket_order must be 'reverse' or "
                                 f"'forward', got {bucket_order!r}")
            self.tx.bucket_reverse = bucket_order == "reverse"
        if overlap_reduction is None:
            overlap_reduction = registry.get_flag("HVT_OVERLAP_REDUCTION")
        self.tx.overlap = bool(overlap_reduction)
        self.shard_update = bool(shard_update)
        # The two-hop factor: HVT_DCN_FACTOR (checked here: it must divide
        # the world size), else the hosts, asked at the first step. A
        # reduction over a subgroup is single-hop.
        if self.batch_group is not None:
            self.tx.group, self.tx.dp, self.tx.dcn = (
                self.mesh.grad_group, self.dp, 1)
        elif registry.get_raw(mesh_lib.ENV_DCN_FACTOR):
            self.tx.dcn = mesh_lib.dcn_factor()
        self._accum_steps = self.tx.backward_passes_per_step
        self.loss_fn = _resolve_loss(loss)
        self._module_loss = loss == "module"
        # A named loss is per token: on a live seq axis its values join.
        self._token_loss = isinstance(loss, str)
        self.seed = int(seed)
        self.steps_per_execution = max(1, int(steps_per_execution))
        self.state: TrainState | None = None
        # Multiplies the optimizer's update (the knob the LR callbacks
        # turn); reset to 1.0 at every epoch begin.
        self.update_scale = 1.0
        self.stop_training = False
        self.history: list[dict] = []
        # Where the current fit resumed, for resume-aware callbacks.
        self._resume_epoch = 0
        self._resume_step = 0
        # The current fit's feed (path, engine, geometry), as JAX records
        # it for its stream cursors.
        self._stream_geometry: dict | None = None
        # Staged eval sets of evaluate(cache="device"), by the host
        # arrays' identity.
        self._eval_cache: dict = {}
        # The last fit's step runner (its capture and replay counts), and
        # the one `train_step` steps eagerly.
        self._runner = None
        self._step_runner = None
        # Names of the module's sown metrics, discovered once (None until
        # then), and whether any of its layers sows at all.
        self._metric_names: tuple | None = None
        self._sows = train_state.sows(module)

    @property
    def metric_names(self) -> tuple:
        """Every per-step metric key: loss, accuracy and the module's sown
        metrics (known once discovered)."""
        return ("loss", "accuracy") + (self._metric_names or ())

    # -- the mesh --------------------------------------------------------------

    @property
    def dp(self) -> int:
        """The number of batch shards (the world size without a mesh)."""
        return mesh_lib.dp_size(self.mesh)

    @property
    def data_index(self) -> int:
        """This rank's batch shard (its rank without a mesh)."""
        return (self.mesh.data_index if self.mesh is not None
                else runtime.rank())

    @property
    def token_shards(self) -> TokenShards:
        """Where this rank's batch shard sits in the global batch (the
        world's ranks without a mesh), for the layers that group tokens
        across shards (`models.moe.grouping_plan`)."""
        if self.mesh is not None:
            return TokenShards.of(self.mesh)
        return TokenShards(data_shards=self.dp, data_index=self.data_index)

    @property
    def batch_group(self):
        """The ranks that share this one's parameters and differ in batch
        shard: None (the world) on a pure-data mesh."""
        return self.mesh.batch_group if self.mesh is not None else None

    @property
    def seq_shards(self) -> int:
        """The size of the mesh's ``seq`` axis (1 without a mesh)."""
        return self.mesh.seq_shards if self.mesh is not None else 1

    @property
    def seq_group(self):
        return self.mesh.group(mesh_lib.SEQ_AXIS) if self.mesh is not None \
            else None

    def cut(self, a, part: int):
        """This rank's columns of batch part ``part`` (0: x, 1: y) on a
        live ``seq`` axis: ``[c·T/n, (c+1)·T/n)`` of dim 1 where the part's
        layout shards it (`_seq_sharded`), else the whole part; a dict or
        tuple part leaf by leaf."""
        if self.seq_shards == 1:
            return a
        flags = self._part_flags(a, part)
        return collectives.tree_map(self._cut_leaf, a, flags)

    def _part_flags(self, a, part: int):
        """Part ``part``'s sharding flag for each leaf of ``a``."""
        flag = self._seq_parts[part] if part < len(self._seq_parts) else False
        if isinstance(flag, dict):
            return flag
        return collectives.tree_map(lambda _: flag, a)

    def _cut_leaf(self, a, sharded: bool):
        if np.ndim(a) < 2:
            return a
        if not sharded:
            raise NotImplementedError(
                f"Trainer(batch_specs=...): a batch part (shape "
                f"{tuple(np.shape(a))}) is whole on dim 1 of a live 'seq' "
                "axis; the port carries P(('data', 'fsdp'), 'seq', None) "
                "there — ROADMAP queue A item 12.4 (sharded layouts)")
        n, t = self.seq_shards, a.shape[1]
        if t % n:  # JAX's models' check, in their words
            raise ValueError(
                f"seq length ({t}) must divide over the seq axis ({n})")
        c = self.mesh.seq_index
        return a[:, c * t // n:(c + 1) * t // n]

    def _seq_sharded(self, a, part: int) -> bool:
        """Whether batch part ``part`` is cut over ``seq`` (a leaf of two
        or more dims on a live seq axis); a leaf whose layout leaves dim 1
        whole raises naming its ROADMAP item."""
        if self.seq_shards == 1:
            return False
        leaves = collectives.tree_flatten(a)[0]
        flags = collectives.tree_flatten(self._part_flags(a, part))[0]
        for leaf, flag in zip(leaves, flags):
            self._cut_leaf(leaf, flag)  # raises for a layout not carried
        return any(np.ndim(leaf) >= 2 for leaf in leaves)

    def cut_batch(self, batch) -> tuple:
        """`cut` of each part of an ``(x, y)`` batch."""
        return tuple(self.cut(a, i) for i, a in enumerate(batch))

    def _refuse_with_placements(self, shard_update: bool) -> None:
        """JAX's refusals of options that assume replicated parameters, and
        the port's of the reductions it runs over the world only."""
        tx = self.tx
        compressed = (tx.wire_dtype is not None
                      or tx.ici_wire_dtype is not None)
        if self.param_specs is not None:
            if compressed:
                raise ValueError(
                    "DistributedOptimizer(compression=/compression_ici=...) "
                    "requires replicated parameters (param_specs=None); "
                    "sharded-parameter layouts keep XLA's implicit f32 "
                    "gradient reduction"
                )
            if tx.backward_passes_per_step > 1:
                raise ValueError(
                    "DistributedOptimizer(backward_passes_per_step=K) "
                    "requires replicated parameters (param_specs=None): "
                    "the accumulating step's explicit boundary reduction "
                    "assumes the pure-DP gradient layout"
                )
            if shard_update:
                raise ValueError(
                    "shard_update (ZeRO-1) targets the replicated-parameter "
                    "layout; with param_specs the optimizer mirrors already "
                    "follow the fsdp/tp sharding — compose via the fsdp axis "
                    "instead"
                )
        if self.batch_specs is not None and tx.backward_passes_per_step > 1:
            raise ValueError(
                "backward_passes_per_step does not compose with custom "
                "batch_specs — the microbatch stack is sharded along "
                "the data axes only"
            )
        if self.batch_group is not None and (compressed or shard_update
                                             or registry.get_raw(
                                                 mesh_lib.ENV_DCN_FACTOR)):
            raise NotImplementedError(
                "the quantized and 16-bit wires, the two-hop reduction and "
                "ZeRO-1 reduce over the whole world; on a mesh with live "
                "non-data axes they are not ported yet — ROADMAP queue A "
                "item 12.4")

    def _place(self) -> None:
        """The parameters' placements on the mesh: each live one must be
        what the module holds (its MoE layers shard their experts and a
        `TransformerLM` cuts its ``model``/``fsdp`` parts and a
        `PipelinedLM` its ``pipe``/``model`` parts at construction, from
        the model's own mesh)."""
        mesh = self.mesh
        held = {type(m).__name__: m.mesh if hasattr(m, "mesh")
                else m.sharding.mesh for m in self.module.modules()
                if getattr(m, "ep", 1) > 1 or getattr(m, "cuts", None)}
        for kind, m_mesh in held.items():
            if mesh is None or m_mesh.shape != mesh.shape:
                raise ValueError(
                    f"{kind} holds parameter shards over the mesh "
                    f"{m_mesh!r}: pass that mesh as Trainer(mesh=...)")
        if self.param_specs is None:
            if held:
                raise ValueError(
                    "the module holds parameter shards (MoE experts, model "
                    "or fsdp parts): pass param_specs= "
                    "(models.transformer.param_specs)")
        elif mesh is not None:  # on the pure-data mesh nothing is live
            specs = (self.param_specs(self.module, mesh)
                     if callable(self.param_specs) else self.param_specs)
            self.placements = live_placements(specs, mesh)
            params = dict(self.module.named_parameters())
            full = _full_shapes(self.module)
            for name, spec in self.placements.items():
                for dim, ax in spec.items():
                    want = full[name][dim] // mesh.shape[ax]
                    if params[name].shape[dim] != want:
                        raise ValueError(
                            f"{name} holds {params[name].shape[dim]} along "
                            f"dim {dim}, its {ax!r} placement wants {want}: "
                            "build the model with sharding="
                            "ShardingConfig(mesh=...)")
        for m in self.module.modules():
            if isinstance(getattr(m, "token_shards", None), TokenShards):
                m.token_shards = self.token_shards
        if self.placements:
            named = [(n, p) for n, p in self.module.named_parameters()
                     if n in self.placements]
            self.tx.placements = {
                p: shard_lib.rank_cuts(n, self.placements[n], mesh)
                for n, p in named}
            self.tx.shard_params = {
                id(p) for n, p in named
                if mesh_lib.FSDP_AXIS in self.placements[n].values()}
            self.tx.shard_group = mesh.shard_grad_group

    def discover_metrics(self, sample_x, sample_y=None) -> tuple:
        """The names of the module's sown metrics, from an eval-mode
        forward of a sample (the JAX trainer's build-time init; without
        ``sample_y`` a module computing its own loss gets
        ``zeros_like(sample_x)`` as labels, the LM contract)."""
        if self._metric_names is None:
            names = ()
            if self._sows:
                x = self._tensor(sample_x)
                train_state.clear_sown(self.module)
                with torch.no_grad():
                    if self._module_loss:
                        y = (self._tensor(sample_y) if sample_y is not None
                             else torch.zeros_like(x))
                        self.module(x, train=False, labels=y)
                    else:
                        self.module(x, train=False)
                names = train_state.sown_metrics(self.module)
            self._metric_names = train_state.check_metric_names(names)
        return self._metric_names

    def sown_step_terms(self):
        """After a training forward: ``(aux, metrics)`` — the sum of the
        sown losses (None without any) and the sown metrics, whose names
        must be those discovered."""
        if not self._sows:
            return None, {}
        aux = None
        for v in train_state.sown_losses(self.module):
            aux = v.float() if aux is None else aux + v.float()
        sown = train_state.sown_metrics(self.module)
        train_state.check_train_metric_names(sown, self._metric_names)
        return aux, sown

    # -- state ---------------------------------------------------------------

    def build(self, sample_x=None, sample_y=None) -> TrainState:
        """Place the module on the device, check its parameters'
        placements on the mesh and bind the optimizer to its parameters.
        The module's parameters exist already (torch builds them at
        construction, from its own seed); a sample, where given, discovers
        the names of its sown metrics (`discover_metrics`)."""
        if self.state is None:
            self.module.to(self.device)
            self._place()
            self.tx.bind(self.module.parameters(),
                         shard_update=self.shard_update)
            self.state = TrainState(step=0, model=self.module,
                                    optimizer=self.tx, rng=self.seed,
                                    mesh=self.mesh,
                                    placements=self.placements)
        if sample_x is not None:
            self.discover_metrics(sample_x, sample_y)
        return self.state

    def stream_cursor(self, epoch: int, step: int) -> dict | None:
        """The stream cursor of training position "``step`` optimizer steps
        into epoch ``epoch``" of the current fit, in the JAX package's
        record form (`data.stream.CURSOR_FORMAT`); None before a fit set a
        feed. Checkpoint callbacks stamp it into the progress manifest,
        where the supervisor reads ``steps_per_epoch``."""
        if self._stream_geometry is None:
            return None
        return {"format": stream.CURSOR_FORMAT, "kind": "fit",
                "seed": int(self.seed), "epoch": int(epoch),
                "step": int(step), "position": dict(self._stream_geometry)}

    def _tensor(self, a):
        """``a`` on the device: an array, or a dict/tuple of them leaf by
        leaf."""
        def one(leaf):
            if isinstance(leaf, torch.Tensor):
                return leaf.to(self.device)
            return torch.as_tensor(np.asarray(leaf), device=self.device)

        return collectives.tree_map(one, a)

    def _loss_and_correct(self, x, y, *, train: bool, seed=None):
        """(per-example/per-token loss, per-example/per-token correct) over
        the global batch's rows of this shard — on a live ``seq`` axis
        joined over the group (module docstring); the sown values of the
        forward are left in the module."""
        if self._sows:
            train_state.clear_sown(self.module)
        group = self.seq_group if self.seq_shards > 1 else None
        if self._module_loss:
            loss_vec, correct = self.module(x, train=train, labels=y,
                                            dropout_seed=seed)
        else:
            logits = self.module(x, train=train, dropout_seed=seed)
            if group is not None and not self._token_loss:
                logits = collectives.all_gather_tiled(logits, group, 1)
                if self._seq_sharded(y, 1):
                    with torch.no_grad():
                        y = collectives.all_gather_tiled(y, group, 1)
                return self.loss_fn(logits, y), _correct(logits, y)
            loss_vec, correct = self.loss_fn(logits, y), _correct(logits, y)
        if group is None:
            return loss_vec, correct
        with torch.no_grad():
            correct = collectives.all_gather_tiled(correct, group, 1)
        return collectives.all_gather_tiled(loss_vec, group, 1), correct

    def _dropout_seed(self, micro: int, step: int | None = None) -> int:
        """The seed of optimizer step ``step`` (default: the next one) —
        JAX's ``fold_in(rng, step)`` — made distinct per batch shard (the
        ranks of an expert group draw alike) and, when accumulating, per
        microbatch."""
        seed = self.state.step_seed(step)
        if self.dp > 1:
            seed = derive_seed(seed, self.data_index)
        if self.seq_shards > 1:
            seed = derive_seed(seed, self.mesh.seq_index)
        if self._accum_steps > 1:
            seed = derive_seed(seed, micro)
        return seed

    def train_step(self, x, y) -> dict:
        """One optimizer step on the batch ``(x, y)`` (numpy or tensors),
        eagerly, at ``update_scale`` — with ``backward_passes_per_step=K``,
        on K microbatches of one shape: ``x``/``y`` are then length-K
        sequences (or arrays with a leading K axis). The step is the fit's
        (`graphs.StepRunner`), run without a graph. Returns ``{"loss",
        "accuracy"}`` (the mean over the microbatches) as 0-d tensors on
        the device, with no host sync. Gradients stay in ``.grad`` until
        the next step."""
        self.build(x, y)
        micro = [(x, y)] if self._accum_steps == 1 else list(zip(x, y))
        if len(micro) != self._accum_steps:
            raise ValueError(f"got {len(micro)} microbatches, want "
                             f"backward_passes_per_step={self._accum_steps}")
        xs = [self._tensor(self.cut(xb, 0)) for xb, _ in micro]
        ys = [self._tensor(self.cut(yb, 1)) for _, yb in micro]

        def shapes(t):
            return [a.shape for a in collectives.tree_flatten(t)[0]]

        if any(shapes(a) != shapes(xs[0]) for a in xs) or any(
                shapes(b) != shapes(ys[0]) for b in ys):
            raise ValueError("the microbatches of a step must share a shape")
        rows = len(collectives.first_leaf(xs[0]))
        if self._step_runner is None:
            self._step_runner = StepRunner(self, batch_size=rows,
                                           max_steps=1, eager=True)
        runner = self._step_runner

        def cat(*leaves):
            return torch.cat(leaves)

        runner.feed(collectives.tree_map(cat, *xs),
                    collectives.tree_map(cat, *ys), rows)
        self.tx.set_scale(self.update_scale)
        runner.run(1)
        if not self.tx.lr_is_tensor:
            self.tx.set_scale(1.0)
        return runner.last

    # -- verbs ---------------------------------------------------------------

    def fit(self, dataset=None, *, x=None, y=None, batch_size: int = 128,
            epochs: int = 1, initial_epoch: int = 0, initial_step: int = 0,
            steps_per_epoch: int | None = None, callbacks=(),
            validation_data=None, shuffle_buffer: int | None = None,
            verbose: int | None = None, cache: str | None = None,
            _eager: bool = False) -> list[dict]:
        """Train epochs ``initial_epoch .. epochs-1`` of ``steps_per_epoch``
        optimizer steps on ``dataset`` (an `ArrayDataset` — its anchored
        ``batches`` stream — or any iterable of ``(x, y)`` numpy batches;
        ``steps_per_epoch`` required) or on arrays ``x``/``y``, this rank's
        shard in batches of ``batch_size`` (``steps_per_epoch`` defaults to
        the full batches of the shard).

        ``cache="device"`` (with ``x``/``y``) stages the data on the card
        once, rank r holding rows ``[r·n/size, (r+1)·n/size)``, and draws
        each epoch's order there from ``(seed, epoch)`` as the JAX trainer
        does; ``on_batch_end`` then fires once an epoch, or every
        ``HVT_EPOCH_CHUNK_STEPS`` steps, and validation runs cached too.
        On the card every step is a replay of one captured CUDA graph
        (`training.graphs`), captured again when a ``dataset=`` batch
        changes shape.

        ``initial_step`` resumes mid-epoch at optimizer step S of
        ``initial_epoch``: the stream is fast-forwarded past S × K batches
        without assembling them (an iterable without that hook draws and
        discards). Callbacks run in list order: ``on_train_begin`` after
        build, then per epoch ``on_epoch_begin``, ``on_batch_end(step,
        metrics)`` once per execution (a step, or a ``steps_per_execution``
        chunk, with its last step's metrics and true step index),
        ``on_epoch_end(epoch, logs)`` (logs mutable), and ``on_train_end``.

        Returns the history: per epoch the mean ``loss`` and ``accuracy``
        of its steps, ``epoch_time_s`` (host clock, ending with the
        metrics' fetch from the device) and, with ``validation_data``,
        ``val_loss``/``val_accuracy``. ``verbose`` defaults to 1 on the
        primary rank, 0 elsewhere."""
        return feeding.run_fit(
            self, dataset, x=x, y=y, batch_size=batch_size, epochs=epochs,
            initial_epoch=initial_epoch, initial_step=initial_step,
            steps_per_epoch=steps_per_epoch, callbacks=callbacks,
            validation_data=validation_data, shuffle_buffer=shuffle_buffer,
            verbose=verbose, cache=cache, eager=_eager)

    def evaluate(self, x, y, batch_size: int = 128, verbose: int = 0,
                 cache: str | None = None) -> dict:
        """Mean loss and accuracy over the whole of ``x``/``y`` (per token
        for sequence models), in eval mode. The rows are sharded over the
        ranks and the sums reduced, so every rank gets the global mean at
        1/size of the work: rank r takes rows r, r + size, ..., or with
        ``cache="device"`` the contiguous shard r of the padded set staged
        on the card (`feeding.evaluate_device_cached`)."""
        return feeding.run_evaluate(self, x, y, batch_size=batch_size,
                                    verbose=verbose, cache=cache)

    def predict(self, x, batch_size: int = 128) -> np.ndarray:
        """Class probabilities (softmax of the logits) as a numpy array —
        the full ``[N, T, ...]`` on every rank. ``x`` may be a dict or
        tuple of arrays. As in JAX, each call covers a global batch of
        ``batch_size`` rows a batch shard (the last padded by repeating
        its last row, the padding dropped): shard r runs rows ``[r ·
        batch_size, (r + 1) · batch_size)`` of it (and on a live ``seq``
        axis its columns), and the probabilities are gathered."""
        if self.state is None:
            raise RuntimeError("call fit() or build() first")
        if isinstance(x, list):
            x = np.asarray(x)
        out = []
        global_batch = batch_size * self.dp
        lo = self.data_index * batch_size
        with torch.inference_mode():
            for start in range(0, len(collectives.first_leaf(x)),
                               global_batch):
                xb, bs = feeding.slice_pad(x, start, global_batch)
                xb = collectives.tree_map(lambda a: a[lo:lo + batch_size],
                                          xb)
                logits = self.module(self._tensor(self.cut(xb, 0)),
                                     train=False)
                if self._seq_sharded(xb, 0):
                    logits = collectives.all_gather_tiled(
                        logits, self.seq_group, 1)
                probs = torch.softmax(logits.float(), dim=-1)
                if self.dp > 1:
                    probs = collectives.all_gather_tensor(
                        probs.contiguous(), self.batch_group).flatten(0, 1)
                out.append(probs[:bs].cpu().numpy())
        return np.concatenate(out, axis=0)
