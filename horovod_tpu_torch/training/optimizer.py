"""DistributedOptimizer — gradient-averaging wrap of a torch optimizer;
port of `horovod_tpu.training.optimizer`.

After the backward, each rank packs its gradients into dtype-homogeneous
buckets of at most ``HVT_BUCKET_BYTES`` (default 64 MB, the JAX layout of
`collectives.flatten_buckets`), casts f32 buckets to the wire dtype
(``bf16``/``fp16``), sums each bucket over the ranks in that dtype with one
all-reduce, casts back, divides by the world size (and by K with
``average_aggregated_gradients``), and unpacks — the JAX trainer's explicit
boundary reduction. A single process without a process group runs the
same arithmetic over a world of 1 (the wire round-trip included). The
reduction comes in three stages (`pack_gradients`, `communicate`,
`unpack_gradients`) so that a captured CUDA-graph step can hold all three,
or, where the collective goes through the host (gloo), leave the middle
one out of its graphs.

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
import os

import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.parallel import collectives
from horovod_tpu_torch.parallel.mesh import scale_lr  # noqa: F401 (re-export)

_WIRES = {
    "none": None,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
}
_QUANTIZED_WIRES = ("int8", "fp8")


class Compression:
    """Horovod's ``hvd.Compression`` enum: the string knobs
    `DistributedOptimizer` accepts (``int8``/``fp8`` are not ported)."""

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


def _not_ported_wire(knob: str, value: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} is not ported yet — ROADMAP queue A item 11 "
        "(quantized wires with error feedback, the two-hop ICI wire)"
    )


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
      compression: ``"none"`` | ``"bf16"`` | ``"fp16"`` — the all-reduce's
        wire dtype for f32 gradients. ``"int8"``/``"fp8"`` raise.
      compression_ici: the JAX package's second-hop wire; only ``"none"``.

    The fusion-bucket size is ``HVT_BUCKET_BYTES`` (default 64 MB), or the
    `Trainer`'s ``bucket_bytes=``, which sets ``self.bucket_bytes``.
    """

    def __init__(self, optimizer, average: bool = True,
                 backward_passes_per_step: int = 1,
                 average_aggregated_gradients: bool = False,
                 compression: str = "none", compression_ici: str = "none"):
        for knob, value in (("compression", compression),
                            ("compression_ici", compression_ici)):
            if value in _QUANTIZED_WIRES:
                raise _not_ported_wire(knob, value)
            if value not in _WIRES:
                raise ValueError(
                    f"unknown {knob} {value!r}; expected one of "
                    f"{sorted(_WIRES) + list(_QUANTIZED_WIRES)}"
                )
        if compression_ici != "none":
            raise _not_ported_wire("compression_ici", compression_ici)
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        self.average = average
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.average_aggregated_gradients = bool(average_aggregated_gradients)
        self.wire_dtype = _WIRES[compression]
        self.bucket_bytes = int(
            os.environ.get("HVT_BUCKET_BYTES")
            or collectives.DEFAULT_BUCKET_BYTES
        )
        self._factory = None
        self.optimizer = None
        if isinstance(optimizer, torch.optim.Optimizer):
            self._set(optimizer)
        elif callable(optimizer):
            self._factory = optimizer
        else:
            raise TypeError(
                "optimizer must be a torch.optim.Optimizer or a factory "
                f"params -> Optimizer, got {type(optimizer).__name__}"
            )

    def _set(self, optimizer) -> None:
        self.optimizer = optimizer
        self._base_lrs = [float(g["lr"]) for g in optimizer.param_groups]
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

    def bind(self, params) -> torch.optim.Optimizer:
        """The wrapped optimizer, built over ``params`` if it was given as
        a factory (an optimizer built already keeps its own)."""
        if self.optimizer is None:
            self._set(self._factory(list(params)))
        return self.optimizer

    def _params(self):
        for group in self.optimizer.param_groups:
            yield from group["params"]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The wrapped optimizer's state dict, every group's learning rate
        as its base float (never scaled, never a device tensor)."""
        sd = self.optimizer.state_dict()
        for group, base in zip(sd["param_groups"], self._base_lrs):
            group["lr"] = base
        return sd

    def load_state_dict(self, state: dict) -> None:
        """Adopt ``state``. Where every state tensor exists already with
        the same shape, the values are copied in place, so captured CUDA
        graphs stay valid; otherwise the optimizer loads it and
        `generation` moves on (graphs are captured again)."""
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

    @torch.no_grad()
    def pack_gradients(self):
        """The reduction's first stage: the gradients in fusion buckets,
        each f32 bucket cast to the wire dtype. Returns ``(params, buckets,
        wires, spec)``, or None when there is nothing to reduce (a world of
        1 with nothing to round or divide, or no gradients)."""
        live = runtime.is_distributed()
        if not live and self.wire_dtype is None and self._divisor() == 1:
            return None
        params = [p for p in self._params() if p.grad is not None]
        if not params:
            return None
        buckets, spec = collectives.flatten_buckets(
            [p.grad for p in params], self.bucket_bytes)
        # Each bucket is private to this call (or a view of the one
        # gradient it holds), so every op after this runs in place.
        wires = [b.to(self.wire_dtype)
                 if self.wire_dtype is not None and b.dtype == torch.float32
                 else b for b in buckets]
        return params, buckets, wires, spec

    @staticmethod
    def communicate(packed) -> None:
        """The second stage: sum each wire bucket over the ranks, in
        place (the identity without a process group)."""
        if packed is not None and runtime.is_distributed():
            for w in packed[2]:
                collectives.allreduce_(w, average=False)

    @torch.no_grad()
    def unpack_gradients(self, packed) -> None:
        """The last stage: back from the wire, divided, into ``.grad``."""
        if packed is None:
            return
        params, buckets, wires, spec = packed
        divisor = self._divisor()
        for b, w in zip(buckets, wires):
            if w is not b:
                b.copy_(w)
            if divisor != 1:
                b.div_(divisor)
        torch._foreach_copy_([p.grad for p in params],
                             collectives.unflatten_buckets(buckets, spec))

    def _divisor(self) -> int:
        return (runtime.size() if self.average else 1) * (
            self.backward_passes_per_step
            if self.average_aggregated_gradients else 1)

    def reduce_gradients(self) -> None:
        """Replace every ``.grad`` by its sum over the ranks (through the
        wire dtype), divided by the world size when averaging and by K when
        averaging the accumulated passes: `pack_gradients`, `communicate`,
        `unpack_gradients`."""
        packed = self.pack_gradients()
        self.communicate(packed)
        self.unpack_gradients(packed)

    def step(self, scale: float = 1.0) -> None:
        """Reduce, then one optimizer step with every group's learning rate
        multiplied by ``scale``; a float learning rate returns to its base
        after the step."""
        if self.optimizer is None:
            raise RuntimeError("bind() the optimizer to parameters first")
        self.set_scale(scale)
        try:
            self.reduce_gradients()
            self.optimizer.step()
        finally:
            if not self.lr_is_tensor:
                self.set_scale(1.0)
