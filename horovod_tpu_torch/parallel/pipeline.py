"""Pipeline parallelism — port of `horovod_tpu.parallel.pipeline`: the GPipe,
1F1B and interleaved schedules over a mesh's ``pipe`` subgroup.

The JAX package runs a pipeline as one SPMD program: every pipe device runs
the same ``lax.scan`` of ticks, hands its output on with ``ppermute``,
computes its bubble ticks on garbage and masks their results out, and gets
the backward from AD (GPipe, interleaved) or from a hand-scheduled reverse
scan (1F1B). The port runs what a pipeline is on GPUs: one rank a stage,
the activations and their cotangents crossing stages by point-to-point
sends (`collectives.pipe_exchange`). It keeps JAX's tick table — at tick
t, stage s works on u = t − s = r·T + m, microbatch m of round r (round 0
only, outside the interleaved schedule), while 0 ≤ u < v·T — and does no
work on a bubble tick.

Each schedule is one `torch.autograd.Function` whose forward runs the tick
loop and whose backward runs the reverse loop on this rank, so the order of
every rank's sends and receives is fixed by the tick table, never by the
autograd engine:

* `spmd_pipeline` (GPipe): the forward records each stage pass's graph; the
  backward walks the forward's ticks in reverse, hands each cotangent back
  to the stage it came from, and back-propagates through the recorded
  passes (what JAX's AD of the scan computes).
* `spmd_pipeline_1f1b`: the forward keeps only each microbatch's stage
  input (the 1F1B activation stash); the backward is JAX's staggered loop —
  at backward tick τ stage s drains microbatch τ − (S − 1 − s), the last
  stage first — recomputing each stage pass under ``torch.enable_grad``
  and differentiating it with ``torch.autograd.grad``.
* `spmd_pipeline_interleaved`: ``n_virtual`` chunks a rank, chunk r of
  stage d holding logical chunk r·S + d; the wrap S − 1 → 0 arrives early
  and waits, keyed by microbatch, until its round comes; ``v·T + S − 1``
  ticks. Its backward is GPipe's, over the same ticks.

Unlike JAX's GPipe, every schedule takes its parameters explicitly
(``stage_fn(params, act)``), as JAX's 1F1B does: the Function returns their
gradients. Two arguments carry what JAX's schedules carry beside the
activations. ``extras``, per-microbatch constants (a packed batch's segment
ids and positions), is a tuple of ``[n_micro, ...]`` tensors: each pass
indexes microbatch m's rows directly (``stage_fn(params, act, extra)``),
nothing of them rides the handoffs, and they take no gradient.
``with_aux``: a pass returns ``(act, aux)``, ``aux`` a dict of scalars (an
MoE block's load-balance loss and fill), which the schedule sums over this
rank's passes and returns beside the outputs. The sums are differentiable:
each pass gets their cotangent in its own backward, through the recorded
pass (GPipe, interleaved) or the recomputed one (1F1B).

The outputs are the last stage's, broadcast over ``pipe``
(`collectives.pipe_broadcast_last`, JAX's masked ``psum``), whose backward
keeps the last stage's cotangent, so the gradients are the sequential
model's, not S times them. The cotangent of the stage-0 input is broadcast
from stage 0 in the backward — the transpose of its replication over
``pipe``, JAX's ``psum`` of ``x_micro``'s cotangent — so what feeds it
(the embedding) gets the same gradient on every stage. `stats` records the
last call's tick counts and the passes this rank ran.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.parallel import collectives

#: The last schedule run on this rank: ``schedule``, ``ticks`` and
#: ``backward_ticks`` (the tick model's counts), and the stage passes this
#: rank ran, ``forward`` ``[(tick, microbatch, round)]`` and ``backward``
#: (the same, for the passes of the backward loop, in its order).
stats: dict = {}


def stage_slice_size(n_layers: int, n_stages: int) -> int:
    """Layers per stage; n_layers must divide evenly."""
    if n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers ({n_layers}) must be divisible by pipe ({n_stages})"
        )
    return n_layers // n_stages


def interleaved_layer_order(n_layers: int, n_stages: int,
                            n_virtual: int) -> list[int]:
    """Physical row ``p`` → logical layer index, for the interleaved
    layout: stage d holds logical chunks ``d, d+S, ..., d+(v-1)·S`` in its
    contiguous rows, so stacks are stored device-major, round-minor
    (placement order). `models.pipelined_lm.to_logical_order` /
    `to_interleaved_order` convert."""
    if n_layers % (n_stages * n_virtual) != 0:
        raise ValueError(
            f"n_layers ({n_layers}) must divide into n_stages ({n_stages}) "
            f"x n_virtual ({n_virtual}) chunks"
        )
    lpc = n_layers // (n_stages * n_virtual)
    order = []
    for d in range(n_stages):
        for r in range(n_virtual):
            c = r * n_stages + d
            order.extend(range(c * lpc, (c + 1) * lpc))
    return order


# -- the tick model ------------------------------------------------------------


def forward_ticks(n_stages: int, n_micro: int, n_virtual: int = 1) -> int:
    """Ticks of the forward schedule: ``v·T + S − 1`` (GPipe's
    T + S − 1)."""
    return n_virtual * n_micro + n_stages - 1


def work(t: int, stage: int, n_micro: int, n_virtual: int = 1):
    """``(round, microbatch)`` stage ``stage`` works on at tick ``t`` (u =
    t − stage = round·T + microbatch), or None on a bubble tick."""
    u = t - stage
    return divmod(u, n_micro) if 0 <= u < n_virtual * n_micro else None


def tick_table(stage: int, n_stages: int, n_micro: int,
               n_virtual: int = 1) -> list:
    """The forward passes of ``stage``, in tick order: ``(tick,
    microbatch, round)``; n_micro × n_virtual of them."""
    out = []
    for t in range(forward_ticks(n_stages, n_micro, n_virtual)):
        w = work(t, stage, n_micro, n_virtual)
        if w is not None:
            out.append((t, w[1], w[0]))
    return out


def drain_table(stage: int, n_stages: int, n_micro: int) -> list:
    """1F1B's backward passes of ``stage``, in tick order: ``(τ,
    microbatch)`` with microbatch τ − (S − 1 − stage), over T + S − 1
    ticks — the last stage drains first."""
    lag = n_stages - 1 - stage
    return [(tau, tau - lag) for tau in range(n_micro + n_stages - 1)
            if 0 <= tau - lag < n_micro]


class _Ring:
    """This rank's place on the ``pipe`` group and the tick model it
    runs: S stages, this one s, T microbatches, v rounds."""

    def __init__(self, group, n_micro: int, n_virtual: int):
        self.group = group
        self.S = collectives.group_size(group)
        self.s = collectives.group_rank(group)
        self.T, self.v = n_micro, n_virtual
        self.ticks = forward_ticks(self.S, n_micro, n_virtual)

    def work(self, t: int, stage: int | None = None):
        return work(t, self.s if stage is None else stage, self.T, self.v)

    def final(self, stage: int, r: int) -> bool:
        """Whether ``stage``'s pass of round ``r`` is the model's last."""
        return stage == self.S - 1 and r == self.v - 1

    def sends(self, t: int, stage: int | None = None) -> bool:
        """Whether ``stage`` hands an output on at tick ``t``."""
        stage = self.s if stage is None else stage
        w = self.work(t, stage)
        return w is not None and not self.final(stage, w[0])

    def exchange(self, t: int, sends, recvs) -> list:
        """`collectives.pipe_exchange` over the group at tick ``t``; a
        one-stage ring hands its own sends back."""
        if self.S == 1:
            return [x for _, x in sends]
        return collectives.pipe_exchange(sends, recvs, self.group, tag=t)


class _Pass:
    """One stage pass: ``stage_fn`` on the parameters and an activation,
    with microbatch m's ``extras`` where given. Returns ``(act, aux)``,
    ``aux`` the pass's aux values in key order (``keys``; empty without
    ``with_aux``)."""

    def __init__(self, stage_fn, extras, with_aux: bool):
        self.stage_fn, self.extras, self.with_aux = stage_fn, extras, with_aux
        self.keys: list = []

    def __call__(self, params, act, m: int):
        if self.extras is None:
            res = self.stage_fn(params, act)
        else:
            res = self.stage_fn(params, act, tuple(e[m] for e in self.extras))
        if not self.with_aux:
            return res, []
        out, aux = res
        self.keys = sorted(aux)
        return out, [aux[k] for k in self.keys]


def _forward(ring, pass_fn, x_micro):
    """The forward tick loop: ``pass_fn(act, r, m)`` runs this stage's pass
    of round r on microbatch m and returns ``(act, aux)``. Returns the last
    stage's outputs by microbatch (None elsewhere) and the aux values
    summed over this rank's passes; records the passes."""
    s, T, S = ring.s, ring.T, ring.S
    prev, nxt = (s - 1) % S, (s + 1) % S
    held: dict = {}  # microbatch -> the activation that came for it
    outs = [None] * T
    aux_sums: list = []
    passes = []
    for t in range(ring.ticks):
        w = ring.work(t)
        sends = []
        if w is not None:
            r, m = w
            inp = x_micro[m] if s == 0 and r == 0 else held.pop(m)
            out, aux = pass_fn(inp, r, m)
            aux_sums = ([a.clone() for a in aux] if not passes
                        else [acc + a for acc, a in zip(aux_sums, aux)])
            passes.append((t, m, r))
            if ring.final(s, r):
                outs[m] = out
            else:
                sends = [(nxt, out)]
        arrives = ring.sends(t, prev)
        got = ring.exchange(t, sends,
                            [(prev, x_micro[0])] if arrives else [])
        if arrives:
            held[ring.work(t, prev)[1]] = got[0]
    stats.update(ticks=ring.ticks, forward=passes)
    return outs, aux_sums


def _stacked(ring, outs, x_micro):
    """The last stage's outputs ``[T, ...]``; zeros on the other stages
    (JAX's masked buffer)."""
    if ring.s == ring.S - 1:
        return torch.stack(outs)
    return torch.zeros_like(x_micro)


def _differentiate(outs, a, leaves, cots, acc: list):
    """The cotangent of pass input ``a`` given ``cots`` for the pass's
    outputs ``outs`` (its activation, then its aux values; those that take
    no gradient are left out); the parameters' (those that take a
    gradient) added into ``acc``."""
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    wrt = [i for i, p in enumerate(leaves) if p.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs],
                                [a] + [leaves[i] for i in wrt],
                                [c.to(o.dtype) for o, c in pairs],
                                allow_unused=True)
    for i, g in zip(wrt, grads[1:]):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g
    return grads[0]


def _input_grad(ring, dx, x_micro):
    """The cotangent of ``x_micro``: stage 0's, broadcast over the group
    (the transpose of the input's replication over ``pipe``)."""
    if ring.s == 0:
        full = torch.stack(dx).to(x_micro.dtype)
    else:
        full = torch.zeros_like(x_micro)
    if ring.S == 1:
        return full
    return collectives.broadcast_in_group(full, ring.group, 0)


def _backward_recorded(ring, graphs, g, g_aux, leaves, x_micro):
    """GPipe's and the interleaved schedule's backward: the forward's
    ticks in reverse. At each, first the transpose of that tick's
    exchange (this stage hands back the cotangent of what it received then,
    and receives the cotangent of what it sent), then the backward of the
    tick's recorded pass, its aux values taking ``g_aux``."""
    s, S, T = ring.s, ring.S, ring.T
    prev, nxt = (s - 1) % S, (s + 1) % S
    dparams = [None] * len(leaves)
    dx = [None] * T
    pending: dict = {}  # tick an input arrived -> its cotangent
    cot: dict = {}  # (round, microbatch) -> this pass's output cotangent
    passes = []
    for t in reversed(range(ring.ticks)):
        w = ring.work(t)
        sent = ring.sends(t)
        got = ring.exchange(
            t, [(prev, pending.pop(t))] if ring.sends(t, prev) else [],
            [(nxt, x_micro[0])] if sent else [])
        if sent:
            cot[w] = got[0]
        if w is None:
            continue
        r, m = w
        a, outs = graphs.pop(w)
        c = g[m] if ring.final(s, r) else cot.pop(w)
        da = _differentiate(outs, a, leaves, [c, *g_aux], dparams)
        passes.append((t, m, r))
        if s == 0 and r == 0:
            dx[m] = da
        else:  # arrived from the previous stage, or over the wrap
            pending[t - 1 if s else (r - 1) * T + m + S - 1] = da
    stats.update(backward_ticks=ring.ticks, backward=passes)
    return _input_grad(ring, dx, x_micro), dparams


def _backward_1f1b(ring, call, saved, g, g_aux, leaves, x_micro):
    """JAX's staggered 1F1B backward: at tick τ this stage recomputes and
    differentiates its pass of microbatch τ − (S − 1 − s) (its aux values
    taking ``g_aux``), then hands the input's cotangent to the previous
    stage and takes the next one's."""
    s, S, T = ring.s, ring.S, ring.T
    dparams = [None] * len(leaves)
    dx = [None] * T
    cot_in = None
    passes = []
    table = dict(drain_table(s, S, T))
    for tau in range(T + S - 1):
        sends = []
        if tau in table:
            m = table[tau]
            c = g[m] if s == S - 1 else cot_in
            a = saved[m].detach().requires_grad_()
            saved[m] = None
            with torch.enable_grad():
                out, aux = call(leaves, a, m)
            da = _differentiate([out, *aux], a, leaves, [c, *g_aux],
                                dparams)
            passes.append((tau, m, 0))
            if s == 0:
                dx[m] = da
            else:
                sends = [(s - 1, da)]
        nxt_drains = s < S - 1 and 0 <= tau - (S - 2 - s) < T
        got = ring.exchange(tau, sends, [(s + 1, x_micro[0])] if nxt_drains
                            else [])
        if nxt_drains:
            cot_in = got[-1]
    stats.update(backward_ticks=T + S - 1, backward=passes)
    return _input_grad(ring, dx, x_micro), dparams


class _Schedule(torch.autograd.Function):
    """One schedule's forward and backward tick loops on this rank (module
    docstring); the inputs are ``x_micro`` and the parameters, the outputs
    the stacked activations and, with aux, the aux sums."""

    @staticmethod
    def forward(ctx, kind, call, ring, x_micro, *params):
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        ctx.kind, ctx.ring, ctx.call = kind, ring, call
        ctx.leaves, ctx.x_micro = leaves, x_micro.detach()
        if kind == "1f1b":
            saved = [None] * ring.T

            def pass_fn(inp, r, m):
                saved[m] = inp
                return call(leaves, inp, m)

            ctx.saved = saved
        else:
            graphs: dict = {}

            def pass_fn(inp, r, m):
                a = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out, aux = call(_chunk(kind, leaves, r), a, m)
                graphs[(r, m)] = (a, [out, *aux])
                return out.detach(), [v.detach() for v in aux]

            ctx.graphs = graphs
        outs, aux = _forward(ring, pass_fn, x_micro)
        stacked = _stacked(ring, outs, x_micro)
        return (stacked, *aux) if call.with_aux else stacked

    @staticmethod
    def backward(ctx, g, *g_aux):
        ring, leaves, x = ctx.ring, ctx.leaves, ctx.x_micro
        if ctx.kind == "1f1b":
            dx, dparams = _backward_1f1b(ring, ctx.call, ctx.saved, g, g_aux,
                                         leaves, x)
        else:
            dx, dparams = _backward_recorded(ring, ctx.graphs, g, g_aux,
                                             leaves, x)
        dparams = [torch.zeros_like(p) if d is None else d.to(p.dtype)
                   for p, d in zip(leaves, dparams)]
        return (None, None, None, dx, *dparams)


def _chunk(kind: str, params, r: int):
    """Round ``r``'s parameters: chunk r of each ``[v, ...]`` stack under
    the interleaved schedule, the stage's stacks otherwise."""
    return [p[r] for p in params] if kind == "interleaved" else params


def _run(kind, stage_fn, stage_params, x_micro, group, n_virtual, extras,
         with_aux):
    ring = _Ring(group, x_micro.shape[0], n_virtual)
    collectives.pipe_ready(group)
    params = list(stage_params)
    call = _Pass(stage_fn, None if extras is None else tuple(extras),
                 with_aux)
    stats.clear()
    stats["schedule"] = kind
    if torch.is_grad_enabled() and (
            x_micro.requires_grad or any(p.requires_grad for p in params)):
        res = _Schedule.apply(kind, call, ring, x_micro, *params)
        out, aux = (res[0], list(res[1:])) if with_aux else (res, [])
    else:
        outs, aux = _forward(ring, lambda inp, r, m: call(
            _chunk(kind, params, r), inp, m), x_micro)
        out = _stacked(ring, outs, x_micro)
    out = collectives.pipe_broadcast_last(out, group)
    return (out, dict(zip(call.keys, aux))) if with_aux else out


def spmd_pipeline(stage_fn, stage_params, x_micro, *, group, extras=None,
                  with_aux: bool = False):
    """GPipe over ``group`` (a mesh's ``pipe`` subgroup): ``stage_fn(
    params, act [mb, ...]) -> act`` is this rank's stage, over its stage
    parameters ``stage_params`` (a list of tensors); ``x_micro`` ``[n_micro,
    mb, ...]`` the stage-0 input, the same on every stage. Returns the last
    stage's outputs ``[n_micro, mb, ...]`` on every stage. The backward
    back-propagates through the forward's recorded passes (module
    docstring). ``extras`` (a tuple of ``[n_micro, ...]`` tensors, no
    gradient): ``stage_fn(params, act, extra)`` gets microbatch m's rows
    of each. ``with_aux``: ``stage_fn`` returns ``(act, aux)``, ``aux`` a
    dict of scalars, and the call ``(outputs, aux)`` with each value
    summed over this rank's passes, differentiable."""
    return _run("gpipe", stage_fn, stage_params, x_micro, group, 1, extras,
                with_aux)


def spmd_pipeline_1f1b(stage_fn, stage_params, x_micro, *, group,
                       extras=None, with_aux: bool = False):
    """`spmd_pipeline`'s function with the 1F1B memory discipline: the
    forward keeps each microbatch's stage input only, and the backward
    recomputes each pass in JAX's staggered order (module docstring);
    ``extras`` and ``with_aux`` as there."""
    return _run("1f1b", stage_fn, stage_params, x_micro, group, 1, extras,
                with_aux)


def spmd_pipeline_interleaved(chunk_fn, chunk_params, x_micro, *,
                              n_virtual: int, group, extras=None,
                              with_aux: bool = False):
    """The interleaved (virtual-stage) schedule: ``chunk_params`` are this
    stage's ``[v, layers_per_chunk, ...]`` stacks, chunk r holding logical
    chunk r·S + stage; ``chunk_fn(one chunk's params, act) -> act``.
    Needs ``n_micro >= S`` when v > 1 (the wrap must not outrun the
    schedule). ``extras`` and ``with_aux`` as in `spmd_pipeline`."""
    n_micro = x_micro.shape[0]
    n_stages = collectives.group_size(group)
    if n_virtual > 1 and n_micro < n_stages:
        raise ValueError(
            f"interleaved schedule needs n_micro ({n_micro}) >= n_stages "
            f"({n_stages}) — the ring wrap would outrun the schedule"
        )
    return _run("interleaved", chunk_fn, chunk_params, x_micro, group,
                n_virtual, extras, with_aux)
