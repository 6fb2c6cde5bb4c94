"""One optimizer step, captured once in a CUDA graph and replayed — the
port's counterpart of the JAX trainer's jitted ``_train_step`` /
``_train_chunk`` / ``_train_epoch`` (`horovod_tpu.training.trainer`).

`StepRunner` owns everything a captured step touches, at addresses that
never change while the graph lives:

* the batch source — the epoch's shuffled copy of a device-staged dataset
  (``fit(cache="device")``) or the buffers the streamed fit (``x=``/``y=``
  and ``dataset=``) copies each prefetched chunk into (`feed`) — and a
  device step counter ``t``: step ``t`` reads rows ``[t·K·B, (t+1)·K·B)``
  (K microbatches of B rows) with ``index_select`` on device indices, so
  no host integer is baked into the graph;
* a device table of dropout seeds, ``derive_seed(rng, step[, rank][,
  micro])`` computed on the host for the chunk's steps and uploaded once
  per chunk; the model folds and hashes them on the device
  (`ops.dropout`, a CUDA kernel on the card);
* the metric sums (JAX's ``metric_acc``: loss, accuracy and the module's
  sown metrics in their discovered order, f32), read once per epoch, and
  the last step's metrics, which `last_metrics` clones (the next replay
  overwrites them).

The optimizer runs in its capturable form with a device learning rate
(`DistributedOptimizer.set_scale` fills it outside the graph, once per
epoch). The gradient reduction is captured with the step when its
collectives can be captured: without a process group, or under NCCL once
its communicators exist — the all-reduce, the quantized wire's all-to-all
and all-gathers, ZeRO-1's reduce-scatter and its parameter all-gather
alike. Under gloo a collective goes through host memory, which a graph
cannot hold, so the step is two graphs — forward, backward and bucket
packing; then unpacking and the optimizer — around the eager reduction
(the quantized wire's quantization included), and under ZeRO-1 a third
graph copies the eagerly all-gathered shards into the parameters. Every
buffer the eager stages read or write (buckets, residuals, reduced
buckets, gathered shards) was allocated by a graph, at a fixed address.
A module whose forward itself reduces over the ranks (the global-batch
BatchNorm, an MoE layer's expert-group sums, a `TransformerLM` on a live
``model`` or ``fsdp`` axis) steps eagerly there (`eager_steps` counts
it); under NCCL its collectives are captured with the step. The backend
and the module decide, never a failure. Buffers a step updates (BN's running
statistics) are written in place, so their addresses hold.

``overlap_reduction`` issues each bucket's reduction from the backward of
the last microbatch (`DistributedOptimizer.arm_overlap`) in eager steps
and in one-graph captures; where the collectives sit between graphs
(gloo), and on a live ``seq``, ``model`` or ``fsdp`` axis
(`StepRunner._overlap_here`), it changes nothing. Under gloo a step on a
live ``seq`` axis runs eagerly: its attention and its loss communicate
through the host.

Before a runner captures for the first time, and again after `feed`
brought rows of another shape, one step runs eagerly on the capture
stream, as a real step: it creates the optimizer state (a fresh fit), the
NCCL communicator, cuDNN's plans and cuBLAS's workspaces for the shape.
Then the capture is taken, and it is taken again when the optimizer's
state tensors were rebound (`DistributedOptimizer.generation`) or, for an
optimizer with a float learning rate, when the scale changed. A capture
or a replay that fails raises. On the CPU, or with ``eager``, `run` calls
the same step function step by step (reading fed rows in place): the
plain version, and `Trainer.train_step`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from horovod_tpu_torch import runtime
from horovod_tpu_torch.parallel.collectives import tree_flatten, tree_map


def forward_communicates_over_host(module) -> bool:
    """Whether a train-mode forward of ``module`` makes collective calls
    that go through host memory: a layer that reduces over the ranks (a
    global-batch `models.resnet.BatchNorm`, an MoE layer on a live expert
    axis; ``reduces_over_ranks``) in a world of more than one rank under
    gloo. Its all-reduces sit inside the
    forward and the backward, where no graph split can leave them out, so
    such a step runs eagerly; under NCCL they are captured with it."""
    return (runtime.size() > 1 and runtime.backend() == "gloo"
            and any(getattr(m, "reduces_over_ranks", False)
                    for m in module.modules()))


def _host(a: np.ndarray, pinned: bool) -> torch.Tensor:
    """``a`` as a host tensor, in page-locked memory when it goes to the
    card: a copy from there does not make the host wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pinned else t


def _leaf_layout(tree) -> tuple:
    leaves, treedef = tree_flatten(tree)
    return (repr(treedef),) + tuple((tuple(a.shape[1:]), a.dtype)
                                    for a in leaves)


class StepRunner:
    """Optimizer steps of ``trainer`` on batches of ``batch_size`` rows
    read from ``src_x`` / ``src_y`` (device tensors of rows, K·B rows a
    step, or dicts/tuples of them for a model of several inputs — one
    buffer a leaf; or, left None, what `feed` brings), for at most
    ``max_steps`` steps between two `reset_counter` calls."""

    def __init__(self, trainer, src_x=None, src_y=None, *,
                 batch_size: int, max_steps: int, eager: bool = False):
        self.trainer = trainer
        self.src_x, self.src_y = src_x, src_y
        self.accum = trainer._accum_steps
        self.max_steps = max(1, int(max_steps))
        dev = self.device = trainer.device
        # On a live seq axis the attention and the loss's join communicate
        # inside the step, whatever the module.
        self.graphs = (dev.type == "cuda" and not eager
                       and not forward_communicates_over_host(trainer.module)
                       and not (trainer.seq_shards > 1
                                and runtime.backend() == "gloo"))
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self._t_host = 0
        self.seeds = torch.zeros((self.max_steps, self.accum),
                                 dtype=torch.int64, device=dev)
        self._set_batch_size(batch_size)
        self._size_metrics()
        self.last = None
        self.capture_guard = contextlib.nullcontext
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0  # steps run without a graph (warm-ups too)
        self._graphs: list = []
        self._packed = None
        self._packed_params = None
        self._key = None
        self._layout = None
        self._warm = False  # a step ran eagerly since the layout was set
        self._stream = torch.cuda.Stream(dev) if self.graphs else None

    def _size_metrics(self) -> None:
        names = self.trainer._metric_names or ()
        self.metric_sums = torch.zeros(2 + len(names), dtype=torch.float32,
                                       device=self.device)

    def _set_batch_size(self, batch_size: int) -> None:
        self.batch_size = int(batch_size)
        self.rows = torch.arange(self.batch_size, device=self.device)

    # -- host side -----------------------------------------------------------

    def reset_counter(self) -> None:
        """Step 0 of the source reads its first rows again."""
        self.t.zero_()
        self._t_host = 0

    def feed(self, x, y, batch_size: int) -> None:
        """The streamed paths' rows: ``x``/``y`` on the device hold n·K
        batches of ``batch_size`` rows (step, microbatch, row order), at
        most ``max_steps`` steps; step 0 reads their first rows. Replayed
        steps read them from the runner's own buffers, which they are
        copied into; rows of another batch shape or dtype replace the
        buffers and drop the graphs, so the next `run` steps once eagerly
        and captures again. Eager steps read ``x``/``y`` in place. A
        dict or tuple ``x`` (a model of several inputs) is one buffer a
        leaf."""
        layout = (int(batch_size), _leaf_layout(x), _leaf_layout(y))
        if layout != self._layout:
            self._drop_graphs()
            self._layout = layout
            self._set_batch_size(batch_size)
            self.src_x = self.src_y = None
        if not self.graphs:
            self.src_x, self.src_y = x, y
        else:
            if self.src_x is None:
                rows = self.max_steps * self.accum * self.batch_size
                self.src_x, self.src_y = (
                    tree_map(lambda a: a.new_empty((rows,) + a.shape[1:]), t)
                    for t in (x, y))
            for dst, src in ((self.src_x, x), (self.src_y, y)):
                tree_map(lambda d, s: d[:len(s)].copy_(s), dst, src)
        self.reset_counter()

    def zero_metrics(self) -> None:
        self.metric_sums.zero_()

    def _drop_graphs(self) -> None:
        if self._graphs:
            torch.cuda.synchronize()  # no replay still reads them
        self._graphs, self._packed, self._key = [], None, None
        self._packed_params = None
        self._warm = False

    def close(self) -> None:
        """Release the graphs and the buffers they read (the counts stay).
        A fit closes its runner when it ends: graphs that hold captured
        NCCL work must not outlive the process group."""
        self._drop_graphs()
        self.src_x = self.src_y = self.seeds = None

    def metric_means(self, steps: int) -> dict:
        """The epoch's mean loss, accuracy and sown metrics over ``steps``
        steps: the one fetch from the device."""
        names = self.trainer.metric_names
        return {k: v / steps for k, v in zip(names,
                                              self.metric_sums.tolist())}

    def last_metrics(self) -> dict:
        """Copies of the last step's metrics (0-d device tensors)."""
        return {k: v.clone() for k, v in self.last.items()}

    def _upload_seeds(self, n: int) -> None:
        tr = self.trainer
        first = tr.state.step
        seeds = [[tr._dropout_seed(k, step=first + i)
                  for k in range(self.accum)] for i in range(n)]
        lo = self._t_host
        if lo + n > len(self.seeds):
            raise ValueError(f"{lo + n} steps since the last reset, the "
                             f"runner holds seeds for {len(self.seeds)}")
        self.seeds[lo:lo + n].copy_(
            _host(np.asarray(seeds, dtype=np.int64), self.graphs),
            non_blocking=True)

    def run(self, n: int) -> None:
        """``n`` optimizer steps, each reading the next rows of the source;
        ``trainer.state.step`` advances by ``n``."""
        if n <= 0:
            return
        tr = self.trainer
        if tr._metric_names is None:
            # Before any step: one eval-mode forward of the first rows
            # names the module's sown metrics (JAX's build-time init).
            b = self.batch_size
            tr.discover_metrics(tree_map(lambda a: a[:b], self.src_x),
                                tree_map(lambda a: a[:b], self.src_y))
            self._size_metrics()
        self._upload_seeds(n)
        self._t_host += n
        tr.tx.state_changed()
        tr.state.model_changed()
        if self.graphs and self._stale():
            if not self._warm:
                self._warm_up()
                self._warm = True
                tr.state.step += 1
                n -= 1
            if n:
                self._capture()
        for _ in range(n):
            if self.graphs:
                self._replay()
            else:
                self._step()
            tr.state.step += 1

    # -- the step -------------------------------------------------------------

    def _forward_backward(self) -> None:
        tr = self.trainer
        tr.tx.zero_grad()
        B, K = self.batch_size, self.accum
        seeds = self.seeds.index_select(0, self.t.view(1)).view(-1)
        rows = []
        for k in range(K):
            idx = (self.t * K + k) * B + self.rows
            x = tree_map(lambda a: a.index_select(0, idx), self.src_x)
            y = tree_map(lambda a: a.index_select(0, idx), self.src_y)
            loss_vec, correct = tr._loss_and_correct(x, y, train=True,
                                                     seed=seeds[k])
            # JAX's forward_loss: the mean loss plus every sown loss.
            aux, sown = tr.sown_step_terms()
            loss = loss_vec.mean()
            if aux is not None:
                loss = loss + aux
            if k == K - 1 and self._overlap_here():
                tr.tx.arm_overlap()
            loss.backward()
            rows.append([loss.detach(), correct.mean().detach()]
                        + [sown[n].detach() for n in tr._metric_names])
        if K == 1:
            values = torch.stack(rows[0])
        else:
            values = torch.stack([torch.stack(col).mean()
                                  for col in zip(*rows)])
        self.metric_sums.add_(values)
        self.last = dict(zip(tr.metric_names, values.unbind()))
        self.t.add_(1)

    def _overlap_here(self) -> bool:
        """Whether a bucket's reduction may issue inside the backward: in
        eager steps, and in captures that hold the collectives — never on
        a live ``seq``, ``model`` or ``fsdp`` axis, where the backward's
        own collectives (the ring's shifts, Megatron's f, FSDP's
        reduce-scatters) would interleave with the bucket sums in an order
        that can differ by rank (on one NCCL stream that order is a
        deadlock)."""
        mesh = self.trainer.mesh
        if mesh is not None and max(mesh.shape["seq"], mesh.shape["model"],
                                    mesh.shape["fsdp"]) > 1:
            return False
        return not self.graphs or runtime.backend() != "gloo"

    def _step(self) -> None:
        """One whole step, eagerly (the plain version, and the warm-up)."""
        self.eager_steps += 1
        tx = self.trainer.tx
        self._forward_backward()
        packed = tx.pack_gradients()
        tx.communicate(packed)
        packed_params = tx.apply(packed)
        tx.communicate_params(packed_params)
        tx.unpack_params(packed_params)

    # -- graphs ---------------------------------------------------------------

    def _capture_key(self):
        tx = self.trainer.tx
        lrs = () if tx.lr_is_tensor else tuple(
            g["lr"] for g in tx.optimizer.param_groups)
        return tx.generation, lrs

    def _stale(self) -> bool:
        return not self._graphs or self._key != self._capture_key()

    def _warm_up(self) -> None:
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._step()
        torch.cuda.current_stream().wait_stream(stream)

    def _capture(self) -> None:
        """Capture the step: one graph when the reduction's collectives can
        be captured (no process group, or NCCL), else two graphs around the
        eager reduction and, under ZeRO-1, a third after the eager
        parameter all-gather."""
        in_graph = runtime.backend() != "gloo"
        stream = self._stream
        self._graphs = []
        packed_params = None
        torch.cuda.synchronize()
        stream.wait_stream(torch.cuda.current_stream())
        with self.capture_guard(), torch.cuda.stream(stream):
            tx = self.trainer.tx
            tx.zero_grad()
            first = torch.cuda.CUDAGraph()
            with torch.cuda.graph(first, stream=stream):
                self._forward_backward()
                packed = tx.pack_gradients()
                if in_graph:
                    tx.communicate(packed)
                    packed_params = tx.apply(packed)
                    tx.communicate_params(packed_params)
                    tx.unpack_params(packed_params)
            self._graphs.append(first)
            if not in_graph:
                second = torch.cuda.CUDAGraph()
                with torch.cuda.graph(second, stream=stream,
                                      pool=first.pool()):
                    packed_params = tx.apply(packed)
                self._graphs.append(second)
                if packed_params is not None:
                    third = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(third, stream=stream,
                                          pool=first.pool()):
                        tx.unpack_params(packed_params)
                    self._graphs.append(third)
        torch.cuda.current_stream().wait_stream(stream)
        self._packed = packed
        self._packed_params = packed_params
        self._key = self._capture_key()
        self.captures += 1

    def _replay(self) -> None:
        first, *rest = self._graphs
        first.replay()
        if rest:
            tx = self.trainer.tx
            tx.communicate(self._packed)
            rest[0].replay()
            if len(rest) > 1:
                tx.communicate_params(self._packed_params)
                rest[1].replay()
        self.replays += 1
