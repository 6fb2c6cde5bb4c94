"""Per-process sharded input pipeline with tf.data-style chaining — port of
`horovod_tpu.data.loader`.

``ArrayDataset((x, y)).shard(rank, size).repeat().shuffle(10000, seed)
.batch(128)`` yields byte-identically the batches of the JAX package's
python engine: the same reservoir shuffle of the same ``(seed, epoch,
pass)``-seeded `numpy.random.RandomState`, the same epoch anchoring. Pure
numpy on the host; the trainer moves batches to the device.

`training_pipeline` (the trainer's ``fit(x=, y=)`` feed) takes the JAX
package's engine rule: the native C++ engine (`data.native_loader`, built
with ``g++`` at first use) whenever it is available and the shuffle covers
the whole data, the python engine otherwise (``HVT_NO_NATIVE=1``, no
compiler, a bounded shuffle buffer). The two engines' streams are
different byte streams; each equals its JAX counterpart's.

Batches may be any nesting of dicts, tuples and lists of arrays that share
dim 0 (``({"src": ..., "tgt": ...}, y)`` for a dict-input model): the
transforms and both engines work on the flat leaves, in ``jax.tree_util``
order (dict keys sorted), and every batch is rebuilt with the same
structure.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from horovod_tpu_torch.analysis import registry
from horovod_tpu_torch.data import stream as stream_lib
from horovod_tpu_torch.parallel.collectives import tree_flatten, tree_unflatten


class ArrayDataset:
    """An in-memory dataset of parallel arrays with chained transforms.

    ``arrays`` is one array or any nesting of dicts, tuples and lists of
    same-leading-dim arrays; the transforms work on the flat leaves and
    batches are yielded with the same structure."""

    def __init__(self, arrays):
        leaves, self._treedef = tree_flatten(arrays)
        self._arrays = tuple(np.asarray(a) for a in leaves)
        n = self._arrays[0].shape[0]
        if any(a.shape[0] != n for a in self._arrays):
            raise ValueError("all arrays must share the leading dimension")
        self._repeat = False
        self._shuffle_buffer = 0
        self._batch_size = None
        self._drop_remainder = True
        self._seed = 0
        # `shard()` keeps the unsharded arrays so `reshard()` can recut the
        # split at another world size from the full data.
        self._unsharded = None
        self._shard_spec = None

    @classmethod
    def from_tensor_slices(cls, arrays) -> "ArrayDataset":
        return cls(arrays)

    @property
    def num_examples(self) -> int:
        return self._arrays[0].shape[0]

    @property
    def arrays(self) -> tuple:
        """The flat leaves (what the native engine consumes); `structure`
        rebuilds a batch from them."""
        return self._arrays

    @property
    def structure(self):
        """The structure batches are yielded with (a
        `collectives.tree_flatten` treedef)."""
        return self._treedef

    @property
    def shard_spec(self) -> tuple[int, int] | None:
        """(index, count) of this view's split; None if unsharded."""
        return self._shard_spec

    def shard(self, index: int, count: int) -> "ArrayDataset":
        """Keep every count-th example starting at index (per-process
        split)."""
        if not (0 <= index < count):
            raise ValueError(f"shard index {index} out of range for count {count}")
        ds = self._clone()
        ds._unsharded = self._unsharded or self._arrays
        ds._arrays = tuple(a[index::count] for a in self._arrays)
        ds._shard_spec = (index, count)
        return ds

    def reshard(self, index: int, count: int) -> "ArrayDataset":
        """Shard ``index``/``count`` of the ORIGINAL data (not a shard of
        this shard), keeping the batch geometry."""
        ds = self._clone()
        ds._arrays = self._unsharded or self._arrays
        ds._unsharded = None
        return ds.shard(index, count)

    def repeat(self) -> "ArrayDataset":
        ds = self._clone()
        ds._repeat = True
        return ds

    def shuffle(self, buffer_size: int, seed: int = 0) -> "ArrayDataset":
        ds = self._clone()
        ds._shuffle_buffer = int(buffer_size)
        ds._seed = seed
        return ds

    def batch(self, batch_size: int,
              drop_remainder: bool = True) -> "ArrayDataset":
        ds = self._clone()
        ds._batch_size = int(batch_size)
        ds._drop_remainder = drop_remainder
        return ds

    def _clone(self) -> "ArrayDataset":
        ds = ArrayDataset(self._arrays)
        for name in ("_treedef", "_repeat", "_shuffle_buffer",
                     "_batch_size", "_drop_remainder", "_seed", "_unsharded",
                     "_shard_spec"):
            setattr(ds, name, getattr(self, name))
        return ds

    def _pass_indices(self, epoch: int, pass_: int = 0) -> Iterator[int]:
        """One shuffle pass over the examples, a pure function of ``(seed,
        epoch, pass_)``: a full permutation when the buffer covers the
        data, else tf.data's bounded-buffer (reservoir) shuffle restarted
        per pass."""
        n = self.num_examples
        rng = np.random.RandomState(
            stream_lib.epoch_seed(self._seed, epoch, pass_))
        order = np.arange(n)
        if self._shuffle_buffer >= n:
            rng.shuffle(order)
            yield from order
        elif self._shuffle_buffer > 1:
            buf = list(order[:self._shuffle_buffer])
            for idx in order[self._shuffle_buffer:]:
                j = rng.randint(0, len(buf))
                yield buf[j]
                buf[j] = idx
            while buf:
                j = rng.randint(0, len(buf))
                yield buf.pop(j)
        else:
            yield from order

    def __iter__(self):
        return self.batches()

    def _assemble(self, pending: list):
        sel = np.asarray(pending)
        return tree_unflatten(self._treedef, [a[sel] for a in self._arrays])

    def batches(self, skip: int = 0, *, start_epoch: int = 0,
                batches_per_epoch: int | None = None):
        """Iterate batches, fast-forwarded past the first ``skip`` without
        assembling them (only the shuffle's index stream is drawn).

        ``batches_per_epoch=None``: one shuffle pass is an epoch, and a
        pass's remainder straddles into the next in repeat mode.
        ``batches_per_epoch=B``: epoch ``e`` yields exactly ``B`` batches
        from passes ``(e, 0), (e, 1), ...`` (a partial batch carries across
        passes and is dropped at the epoch's end) — the `Trainer.fit`
        contract, which makes ``(start_epoch, skip)`` an exact position."""
        if self._batch_size is None:
            raise ValueError("call .batch(batch_size) before iterating")
        bs = self._batch_size
        skip = int(skip)
        skipped = 0
        if batches_per_epoch is None:
            pending: list[int] = []
            epoch = int(start_epoch)
            while True:
                for idx in self._pass_indices(epoch):
                    pending.append(idx)
                    if len(pending) == bs:
                        if skipped < skip:
                            skipped += 1
                            pending = []
                            continue
                        out = self._assemble(pending)
                        pending = []
                        yield out
                epoch += 1
                if not self._repeat:
                    break
            if pending and not self._drop_remainder:
                if skipped < skip:
                    return
                yield self._assemble(pending)
            return
        B = int(batches_per_epoch)
        if B < 1:
            raise ValueError(f"batches_per_epoch must be >= 1, got {B}")
        epoch = int(start_epoch)
        while True:
            emitted = 0
            pass_ = 0
            pending = []
            while emitted < B:
                for idx in self._pass_indices(epoch, pass_):
                    pending.append(idx)
                    if len(pending) == bs:
                        emitted += 1
                        if skipped < skip:
                            skipped += 1
                            pending = []
                        else:
                            out = self._assemble(pending)
                            pending = []
                            yield out
                        if emitted >= B:
                            break
                else:
                    pass_ += 1
                    continue
                break
            epoch += 1

    def take(self, n_batches: int):
        it = iter(self)
        return [next(it) for _ in range(n_batches)]


def training_pipeline(arrays, batch_size: int, seed: int = 0,
                      shuffle_buffer: int | None = None, structure=None,
                      skip_batches: int = 0, start_epoch: int = 0,
                      batches_per_epoch: int | None = None,
                      engine_out: dict | None = None):
    """The training-path input iterator: infinite shuffled batches of the
    given arrays (``repeat().shuffle().batch()``), anchored at
    ``start_epoch`` and fast-forwarded past ``skip_batches``. Returns
    ``(iterator, close)``; ``close()`` stops the native producer thread.

    Engine (the JAX package's rule): the native engine when it is
    available and the shuffle covers the data (``shuffle_buffer`` None or
    at least the row count), else the python engine. ``arrays`` are flat
    leaves; ``structure`` (an `ArrayDataset.structure`) rebuilds each batch
    into that structure on either engine. ``engine_out`` (a dict) receives
    ``{"engine": "native" | "python"}``."""

    def rebuild(it):
        if structure is None:
            return it
        return (tree_unflatten(structure, list(b)) for b in it)

    n = len(arrays[0])
    full_shuffle = shuffle_buffer is None or shuffle_buffer >= n
    if (full_shuffle and batch_size <= n
            and not registry.get_flag("HVT_NO_NATIVE")):
        from horovod_tpu_torch.data import native_loader

        if native_loader.available():
            loader = native_loader.NativeBatchLoader(
                arrays, batch_size, seed=seed, shuffle=True,
                start_epoch=start_epoch,
                batches_per_epoch=batches_per_epoch or 0)
            if skip_batches:
                loader.skip(skip_batches)
            if engine_out is not None:
                engine_out["engine"] = "native"
            return rebuild(iter(loader)), loader.close
    if engine_out is not None:
        engine_out["engine"] = "python"
    ds = (ArrayDataset(tuple(arrays)).repeat()
          .shuffle(shuffle_buffer or n, seed=seed)
          .batch(batch_size))
    return rebuild(ds.batches(skip=int(skip_batches), start_epoch=start_epoch,
                              batches_per_epoch=batches_per_epoch)), \
        lambda: None
