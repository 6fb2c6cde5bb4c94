"""ZeRO-1, the sharded weight update (Xu et al., arXiv:2004.13336) — the
port's counterpart of the ZeRO-1 branch of `horovod_tpu.training.build`.

The model stays replicated; the optimizer's state, and so the update, is
cut over the ranks. Each parameter with a dp-divisible dimension
(`collectives.zero1_shard_dim`, the rule the scatter reduction shares) has
a shard on every rank: rank r owns the contiguous copy of block r along
that dimension. The inner optimizer is built over those shards and over the
whole "tail" parameters (no dim divides), which stay replicated, so its
state per rank falls to about 1/dp for the sharded family. A step:

1. the reduction writes this rank's block of each reduced gradient into
   its shard's ``.grad`` and the whole gradient into a tail's;
2. the inner optimizer steps the shards and tails;
3. the updated shards are all-gathered, one collective per bucket of the
   scatter layout, back into the replicated parameters (`pack_params`,
   `communicate_params`, `unpack_params`: three stages, so a captured step
   can leave the collective out of its graphs where it goes through the
   host).

The update is elementwise for the optimizers the port offers (Adam, AdamW,
Adadelta, SGD), so a sharded step equals the replicated one bit for bit
when both see the same reduced gradients. `gather_state` / `cut_state`
convert the inner optimizer's state to and from the replicated optimizer's
format (every rank joins the gather; the format does not depend on the
world size).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.parallel import collectives


def _moved_row(t: torch.Tensor, sd: int) -> torch.Tensor:
    """A block in its scatter-layout row order: the shard dim first,
    raveled."""
    return torch.movedim(t, sd, 0).reshape(-1)


class ShardedUpdate:
    """The ZeRO-1 state of one optimizer over ``params`` at ``dp`` ranks,
    this one ``rank``. ``optimizer`` (built over ``params``, with no state
    yet) gives the inner optimizer's class, groups and hyperparameters."""

    def __init__(self, optimizer: torch.optim.Optimizer, dp: int, rank: int,
                 bucket_bytes: int, reverse: bool = True):
        self.dp, self.rank = int(dp), int(rank)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.sdims = [collectives.zero1_shard_dim(tuple(p.shape), self.dp)
                      for p in self.params]
        self.shards = []
        with torch.no_grad():
            for p, sd in zip(self.params, self.sdims):
                if sd is None:
                    self.shards.append(p)
                    continue
                blk = p.shape[sd] // self.dp
                s = torch.nn.Parameter(
                    p.detach().narrow(sd, self.rank * blk, blk).contiguous())
                s.grad = torch.zeros_like(s)
                self.shards.append(s)
        shard_of = {id(p): s for p, s in zip(self.params, self.shards)}
        groups = [dict({k: v for k, v in g.items() if k != "params"},
                       params=[shard_of[id(p)] for p in g["params"]])
                  for g in optimizer.param_groups]
        # Every group carries all its hyperparameters, so the class's own
        # defaults are never read; the original's are kept for
        # `add_param_group`.
        self.optimizer = type(optimizer)(groups)
        self.optimizer.defaults = dict(optimizer.defaults)
        # The parameter all-gather's layout: the scatter layout of the
        # sharded parameters alone (tails are updated whole on every rank).
        self._gathered = [i for i, sd in enumerate(self.sdims)
                          if sd is not None]
        _, self.spec = collectives.flatten_scatter_buckets(
            [torch.empty(self.params[i].shape, dtype=self.params[i].dtype,
                         device="meta") for i in self._gathered],
            self.dp, bucket_bytes, reverse=reverse)
        self._pieces = collectives.scatter_bucket_pieces(self.spec)

    # -- gradients in, parameters out ------------------------------------------

    @torch.no_grad()
    def set_grads(self, local: list) -> None:
        """``local[i]``: parameter i's reduced gradient, its block for a
        sharded parameter, whole for a tail. Each shard first takes its
        parameter's block, so a step starts from the parameters as they
        are (restored, broadcast or updated by the last step)."""
        idx = [i for i, sd in enumerate(self.sdims) if sd is not None]
        if idx:
            torch._foreach_copy_(
                [self.shards[i] for i in idx],
                [self.params[i].narrow(self.sdims[i],
                                       self.rank * self.shards[i].shape[
                                           self.sdims[i]],
                                       self.shards[i].shape[self.sdims[i]])
                 for i in idx])
        dst = [s.grad if sd is not None else p.grad
               for p, s, sd in zip(self.params, self.shards, self.sdims)]
        torch._foreach_copy_(dst, local)

    @torch.no_grad()
    def pack_params(self) -> list:
        """The updated shards as this rank's row of every bucket of the
        parameter all-gather."""
        rows = []
        for pieces in self._pieces:
            parts = [_moved_row(self.shards[self._gathered[j]],
                                self.sdims[self._gathered[j]])[lo:hi]
                     for j, lo, hi in pieces]
            if not parts:  # zero-width leaves only
                parts = [self.shards[self._gathered[0]].new_zeros(0)]
            rows.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return [(r, torch.empty((self.dp * r.numel(),), dtype=r.dtype,
                                device=r.device)) for r in rows]

    @staticmethod
    def communicate_params(packed) -> None:
        """All-gather every bucket's rows from the ranks, in place into the
        packed full buffers."""
        for row, full in packed:
            full.copy_(collectives.all_gather_tensor(row).reshape(-1))

    @torch.no_grad()
    def unpack_params(self, packed) -> None:
        """The gathered buckets into the replicated parameters."""
        leaves = collectives.unflatten_scatter_full([f for _, f in packed],
                                                    self.spec)
        torch._foreach_copy_([self.params[i] for i in self._gathered],
                             leaves)

    # -- state -----------------------------------------------------------------

    def _shard_keys(self, i, st) -> list:
        shape = self.shards[i].shape
        return [k for k, v in st.items() if isinstance(v, torch.Tensor)
                and v.dim() > 0 and v.shape == shape]

    def gather_state(self, sd: dict) -> dict:
        """The inner optimizer's state dict ``sd`` in the replicated
        optimizer's format: each shard-shaped state tensor all-gathered
        back to its parameter's shape. Every rank must call it."""
        out = {"state": {}, "param_groups": sd["param_groups"]}
        for idx in sorted(sd["state"]):
            st = sd["state"][idx]
            i = int(idx)
            keys = (self._shard_keys(i, st) if self.sdims[i] is not None
                    else [])
            full = dict(st)
            for k in keys:
                sdim = self.sdims[i]
                g = collectives.all_gather_tensor(
                    torch.movedim(st[k], sdim, 0).contiguous())
                full[k] = torch.movedim(
                    g.reshape((-1,) + tuple(g.shape[2:])), 0, sdim)
            out["state"][idx] = full
        return out

    def cut_state(self, sd: dict, rank: int | None = None) -> dict:
        """A replicated-format state dict cut to the shards of ``rank``
        (default this one; no collective)."""
        rank = self.rank if rank is None else int(rank)
        out = {"state": {}, "param_groups": sd["param_groups"]}
        for idx, st in sd["state"].items():
            i = int(idx)
            sdim = self.sdims[i]
            cut = dict(st)
            if sdim is not None:
                full_shape = tuple(self.params[i].shape)
                blk = full_shape[sdim] // self.dp
                for k, v in st.items():
                    if (isinstance(v, torch.Tensor)
                            and tuple(v.shape) == full_shape and v.dim()):
                        # A copy of its own: a view would carry (and
                        # pickle) the whole tensor's storage.
                        cut[k] = v.narrow(sdim, rank * blk, blk).clone(
                            memory_format=torch.contiguous_format)
            out["state"][idx] = cut
        return out

    def is_tail_index(self, idx) -> bool:
        return self.sdims[int(idx)] is None
