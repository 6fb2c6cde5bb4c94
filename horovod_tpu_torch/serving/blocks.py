"""Paged KV-cache accounting: fixed-size token blocks + per-sequence tables
(the port's own copy of `horovod_tpu.serving.blocks`).

The decoders keep each sequence's K/V physically contiguous ([B, T0+new,
H, D] per layer), so what pages here is the ADMISSION BUDGET, not the
device layout: a sequence may only enter the batch when a whole-lifetime
block reservation (prompt + full generation budget, rounded up to
``block_tokens``) fits the configured budget, and retiring a sequence
returns its exact blocks for immediate reuse. The engine refuses admission
(HTTP 429 once the wait queue is also full) instead of letting the device
run out of memory mid-decode.

Sizing: one block holds ``block_tokens`` tokens of K/V for every layer,
so a bundle serving prompts up to T0 with N new tokens needs
``ceil((T0 + N) / block_tokens)`` blocks per sequence, and a budget of
``kv_blocks`` admits ``kv_blocks // that`` concurrent sequences.
"""

from __future__ import annotations

import threading


class OutOfBlocksError(RuntimeError):
    """The reservation does not fit the configured block budget."""


class BlockTable:
    """One sequence's ordered block ids — the unit `BlockAllocator.free`
    takes back. ``token_capacity`` is what the reservation covers; the
    table refuses to be freed twice (a double-free would let two live
    sequences alias one block's budget)."""

    __slots__ = ("block_ids", "block_tokens", "freed")

    def __init__(self, block_ids: list[int], block_tokens: int):
        self.block_ids = list(block_ids)
        self.block_tokens = block_tokens
        self.freed = False

    @property
    def num_blocks(self) -> int:
        return len(self.block_ids)

    @property
    def token_capacity(self) -> int:
        return len(self.block_ids) * self.block_tokens

    def __repr__(self) -> str:  # debugging/journal readability
        return (
            f"BlockTable(blocks={self.block_ids}, "
            f"capacity={self.token_capacity})"
        )


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` KV blocks of
    ``block_tokens`` tokens each.

    ``reserve(n_tokens)`` hands out a `BlockTable` covering
    ``ceil(n_tokens / block_tokens)`` blocks or raises
    `OutOfBlocksError` — the caller (the engine's admission step) queues
    the sequence and retries as retirements free blocks. A reservation
    larger than the WHOLE budget can never succeed and raises
    ``ValueError`` immediately so the request 400s instead of queueing
    forever. Thread-safe: handler threads reserve, the scheduler thread
    frees.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 1 or block_tokens < 1:
            raise ValueError(
                f"num_blocks ({num_blocks}) and block_tokens "
                f"({block_tokens}) must be >= 1"
            )
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self._lock = threading.Lock()
        # LIFO free list: a just-retired sequence's blocks are the
        # warmest candidates for the next admission.
        self._free = list(range(num_blocks - 1, -1, -1))

    def blocks_for(self, n_tokens: int) -> int:
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        return -(-n_tokens // self.block_tokens)

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks

    def reserve(self, n_tokens: int) -> BlockTable:
        need = self.blocks_for(n_tokens)
        if need > self.num_blocks:
            raise ValueError(
                f"a {n_tokens}-token sequence needs {need} KV blocks but "
                f"the whole budget is {self.num_blocks} "
                f"(block_tokens={self.block_tokens}) — raise "
                "HVT_SERVE_KV_BLOCKS or shorten the request"
            )
        with self._lock:
            if need > len(self._free):
                raise OutOfBlocksError(
                    f"need {need} KV blocks, {len(self._free)} free "
                    f"(budget {self.num_blocks})"
                )
            ids = [self._free.pop() for _ in range(need)]
        return BlockTable(ids, self.block_tokens)

    def free(self, table: BlockTable) -> None:
        with self._lock:
            if table.freed:
                raise ValueError(
                    f"double free of {table!r} — a freed table's blocks "
                    "may already back another sequence"
                )
            table.freed = True
            self._free.extend(reversed(table.block_ids))
            if len(self._free) > self.num_blocks:
                raise AssertionError(
                    "free list larger than the budget — a table was "
                    "freed that this allocator never handed out"
                )
