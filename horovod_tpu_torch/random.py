"""JAX's default random numbers in numpy: ``PRNGKey``, ``fold_in`` and
``uniform`` of ``jax.random`` under its default configuration (the
``threefry2x32`` implementation with ``jax_threefry_partitionable=True``),
bit for bit.

The port needs them for one thing: the device-cached epoch's order is
``argsort(uniform(fold_in(PRNGKey(seed + 1), epoch), (n_shards, per_n)),
axis=1)`` in the JAX trainer, and a stable argsort of the same f32 draws
gives the same batches here (`epoch_order`). A key is a ``uint32`` array of
two words, as JAX's raw keys are.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of ``(x0, x1)`` (uint32
    arrays of one shape) under ``key`` (two uint32 words), as
    ``jax.random``'s ``threefry2x32_p`` computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 — JAX's name
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``,
    with a seed in int32's range taken as JAX takes it without x64 (a
    32-bit integer, so the high word is 0)."""
    seed = int(seed)
    if -2**31 <= seed < 2**31:
        return np.array([0, seed & _M32], np.uint32)
    if not 0 <= seed < 2**64:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    return np.array([seed >> 32, seed & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the cipher of ``[0, uint32(data)]``
    under ``key``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & _M32], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element of ``shape``, partitionable layout: the
    cipher of each element's flat index (as two words, high and low),
    its two output words xor-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_M32)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in f32 over [0, 1): the top 23
    bits as a mantissa of [1, 2), minus 1."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))


def epoch_order(seed: int, epoch: int, shape) -> np.ndarray:
    """The device-cached epoch's shuffle of the JAX trainer: the stable
    argsort, row by row, of ``uniform(fold_in(PRNGKey(seed + 1), epoch),
    shape)`` (``shape`` = ``(n_shards, per_shard)``), as int64."""
    u = uniform(fold_in(PRNGKey(seed + 1), epoch), shape)
    return np.argsort(u, axis=-1, kind="stable").astype(np.int64)
