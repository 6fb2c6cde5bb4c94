"""Synthetic datasets — the port's own copy of what it needs from
`horovod_tpu.data.datasets` (numpy only, byte-identical arrays).

``mnist()`` and ``cifar10()`` keep the reference's loading contract (``load_data(path=
'mnist-%d.npz' % rank)``): ``(x_train, y_train), (x_test, y_test)`` as
uint8 images and int64 labels, cached in an ``.npz`` whose per-rank name
keeps co-located processes from racing on one file. A real keras-layout
``mnist.npz`` at the path is read as it is; otherwise a deterministic,
learnable stand-in of the same shapes is synthesized (digit glyphs from a
5×7 font, upscaled 3×, at random offsets with intensity jitter and noise)
and cached atomically. ``cifar10()``'s stand-in is the reference's too:
class-conditional coloured textures, with its property kept: class c and
class c + 5 share a frequency and lie 180° apart, and the random phase makes
their images one distribution, so no model can tell the two apart (test
accuracy tops out near 0.5).
"""

from __future__ import annotations

import os

import numpy as np

from horovod_tpu_torch.analysis import registry

# The cache directory when neither ``cache_dir`` nor ``HVT_DATA_DIR`` says
# otherwise (the knob's registered default).
DEFAULT_DATA_DIR = registry.knob("HVT_DATA_DIR").default

# 5x7 bitmap font for digits 0-9 (rows top→bottom, 5 bits per row).
_DIGIT_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyphs() -> np.ndarray:
    """(10, 21, 15) float glyph bank: 5x7 font, 3x nearest-neighbor upscale."""
    bank = np.zeros((10, 21, 15), np.float32)
    for d, rows in _DIGIT_FONT.items():
        bitmap = np.array([[int(c) for c in row] for row in rows], np.float32)
        bank[d] = np.kron(bitmap, np.ones((3, 3), np.float32))
    return bank


def _synth_mnist_split(n: int, seed: int):
    """Deterministic synthetic MNIST-shaped split: (n,28,28) uint8 + (n,)
    int64."""
    rng = np.random.RandomState(seed)
    glyphs = _glyphs()
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    oy = rng.randint(0, 28 - 21 + 1, size=n)
    ox = rng.randint(0, 28 - 15 + 1, size=n)
    intensity = rng.uniform(0.65, 1.0, size=n).astype(np.float32)
    images = rng.normal(0.0, 0.06, size=(n, 28, 28)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(21), np.arange(15), indexing="ij")
    rows = oy[:, None, None] + gy[None]
    cols = ox[:, None, None] + gx[None]
    samp = np.arange(n)[:, None, None]
    images[samp, rows, cols] += glyphs[labels] * intensity[:, None, None]
    np.clip(images, 0.0, 1.0, out=images)
    return (images * 255).astype(np.uint8), labels


def _load_or_create(path: str, cache_dir: str | None, synthesize):
    """Read the keras-layout npz at ``path`` (under ``cache_dir``, else
    ``HVT_DATA_DIR``, else `DEFAULT_DATA_DIR`) if present, else materialize
    it via ``synthesize() -> ((xtr, ytr), (xte, yte))`` with an atomic
    rename (no torn files under concurrent writers)."""
    cache_dir = cache_dir or os.path.expanduser(
        registry.get_str("HVT_DATA_DIR"))
    full = path if os.path.isabs(path) else os.path.join(cache_dir, path)
    if os.path.exists(full):
        with np.load(full) as f:
            return ((f["x_train"], f["y_train"]), (f["x_test"], f["y_test"]))
    (x_train, y_train), (x_test, y_test) = synthesize()
    os.makedirs(os.path.dirname(full), exist_ok=True)
    tmp = f"{full}.tmp.{os.getpid()}.npz"  # keep .npz: savez appends it otherwise
    np.savez_compressed(tmp, x_train=x_train, y_train=y_train,
                        x_test=x_test, y_test=y_test)
    os.replace(tmp, full)
    return (x_train, y_train), (x_test, y_test)


def mnist(path: str = "mnist.npz", cache_dir: str | None = None):
    """``(x_train, y_train), (x_test, y_test)`` — keras-layout MNIST, 60k /
    10k 28×28 uint8 images and int64 labels. The first call materializes
    the npz, later calls read it back; distinct per-rank ``path``s keep
    co-located processes from racing on one file."""
    return _load_or_create(
        path, cache_dir,
        lambda: (_synth_mnist_split(60_000, seed=0),
                 _synth_mnist_split(10_000, seed=1)),
    )


def _synth_cifar_split(n: int, seed: int):
    """Class-conditional coloured textures: (n,32,32,3) uint8 + (n,) int64,
    byte-identical to the reference's (same draws in the same order, float64
    math, uint8 after the clip)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    # Per-class signature: orientation + frequency + RGB phase offsets.
    freqs = 1 + (np.arange(10) % 5)
    angles = (np.arange(10) * 36) * np.pi / 180.0
    phase = rng.uniform(0, 2 * np.pi, size=(n, 3)).astype(np.float32)
    proj = (np.cos(angles)[labels][:, None, None] * xx[None]
            + np.sin(angles)[labels][:, None, None] * yy[None])  # (n, 32, 32)
    base = np.sin(
        proj[..., None] * (freqs[labels][:, None, None, None] * 2 * np.pi / 32)
        + phase[:, None, None, :]
    )  # (n, 32, 32, 3)
    images = 0.5 + 0.35 * base + rng.normal(0, 0.08, size=base.shape)
    np.clip(images, 0.0, 1.0, out=images)
    return (images * 255).astype(np.uint8), labels


def cifar10(path: str = "cifar10.npz", cache_dir: str | None = None):
    """CIFAR-10-shaped splits: 50k / 10k 32×32×3 uint8 images and int64
    labels, with `mnist`'s loading contract (per-rank ``path``, atomic
    cache)."""
    return _load_or_create(
        path, cache_dir,
        lambda: (_synth_cifar_split(50_000, seed=0),
                 _synth_cifar_split(10_000, seed=1)),
    )


def copy_task(n_sequences: int, seq_len: int, vocab_size: int = 64,
              seed: int = 0):
    """Long-range-recall LM dataset: the second half of each sequence
    repeats the first half, so predicting token ``t ≥ T/2`` requires
    attending ``T/2`` positions back.

    Returns ``(inputs, labels)`` int32 arrays of shape ``[n_sequences,
    seq_len]`` (next-token pairs over a BOS-prefixed sequence). Token 0 is
    the BOS and never sampled; label positions ``seq_len//2 ..`` are the
    recall half."""
    if seq_len % 2 != 0:
        raise ValueError("seq_len must be even")
    rng = np.random.RandomState(seed)
    half = seq_len // 2
    first = rng.randint(1, vocab_size, size=(n_sequences, half))
    bos = np.zeros((n_sequences, 1), dtype=first.dtype)
    tokens = np.concatenate([bos, first, first], axis=1).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]
