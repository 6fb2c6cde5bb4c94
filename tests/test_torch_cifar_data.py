"""The port's synthetic CIFAR-10 (`horovod_tpu_torch.data.datasets`) against
the JAX package's: the same splits byte for byte (images and labels, dtypes
included), the npz cache interchangeable between the two, and ``cifar10``
asking for the reference's sizes and seeds. Exact equality throughout: both
run the same numpy calls in the same order.

The data's known property is held too: class c and class c + 5 share a
frequency and lie 180° apart, so a per-image random phase makes them one
distribution (the reference's, copied as it is): the best test accuracy is
about 0.5.
"""

import numpy as np
import pytest

from horovod_tpu.data import datasets as jds
from horovod_tpu_torch.data import datasets as tds


@pytest.mark.parametrize("n,seed", [(64, 0), (37, 1), (200, 7)])
def test_split_is_byte_identical(n, seed):
    x, y = tds._synth_cifar_split(n, seed)
    jx, jy = jds._synth_cifar_split(n, seed)
    assert (x.shape, x.dtype, y.shape, y.dtype) == (
        (n, 32, 32, 3), np.uint8, (n,), np.int64)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


def test_npz_cache_round_trips_between_the_packages(tmp_path):
    """The port writes the cache; the JAX package's ``cifar10`` reads it back
    as it would its own file, and the port reads it back unchanged."""
    splits = (tds._synth_cifar_split(48, 0), tds._synth_cifar_split(16, 1))
    written = tds._load_or_create("cifar10-0.npz", str(tmp_path),
                                  lambda: splits)
    for loaded in (jds.cifar10(path="cifar10-0.npz", cache_dir=str(tmp_path)),
                   tds.cifar10(path="cifar10-0.npz", cache_dir=str(tmp_path)),
                   written):
        for (x, y), (wx, wy) in zip(loaded, splits):
            assert x.dtype == wx.dtype and y.dtype == wy.dtype
            assert np.array_equal(x, wx) and np.array_equal(y, wy)
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_cifar10_asks_for_the_reference_sizes_and_seeds(tmp_path, monkeypatch):
    calls, real = [], tds._synth_cifar_split

    def fake(n, seed):
        calls.append((n, seed))
        return real(4, seed)

    monkeypatch.setattr(tds, "_synth_cifar_split", fake)
    monkeypatch.setenv("HVT_DATA_DIR", str(tmp_path))
    (x, y), (xt, yt) = tds.cifar10(path="cifar10-3.npz")
    assert calls == [(50_000, 0), (10_000, 1)]
    assert (tmp_path / "cifar10-3.npz").exists()
    assert np.array_equal(xt, jds._synth_cifar_split(4, 1)[0])


def test_classes_c_and_c_plus_5_are_one_distribution():
    """Under phase φ → π − φ, an image of class c + 5 is an image of class
    c: sin(−θ + φ) = sin(θ + π − φ). Checked on the noise-free textures."""
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    freqs = 1 + (np.arange(10) % 5)
    angles = (np.arange(10) * 36) * np.pi / 180.0
    phase = np.random.RandomState(0).uniform(0, 2 * np.pi, size=3)

    def base(c, ph):
        proj = np.cos(angles[c]) * xx + np.sin(angles[c]) * yy
        return np.sin(proj[..., None] * (freqs[c] * 2 * np.pi / 32) + ph)

    for c in range(5):
        np.testing.assert_allclose(base(c + 5, phase), base(c, np.pi - phase),
                                   atol=1e-12)
        assert np.abs(base(c + 1, phase) - base(c, np.pi - phase)).max() > 0.5
