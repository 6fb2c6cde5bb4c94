"""The port's numpy threefry (`horovod_tpu_torch.random`) against
``jax.random`` in its default configuration (``threefry2x32``,
``jax_threefry_partitionable=True``): keys, folds, f32 uniforms and the
device-cached epoch's stable argsort order, all bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu_torch import random as hr

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -2**31]


def test_jax_runs_the_default_configuration():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    key = hr.PRNGKey(seed)
    want = np.asarray(jax.random.PRNGKey(seed))
    assert key.dtype == np.uint32 and np.array_equal(key, want)
    for data in (0, 1, 3, 11, 2**31, 2**32 - 1):
        got = hr.fold_in(key, data)
        assert np.array_equal(
            got, np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               data))), data


@pytest.mark.parametrize("seed,epoch,shape", [
    (0, 0, (7,)), (1, 2, (3, 5)), (9, 0, (2, 300)), (2**31 - 1, 17, (1, 997)),
    (5, 3, (4, 2, 3)),
])
def test_uniform_matches_jax_bit_for_bit(seed, epoch, shape):
    key = hr.fold_in(hr.PRNGKey(seed), epoch)
    want = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), epoch), shape))
    got = hr.uniform(key, shape)
    assert got.dtype == want.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed,epoch,shape", [
    (0, 0, (1, 60000)), (3, 5, (2, 30000)), (11, 1, (4, 257)),
])
def test_epoch_order_is_jaxs_stable_argsort(seed, epoch, shape):
    """The cached epoch's order (`feeding.py` in both packages):
    ``argsort(uniform(fold_in(PRNGKey(seed + 1), epoch), shape), axis=1)``.
    At 60 000 f32 draws some values tie, and the order among equal draws is
    the stable sort's, as ``jnp.argsort``'s."""
    u = jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), epoch), shape)
    want = np.asarray(jnp.argsort(u, axis=1))
    got = hr.epoch_order(seed, epoch, shape)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    if shape == (1, 60000):
        draws = np.asarray(u)[0][got[0]]
        tied = np.flatnonzero(draws[1:] == draws[:-1])
        assert len(tied) > 0  # ties do occur at this size
        # Within a tie, the lower row comes first.
        assert (got[0][tied] < got[0][tied + 1]).all()
