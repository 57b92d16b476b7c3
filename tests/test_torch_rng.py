"""The port's threefry PRNG is bit-equal to jax.random (partitionable
mode) at the engine's shapes and ranges."""

import jax
import numpy as np
import pytest
import torch

from corrosion_tpu_torch import rng

# Test workers share the machine's cores: one intra-op thread each keeps
# torch from oversubscribing them (the op sizes here gain nothing from more).
torch.set_num_threads(1)

SEEDS = (0, 1, 4, 12345, 2**31 - 1)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    assert np.array_equal(_np(kj), kt.numpy())
    for num in (2, 3, 4, 5):
        assert np.array_equal(_np(jax.random.split(kj, num)), rng.split(kt, num).numpy())
    for d in (0, 1, 7, 71, 239, 100_000):
        assert np.array_equal(
            _np(jax.random.fold_in(kj, d)), rng.fold_in(kt, d).numpy()
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "shape,lo,hi",
    [
        ((400, 2), 0, 1 << 30),  # near-source offsets
        ((400, 1), 0, 400),  # far sources
        ((4, 400), 0, 400),  # SWIM probe tries
        ((67, 4), 0, 1 << 30),  # sync candidates (odd row count)
        ((1000, 3), 0, 1000),
        ((3,), 5, 6),  # span 1
        ((2, 3), 4, 4),  # empty range -> minval
        ((5, 0), 0, 3),  # empty shape
    ],
)
def test_randint(seed, shape, lo, hi):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    k2 = jax.random.fold_in(kj, 3)
    assert np.array_equal(
        _np(jax.random.randint(k2, shape, lo, hi)),
        rng.randint(rng.fold_in(kt, 3), shape, lo, hi).numpy(),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(400, 144), (7,), (3, 5), (1,)])
def test_uniform_float32_bits(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    a = np.asarray(jax.random.uniform(kj, shape))
    b = rng.uniform(kt, shape).numpy()
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_seed_range_is_checked():
    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
