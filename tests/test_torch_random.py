"""The port's threefry (cliffordtpu_torch/random.py) against jax.random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu_torch import random as trandom

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEEDS = [0, 7, 2 ** 31 + 12345]


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    key = _key(seed)
    want = np.asarray(jax.random.split(key, 3)).astype(np.int64)
    got = trandom.split(key, 3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_match_jax(seed):
    key = _key(seed)
    want = np.asarray(jax.random.bits(key, (37, 9), jnp.uint32))
    got = trandom.random_bits(key, (37, 9)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed):
    """v (minval 0) is bit-exact; u (minval 1e-12) is within 2 ulp, the
    slack jax itself shows between eager and jitted uniform."""
    key = _key(seed)
    v_want = np.asarray(jax.random.uniform(key, (37, 9), jnp.float32))
    v_got = trandom.uniform(key, (37, 9)).numpy()
    np.testing.assert_array_equal(v_got, v_want)
    u_want = np.asarray(jax.random.uniform(key, (37, 9), jnp.float32,
                                           minval=1e-12))
    u_got = trandom.uniform(key, (37, 9), minval=1e-12).numpy()
    np.testing.assert_array_max_ulp(u_got, u_want, maxulp=2)
    assert u_got.min() >= np.float32(1e-12)


def test_key_words_accepts_pairs_arrays_and_tensors():
    key = _key(7)
    want = (int(key[0]), int(key[1]))
    assert trandom.key_words(key) == want
    assert trandom.key_words(list(want)) == want
    assert trandom.key_words(torch.tensor(want)) == want
    with pytest.raises(ValueError):
        trandom.key_words([1, 2, 3])
    with pytest.raises(ValueError):
        trandom.key_words([-1, 2])
