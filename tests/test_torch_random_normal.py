"""The port's ``uniform`` with ``maxval`` and its ``normal``
(cliffordtpu_torch/random.py) against jax.random.

Bars: uniforms bit-exact (XLA forms f * (maxval - minval) + minval as one
fused multiply-add, and so does the port); normals within 1e-5 of
max(|z|, 1e-3), relative: XLA's float32 ``erf_inv`` on the CPU is an
approximation with up to 5.7e-6 relative error, torch's ``erfinv`` is
within 6e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu_torch import random as trandom

torch.set_num_threads(1)

SEEDS = [0, 7, 2 ** 31 + 12345]


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("minval,maxval", [
    (1e-7, 1.0 - 1e-7), (-3.0, 5.0), (1e-20, 1.0), (0.0, 2.5),
    (float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0),
], ids=["vmf", "wide", "tiny", "scaled", "normal"])
def test_uniform_with_maxval_is_bit_exact(seed, minval, maxval):
    key = _key(seed)
    want = np.asarray(jax.random.uniform(key, (64, 1024), jnp.float32,
                                         minval=minval, maxval=maxval))
    got = trandom.uniform(key, (64, 1024), minval, maxval).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= np.float32(minval) and got.max() < np.float32(maxval)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    key = _key(seed)
    shape = (256, 1024)
    want = np.asarray(jax.random.normal(key, shape))
    got = trandom.normal(key, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert rel.max() <= 1e-5, rel.max()
    assert np.isfinite(got).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_split_three_matches_jax(seed):
    key = _key(seed)
    want = np.asarray(jax.random.split(key, 3)).astype(np.int64)
    np.testing.assert_array_equal(trandom.split(key, 3).numpy(), want)
    assert trandom.split_words(key, 3) == [tuple(w) for w in want.tolist()]
