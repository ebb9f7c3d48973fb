"""The port's fixed-budget Gamma sampler
(cliffordtpu_torch/distributions/gamma.py) against
cliffordtpu/distributions/gamma.py on equal keys, across alpha < 1 (the
boost), alpha near 1 and alpha >> 1.

Bars: the selected proposal equal on every element; z within 1e-5
relative (of max(|z|, 1e-30): XLA flushes denormal results to zero, torch
on the CPU keeps them); dz/dalpha within 1e-4 relative of ``jax.grad``.
The normals under the proposals differ from jax's by its float32
``erf_inv`` (up to 5.7e-6 relative, ``test_torch_random_normal.py``), and
the cube and the boost's power carry that into z."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.distributions import gamma as jgamma
from cliffordtpu_torch.distributions import gamma as tgamma

torch.set_num_threads(1)

ALPHAS = {
    "boosted": np.geomspace(0.05, 0.95, 256),
    "near_one": np.linspace(0.9, 1.1, 256),
    "large": np.geomspace(3.0, 300.0, 256),
}


def _jax_index(key, alpha, shape):
    """The proposal ``_gamma_fixed`` selects, recomputed from the JAX
    package's own draws."""
    alpha = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32), shape)
    a = jnp.where(alpha < 1.0, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)
    kx, ku, _ = jax.random.split(key, 3)
    x = jax.random.normal(kx, (jgamma._BUDGET,) + shape, dtype=jnp.float32)
    u = jax.random.uniform(ku, (jgamma._BUDGET,) + shape, dtype=jnp.float32,
                           minval=jgamma._TINY)
    v = (1.0 + c * x) ** 3
    v_pos = v > 0.0
    log_v = jnp.log(jnp.where(v_pos, v, 1.0))
    accept = v_pos & (jnp.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    idx = jnp.argmax(accept, axis=0)
    return np.asarray(jnp.where(jnp.any(accept, axis=0), idx,
                                jgamma._BUDGET - 1))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("group", sorted(ALPHAS))
def test_gamma_draw_matches_jax(group, seed):
    alpha = np.tile(ALPHAS[group], (2, 1)).astype(np.float32)
    shape = alpha.shape
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.jit(jgamma.gamma_sample, static_argnums=2)(
        key, jnp.asarray(alpha), shape))
    got, idx = tgamma._gamma_fixed(np.asarray(key), torch.from_numpy(alpha),
                                   shape)
    np.testing.assert_array_equal(idx.numpy(), _jax_index(key, alpha, shape))
    assert got.shape == want.shape and got.dtype == torch.float32
    got = got.numpy()
    assert (np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want),
                                                      1e-30)).all()
    assert torch.equal(tgamma.gamma_sample(np.asarray(key),
                                           torch.from_numpy(alpha), shape),
                       torch.from_numpy(got))


@pytest.mark.parametrize("group", sorted(ALPHAS))
def test_gamma_gradient_matches_jax_grad(group):
    """The implicit gradient through a broadcast alpha (one alpha per
    column, two rows of draws), against ``jax.grad`` of ``gamma_sample``."""
    alpha = ALPHAS[group].astype(np.float32)
    shape = (2,) + alpha.shape
    w = np.random.default_rng(5).uniform(0.5, 2.0, shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        jgamma.gamma_sample(key, a, shape) * w)))(jnp.asarray(alpha)))
    a = torch.from_numpy(alpha).requires_grad_()
    (tgamma.gamma_sample(np.asarray(key), a, shape)
     * torch.from_numpy(w)).sum().backward()
    got = a.grad.numpy()
    assert (np.abs(got - want) <= 1e-4 * np.maximum(np.abs(want),
                                                      1e-30)).all()


def test_random_gamma_grad_matches_jax_on_both_branches():
    """The series branch (z <= max(1, alpha)) and the continued fraction
    (z > max(1, alpha)), z = 0, and a domain error."""
    a = np.array([0.3, 0.3, 2.0, 2.0, 50.0, 50.0, 1.0, -1.0], np.float32)
    z = np.array([0.2, 3.0, 1.5, 6.0, 45.0, 60.0, 0.0, 1.0], np.float32)
    want = np.asarray(jax.lax.random_gamma_grad(jnp.asarray(a),
                                                jnp.asarray(z)))
    got = tgamma.random_gamma_grad(torch.from_numpy(a),
                                   torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-5, atol=0)
    assert np.isnan(got[-1]) and np.isnan(want[-1])
