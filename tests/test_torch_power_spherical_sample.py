"""The port's PowerSpherical samplers
(cliffordtpu_torch/distributions/power_spherical.py) against
cliffordtpu/distributions/power_spherical.py on equal keys.

Bars: samples and the pieces of the draw within 1e-5 (points of the unit
sphere); ``marginal_t_entropy`` within 1e-5 of max(1, |H|)
(``test_torch_distributions.py::_close``); the gradients of a weighted sum
of samples in loc and scale within 1e-4 of max(1, their largest value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.distributions import power_spherical as jps
from cliffordtpu.distributions import uniforms as juni
from cliffordtpu_torch.distributions import power_spherical as tps
from cliffordtpu_torch.distributions import uniforms as tuni

torch.set_num_threads(1)

N = 8


def _close(got, want, bar=1e-5):
    return np.abs(got - want).max() < bar * max(1.0, np.abs(want).max())


def _inputs(d, seed):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(N, d)).astype(np.float32)
    loc /= np.linalg.norm(loc, axis=-1, keepdims=True)
    scale = rng.uniform(0.5, 10.0, N).astype(np.float32)
    scale[0] = 0.0
    return loc, scale


@pytest.mark.parametrize("d", [2, 5, 64])
def test_sample_matches_jax(d):
    loc, scale = _inputs(d, d)
    key = jax.random.PRNGKey(d)
    want = np.asarray(jax.jit(jps.PowerSpherical(
        jnp.asarray(loc), jnp.asarray(scale)).sample)(key))
    got = tps.PowerSpherical(torch.from_numpy(loc),
                             torch.from_numpy(scale)).sample(np.asarray(key))
    assert got.shape == want.shape == (N, d)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    again = tps.PowerSpherical(torch.from_numpy(loc), torch.from_numpy(
        scale)).rsample(np.asarray(key), (3,))
    assert again.shape == (3, N, d)


def test_draw_pieces_match_jax():
    """``marginal_t_sample``, ``joint_ts_sample``, ``beta_half_sample``,
    ``t_transform`` and ``householder_reflect`` at d 7."""
    d = 7
    loc, scale = _inputs(d, 1)
    key = jax.random.PRNGKey(9)
    tkey = np.asarray(key)
    ts, js = torch.from_numpy(scale), jnp.asarray(scale)
    pairs = [
        (jps.marginal_t_sample(key, d, js, (N,)),
         tps.marginal_t_sample(tkey, d, ts, (N,))),
        (jps.joint_ts_sample(key, d, js, (N,)),
         tps.joint_ts_sample(tkey, d, ts, (N,))),
        (jps.beta_half_sample(key, js + 1.0, 4, (N,)),
         tps.beta_half_sample(tkey, ts + 1.0, 4, (N,))),
    ]
    y = np.array(pairs[1][0])
    pairs.append((jps.t_transform(jnp.asarray(y[:, :1]),
                                  jnp.asarray(y[:, 1:])),
                  tps.t_transform(torch.from_numpy(y[:, :1]),
                                  torch.from_numpy(y[:, 1:]))))
    pairs.append((jps.householder_reflect(jnp.asarray(y), jnp.asarray(loc)),
                  tps.householder_reflect(torch.from_numpy(y),
                                          torch.from_numpy(loc))))
    for want, got in pairs:
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("d", [2, 16, 64, 4096])
def test_marginal_t_entropy_matches_jax(d):
    """Within 1e-5 of the largest term the entropy sums, at least 1: the
    terms grow as d log d and cancel to order one (at d 4096 lgamma(a + b)
    is about 15,000 and H is -2.7), so float32 keeps fewer digits of H as
    d grows, on both sides (JAX's value at d 4096 is 0.008 from the
    float64 one)."""
    scale = np.concatenate([[0.0, 0.03], np.geomspace(0.1, 10.0, 6)]) \
        .astype(np.float32)
    want = np.asarray(jps.marginal_t_entropy(d, jnp.asarray(scale)))
    got = tps.marginal_t_entropy(d, torch.from_numpy(scale)).numpy()
    assert got.shape == want.shape
    ab = (d - 1.0) + scale.astype(np.float64)
    terms = max(np.abs(jax.scipy.special.gammaln(ab)).max(),
                np.abs((ab - 2) * jax.scipy.special.digamma(ab)).max())
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(terms))


@pytest.mark.parametrize("d", [3, 16])
def test_sample_gradients_match_jax_grad(d):
    """The reparameterised gradient in loc (Householder) and in scale
    (through the Gamma draw's implicit gradient)."""
    loc, scale = _inputs(d, 40 + d)
    w = np.random.default_rng(d).normal(size=(N, d)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def f(l, s):
        return jnp.sum(jps.PowerSpherical(l, s).sample(key) * w)

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(loc),
                                                 jnp.asarray(scale))
    tl = torch.from_numpy(loc).requires_grad_()
    tsc = torch.from_numpy(scale).requires_grad_()
    (tps.PowerSpherical(tl, tsc).sample(np.asarray(key))
     * torch.from_numpy(w)).sum().backward()
    for g, jg in zip((tl.grad, tsc.grad), want):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * max(
            1.0, np.abs(jg).max())


@pytest.mark.parametrize("d", [3, 10])
def test_hyperspherical_uniform_matches_jax(d):
    key = jax.random.PRNGKey(d)
    want = juni.HypersphericalUniform(d)
    got = tuni.HypersphericalUniform(d)
    x = got.sample(np.asarray(key), (N,))
    assert np.abs(x.numpy() - np.asarray(want.sample(key, (N,)))).max() \
        <= 1e-5
    assert abs(got.entropy() - float(want.entropy())) <= 1e-5 * max(
        1.0, abs(float(want.entropy())))
    np.testing.assert_allclose(got.log_prob(x).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(
                                   x.numpy()))), rtol=1e-6)
