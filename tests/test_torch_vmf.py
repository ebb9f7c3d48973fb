"""The port's von Mises-Fisher family and its helpers
(cliffordtpu_torch/distributions: bessel.py, von_mises_fisher.py,
``CliffordTorusDistribution``, ``VMFHypersphericalUniform``) against
cliffordtpu/distributions on equal keys.

Bars: the Bessel helpers within 1e-5 relative across their branches
(``log_ive``, a logarithm, within 1e-5 of max(1, |value|));
samples within 1e-5 (unit vectors, torus points); entropy and log_prob
within 1e-5 of max(1, |value|) (``test_torch_distributions.py::_close``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.distributions import bessel as jbessel
from cliffordtpu.distributions import clifford_torus as jct
from cliffordtpu.distributions import uniforms as juni
from cliffordtpu.distributions import von_mises_fisher as jvmf
from cliffordtpu_torch.distributions import bessel as tbessel
from cliffordtpu_torch.distributions import clifford_torus as tct
from cliffordtpu_torch.distributions import uniforms as tuni
from cliffordtpu_torch.distributions import von_mises_fisher as tvmf

torch.set_num_threads(1)

N = 8


def _close(got, want, bar=1e-5):
    return np.abs(got - want).max() < bar * max(1.0, np.abs(want).max())


def _rel(got, want, floor=1e-30):
    return (np.abs(got - want) / np.maximum(np.abs(want), floor)).max()


def test_bessel_helpers_match_jax():
    """``log_ive`` at v 0 (I_0(0) = 1), v > 0 at z = 0 (-inf), small and
    large z and high orders; ``ive_fraction_approx2`` and
    ``von_mises_entropy`` from kappa 0 to 10."""
    v = np.array([0.0, 0.0, 0.5, 1.0, 4.5, 7.0, 31.5, 63.0], np.float32)
    z = np.array([0.0, 1e-3, 0.5, 5.0, 10.0, 30.0, 1e-2, 20.0], np.float32)
    want = np.asarray(jbessel.log_ive(jnp.asarray(v), jnp.asarray(z)))
    got = tbessel.log_ive(torch.from_numpy(v), torch.from_numpy(z)).numpy()
    # a logarithm: 1e-5 relative where |log| > 1, absolute below
    assert (np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want))).all()
    zero_z = tbessel.log_ive(torch.tensor([2.0]), torch.tensor([0.0]))
    assert zero_z.item() == -np.inf == float(jbessel.log_ive(2.0, 0.0))
    np.testing.assert_allclose(
        tbessel.ive(torch.from_numpy(v), torch.from_numpy(z)).numpy(),
        np.asarray(jbessel.ive(jnp.asarray(v), jnp.asarray(z))), rtol=1e-5)
    kappa = np.concatenate([[0.0, 1e-4], np.geomspace(1e-2, 10.0, 14)]) \
        .astype(np.float32)
    for m_by_2 in (1.5, 5.0, 32.0):
        want = np.asarray(jbessel.ive_fraction_approx2(
            jnp.float32(m_by_2), jnp.asarray(kappa)))
        got = tbessel.ive_fraction_approx2(
            torch.tensor(m_by_2), torch.from_numpy(kappa)).numpy()
        assert _rel(got[1:], want[1:]) <= 1e-5 and got[0] == want[0] == 0
    want = np.asarray(jbessel.von_mises_entropy(jnp.asarray(kappa)))
    got = tbessel.von_mises_entropy(torch.from_numpy(kappa)).numpy()
    assert _rel(got, want) <= 1e-5


def _vmf_inputs(m, seed):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(N, m)).astype(np.float32)
    loc /= np.linalg.norm(loc, axis=-1, keepdims=True)
    kappa = rng.uniform(0.1, 10.0, (N, 1)).astype(np.float32)
    kappa[0, 0], kappa[1, 0] = 10.0, 0.1
    return loc, kappa


@pytest.mark.parametrize("m", [3, 10])
def test_vmf_sample_entropy_log_prob_match_jax(m):
    """m 3 takes the closed form, m 10 the 32-proposal rejection."""
    loc, kappa = _vmf_inputs(m, m)
    key = jax.random.PRNGKey(m)
    want = jvmf.VonMisesFisher(jnp.asarray(loc), jnp.asarray(kappa))
    got = tvmf.VonMisesFisher(torch.from_numpy(loc),
                              torch.from_numpy(kappa))
    x = got.sample(np.asarray(key))
    assert x.shape == (N, m)
    # the Householder vector's 1e-5 epsilon leaves |x| within 1e-4 of 1
    assert np.abs(x.numpy() - np.asarray(jax.jit(want.sample)(key))).max() \
        <= 1e-5
    assert _close(got.entropy().numpy(), np.asarray(want.entropy()))
    xs = x.numpy()
    assert _close(got.log_prob(x).numpy(),
                  np.asarray(want.log_prob(jnp.asarray(xs))))
    assert np.abs(got.mean.numpy() - np.asarray(want.mean)).max() <= 1e-5
    # a (N,) concentration is the same as (N, 1)
    flat = tvmf.VonMisesFisher(torch.from_numpy(loc),
                               torch.from_numpy(kappa[:, 0]))
    assert torch.equal(flat.sample(np.asarray(key)), x)


def test_vmf_gradient_in_scale_matches_jax_grad():
    """Through b(kappa) and w(b, e), the proposals carrying none."""
    m = 10
    loc, kappa = _vmf_inputs(m, 1)
    w = np.random.default_rng(2).normal(size=(N, m)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(jax.grad(lambda k: jnp.sum(jvmf.VonMisesFisher(
        jnp.asarray(loc), k).sample(key) * w)))(jnp.asarray(kappa)))
    k = torch.from_numpy(kappa).requires_grad_()
    (tvmf.VonMisesFisher(torch.from_numpy(loc), k).sample(np.asarray(key))
     * torch.from_numpy(w)).sum().backward()
    assert np.abs(k.grad.numpy() - want).max() <= 1e-4 * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("d", [16])
def test_clifford_torus_distribution_matches_jax(d):
    """Best-Fisher draws (32 rounds) embedded on the torus, and the
    entropy over circles 1..d-1; kappa from 0 (a uniform angle) to 10."""
    rng = np.random.default_rng(d)
    loc = rng.uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    kappa = rng.uniform(0.0, 10.0, (N, d)).astype(np.float32)
    kappa[0, :2] = 0.0
    key = jax.random.PRNGKey(d)
    want = jct.CliffordTorusDistribution(jnp.asarray(loc),
                                         jnp.asarray(kappa))
    got = tct.CliffordTorusDistribution(torch.from_numpy(loc),
                                        torch.from_numpy(kappa))
    x = got.sample(np.asarray(key))
    assert x.shape == (N, 2 * d) and not x.requires_grad
    assert np.abs(x.numpy() - np.asarray(jax.jit(want.sample)(key))).max() \
        <= 1e-5
    assert _close(got.entropy().numpy(), np.asarray(want.entropy()))


@pytest.mark.parametrize("dim", [2, 9])
def test_vmf_hyperspherical_uniform_matches_jax(dim):
    key = jax.random.PRNGKey(dim)
    want, got = juni.VMFHypersphericalUniform(dim), \
        tuni.VMFHypersphericalUniform(dim)
    x = got.sample(np.asarray(key), (N,))
    assert x.shape == (N, dim + 1)
    assert np.abs(x.numpy() - np.asarray(want.sample(key, (N,)))).max() \
        <= 1e-5
    assert abs(got.entropy() - float(want.entropy())) <= 1e-5 * max(
        1.0, abs(float(want.entropy())))
    np.testing.assert_allclose(
        got.log_prob(x).numpy(),
        np.asarray(want.log_prob(jnp.asarray(x.numpy()))), rtol=1e-6)
