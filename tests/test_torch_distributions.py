"""The port's training-side distributions (cliffordtpu_torch/distributions:
PowerSpherical, CliffordPowerSphericalDistribution log_prob / entropy,
CliffordTorusUniform and the KL registry) against the JAX classes.
Bars: < 1e-5 for log_prob, entropy and KL, scaled by the value's magnitude
where it exceeds 1 (``_close``): a sum over 16 circles reaches 10 to 30,
where one float32 ulp is 1e-6 to 2e-6 and both sides add d differences of
lgamma values; < 1e-4 for the entropy's gradient with respect to the
concentration (PARITY.md)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu import distributions as jd
from cliffordtpu_torch.distributions import kl as tkl
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical
from cliffordtpu_torch.distributions.uniforms import CliffordTorusUniform
from cliffordtpu_torch.ops.torus import angles_to_torus

torch.set_num_threads(1)

DIMS = [2, 8, 16]
N = 12


def _close(got, want, bar=1e-5):
    return np.abs(got - want).max() < bar * max(1.0, np.abs(want).max())


def _unit(rng, d):
    x = rng.normal(size=(N, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clifford_inputs(d, seed):
    """Mean angles, concentrations from 0.03 to 10, and torus points near
    the mean (where a posterior's samples lie)."""
    rng = np.random.default_rng(seed)
    loc = rng.uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    kap = rng.uniform(0.03, 10.0, (N, d)).astype(np.float32)
    kap[0], kap[1] = 0.03, 10.0
    angles = (loc + rng.normal(size=(N, d)) * 0.5).astype(np.float32)
    return loc, kap, angles


@pytest.mark.parametrize("d", DIMS)
def test_power_spherical_matches_jax(d):
    rng = np.random.default_rng(d)
    loc, value = _unit(rng, d), _unit(rng, d)
    scale = rng.uniform(0.03, 10.0, N).astype(np.float32)
    want = jd.PowerSpherical(jnp.asarray(loc), jnp.asarray(scale))
    got = PowerSpherical(torch.from_numpy(loc), torch.from_numpy(scale))
    assert got.dim == d
    for name, args in (("log_normalizer", ()), ("entropy", ()),
                       ("log_prob", (value,))):
        w = np.asarray(getattr(want, name)(*map(jnp.asarray, args)))
        g = getattr(got, name)(*map(torch.from_numpy, args)).numpy()
        assert g.shape == w.shape == (N,)
        assert _close(g, w), name


def test_power_spherical_log_prob_clamps_the_dot_product():
    """value = -loc: the dot product -1 is clamped to -1 + 1e-7."""
    loc = np.array([[1.0, 0.0]], np.float32)
    scale = np.array([3.0], np.float32)
    want = np.asarray(jd.PowerSpherical(jnp.asarray(loc), jnp.asarray(scale))
                      .log_prob(jnp.asarray(-loc)))
    got = PowerSpherical(torch.from_numpy(loc), torch.from_numpy(scale)) \
        .log_prob(torch.from_numpy(-loc)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("d", DIMS)
def test_clifford_log_prob_and_entropy_match_jax(d):
    loc, kap, angles = _clifford_inputs(d, 10 + d)
    value = angles_to_torus(torch.from_numpy(angles))
    want = jd.CliffordPowerSphericalDistribution(jnp.asarray(loc),
                                                 jnp.asarray(kap))
    got = CliffordPowerSphericalDistribution(torch.from_numpy(loc),
                                             torch.from_numpy(kap))
    assert got.orig_dim == d
    lp_w = np.asarray(want.log_prob(jnp.asarray(value.numpy())))
    lp_g = got.log_prob(value).numpy()
    assert lp_g.shape == lp_w.shape == (N,)
    assert _close(lp_g, lp_w)
    assert _close(got.entropy().numpy(), np.asarray(want.entropy()))


@pytest.mark.parametrize("d", DIMS)
def test_zero_concentration_has_the_uniform_entropy(d):
    """kappa = 0: every free circle is uniform, so the entropy is the
    prior's (d-1) log 2 pi and the KL vanishes."""
    q = CliffordPowerSphericalDistribution(torch.zeros(N, d),
                                           torch.zeros(N, 1))
    p = CliffordTorusUniform(d)
    assert p.entropy() == pytest.approx((d - 1) * math.log(2 * math.pi))
    assert np.abs(q.entropy().numpy() - p.entropy()).max() < 1e-5
    assert np.abs(tkl.kl_divergence(q, p).numpy()).max() < 1e-5


@pytest.mark.parametrize("d", DIMS)
def test_entropy_gradient_in_kappa_matches_jax(d):
    """One concentration per row, expanded over the angles, as the model
    passes it: lgamma and digamma carry the gradient."""
    rng = np.random.default_rng(20 + d)
    loc = rng.uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    kap = rng.uniform(0.03, 10.0, (N, 1)).astype(np.float32)

    def total(k):
        return jd.CliffordPowerSphericalDistribution(
            jnp.asarray(loc), jnp.broadcast_to(k, loc.shape)).entropy().sum()

    want = np.asarray(jax.grad(total)(jnp.asarray(kap)))
    k = torch.from_numpy(kap).requires_grad_()
    CliffordPowerSphericalDistribution(
        torch.from_numpy(loc), k.expand(N, d)).entropy().sum().backward()
    assert np.abs(k.grad.numpy() - want).max() < 1e-4


@pytest.mark.parametrize("d", DIMS)
def test_torus_uniform_matches_jax(d):
    want, got = jd.CliffordTorusUniform(d), CliffordTorusUniform(d)
    assert got.entropy() == pytest.approx(want.entropy(), abs=1e-12)
    value = torch.zeros(3, 5, 2 * d)
    lp = got.log_prob(value)
    assert lp.shape == (3, 5) and lp.dtype == value.dtype
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(want.log_prob(jnp.zeros((3, 5, 2 * d)))),
        atol=1e-6)
    key = np.asarray(jax.random.PRNGKey(d), dtype=np.uint32)
    s_w = np.asarray(want.sample(key, (4, 3)))
    s_g = got.sample(key, (4, 3)).numpy()
    assert s_g.shape == s_w.shape == (4, 3, 2 * d)
    assert np.abs(s_g - s_w).max() < 1e-5


@pytest.mark.parametrize("d", DIMS)
def test_kl_matches_jax(d):
    loc, kap, _ = _clifford_inputs(d, 30 + d)
    want = np.asarray(jd.kl_divergence(
        jd.CliffordPowerSphericalDistribution(jnp.asarray(loc),
                                              jnp.asarray(kap)),
        jd.CliffordTorusUniform(d)))
    got = tkl.kl_divergence(
        CliffordPowerSphericalDistribution(torch.from_numpy(loc),
                                           torch.from_numpy(kap)),
        CliffordTorusUniform(d)).numpy()
    assert got.shape == want.shape == (N,)
    assert _close(got, want)
    assert (got > -1e-5).all()


def test_unregistered_kl_pair_raises_and_register_kl_adds_one():
    p = CliffordTorusUniform(4)
    with pytest.raises(NotImplementedError, match="No KL registered"):
        tkl.kl_divergence(p, p)

    class Point:
        pass

    @tkl.register_kl(Point, CliffordTorusUniform)
    def _kl(q, prior):
        return prior.entropy()

    try:
        assert tkl.kl_divergence(Point(), p) == p.entropy()
    finally:
        del tkl._KL_REGISTRY[(Point, CliffordTorusUniform)]
