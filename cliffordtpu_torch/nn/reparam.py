"""Posterior and prior construction and sampling (port of
``cliffordtpu/nn/reparam.py``, clifford branch only).
"""

from __future__ import annotations

from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.distributions.uniforms import CliffordTorusUniform


def reparameterize(distribution: str, z_mean, z_param2, z_dim: int):
    """(q_z, p_z) from the encoder heads; ``z_param2`` is the
    concentration."""
    if distribution != "clifford":
        raise NotImplementedError(
            f"only the clifford latent is ported, not {distribution!r}")
    return (CliffordPowerSphericalDistribution(z_mean, z_param2),
            CliffordTorusUniform(z_dim))


def sample_latent(key, distribution: str, q_z, sampler: str = "keyed"):
    """One reparameterised draw of q_z with the sampling ``key``, through
    the ``sampler`` route (``distributions/clifford_torus.py::SAMPLERS``)."""
    return q_z.sample(key, sampler=sampler)
