"""Posterior and prior construction and sampling, every latent family
(port of ``cliffordtpu/nn/reparam.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.distributions.normal import Normal
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical
from cliffordtpu_torch.distributions.uniforms import (
    CliffordTorusUniform,
    HypersphericalUniform,
    VMFHypersphericalUniform,
)
from cliffordtpu_torch.distributions.von_mises_fisher import VonMisesFisher

DISTRIBUTIONS = ("normal", "gaussian", "powerspherical", "vmf", "clifford")


def reparameterize(distribution: str, z_mean, z_param2, z_dim: int):
    """(q_z, p_z) from the encoder heads: ``z_param2`` is the log-variance
    for "normal" / "gaussian" and the concentration otherwise.  A
    powerspherical scalar-kappa head (..., 1) is squeezed; the vMF prior
    takes ``z_dim - 1`` (its S^d in R^(d+1) convention)."""
    if distribution in ("normal", "gaussian"):
        std = torch.exp(0.5 * z_param2) + 1e-6
        return (Normal(z_mean, std),
                Normal(torch.zeros_like(z_mean), torch.ones_like(std)))
    if distribution == "powerspherical":
        scale = z_param2
        if scale.dim() == z_mean.dim():
            scale = scale[..., 0]
        return PowerSpherical(z_mean, scale), HypersphericalUniform(z_dim)
    if distribution == "vmf":
        return (VonMisesFisher(z_mean, z_param2),
                VMFHypersphericalUniform(z_dim - 1))
    if distribution == "clifford":
        return (CliffordPowerSphericalDistribution(z_mean, z_param2),
                CliffordTorusUniform(z_dim))
    raise ValueError(f"unknown distribution: {distribution}")


def sample_latent(key, distribution: str, q_z, l2_normalize: bool = False,
                  sampler: Optional[str] = None) -> torch.Tensor:
    """One reparameterised draw of q_z with the sampling ``key``.  With
    ``l2_normalize`` a Gaussian draw is scaled to unit norm.  ``sampler``
    names the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``); the other families
    have one route, and a ``sampler`` for them raises."""
    if distribution == "clifford":
        return q_z.sample(key, sampler=sampler or "keyed")
    if sampler is not None:
        raise ValueError(f"sampler={sampler!r} names a route of the "
                         f"clifford draw; the {distribution} latent has none")
    z = q_z.sample(key)
    if distribution in ("normal", "gaussian") and l2_normalize:
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z
