"""Posterior and prior construction and sampling, every latent family
(port of ``cliffordtpu/nn/reparam.py``), and ``draw_flat``, the serving
draw.  It lives beside the distributions, not the models, so that a loaded
serving bundle draws without importing ``cliffordtpu_torch.nn``.
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
                  sampler: Optional[str] = None, rows=None) -> torch.Tensor:
    """One reparameterised draw of q_z with the sampling ``key``.  With
    ``l2_normalize`` a Gaussian draw is scaled to unit norm.  ``sampler``
    names the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``); the other families
    have one route, and a ``sampler`` for them raises.  ``rows=(row0,
    n_rows)``: q_z's batch is rows row0.. of a global batch of n_rows, and
    the draw is those rows of the global draw (every family)."""
    if distribution == "clifford":
        return q_z.sample(key, sampler=sampler or "keyed", rows=rows)
    if sampler is not None:
        raise ValueError(f"sampler={sampler!r} names a route of the "
                         f"clifford draw; the {distribution} latent has none")
    z = q_z.sample(key, rows=rows)
    if distribution in ("normal", "gaussian") and l2_normalize:
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return z


def draw_flat(key, mu, param2, distribution: str, latent_dim: int,
              l2_normalize: bool = False, sampler: Optional[str] = None,
              scale: float = 1.0, rows=None) -> torch.Tensor:
    """A model's ``get_flat_latent`` after its encoder heads: the posterior
    of the heads (mu (B, [T,] d) and ``param2``; a per-token clifford
    concentration (B, T) broadcast over the circles), one draw with the
    sampling ``key``, times ``scale`` (sqrt(d) for ``CliffordARVAE``'s
    powerspherical head), flattened to (B, T*k); ``rows`` as
    ``sample_latent``."""
    if distribution == "clifford" and param2.dim() < mu.dim():
        param2 = param2[..., None]
    q_z, _ = reparameterize(distribution, mu, param2, latent_dim)
    z = sample_latent(key, distribution, q_z, l2_normalize, sampler, rows)
    if scale != 1.0:
        z = z * scale
    return z.reshape(z.shape[0], -1)
