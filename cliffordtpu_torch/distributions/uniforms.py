"""Uniform reference measures (port of
``cliffordtpu/distributions/uniforms.py``): the hypersphere, in its two
conventions, and the Clifford torus.

* ``HypersphericalUniform(dim=d)``: S^(d-1) in R^d, the PowerSpherical
  prior;
* ``VMFHypersphericalUniform(dim=d)``: S^d in R^(d+1), the vMF prior;
  callers pass ``z_dim - 1`` (``nn/reparam.py``);
* ``CliffordTorusUniform(dim=d)``: the torus (S^1)^d in R^(2d).

Samplers take a key and draw from the keyed threefry stream.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.ops.torus import angles_to_torus


_EPS = 1e-7


class HypersphericalUniform:
    """Uniform on S^(dim-1) embedded in R^dim."""

    def __init__(self, dim: int):
        self.dim = dim

    def sample(self, key, sample_shape=(), device=None) -> torch.Tensor:
        v = random.normal(key, tuple(sample_shape) + (self.dim,), device)
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)

    rsample = sample

    def _log_normalizer(self) -> float:
        return math.lgamma(self.dim / 2) - (
            math.log(2) + (self.dim / 2) * math.log(math.pi))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.full(value.shape[:-1], self._log_normalizer(),
                          dtype=value.dtype, device=value.device)

    def entropy(self) -> float:
        return -self._log_normalizer()


class VMFHypersphericalUniform:
    """Uniform on S^dim embedded in R^(dim+1)."""

    def __init__(self, dim: int):
        self.dim = dim

    def sample(self, key, sample_shape=(), device=None) -> torch.Tensor:
        v = random.normal(key, tuple(sample_shape) + (self.dim + 1,), device)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    rsample = sample

    def _log_surface_area(self) -> float:
        return (math.log(2) + ((self.dim + 1) / 2) * math.log(math.pi)
                - math.lgamma((self.dim + 1) / 2))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.full(value.shape[:-1], -self._log_surface_area(),
                          dtype=value.dtype, device=value.device)

    def entropy(self) -> float:
        return self._log_surface_area()


class CliffordTorusUniform:
    """Uniform on the Clifford torus (S^1)^d embedded in R^{2d}.  Only d-1
    angles are free (index 0 is pinned), hence ``entropy = (d-1) log 2 pi``
    and ``log_prob = -entropy``."""

    def __init__(self, dim: int):
        self.dim = dim

    def sample(self, key, sample_shape=(), device=None) -> torch.Tensor:
        """Torus points sample_shape + (2d,) from the keyed threefry
        stream: the angles are ``jax.random.uniform(key, shape + (d,))``
        times 2 pi."""
        angles = random.uniform(key, tuple(sample_shape) + (self.dim,),
                                device=device) * (2.0 * math.pi)
        return angles_to_torus(angles)

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.full(value.shape[:-1], -self.entropy(),
                          dtype=value.dtype, device=value.device)

    def entropy(self) -> float:
        return (self.dim - 1) * math.log(2 * math.pi)
