"""Uniform reference measures (port of
``cliffordtpu/distributions/uniforms.py``): the Clifford torus.

The hypersphere uniforms come with the PowerSpherical and vMF families.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.ops.torus import angles_to_torus


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
