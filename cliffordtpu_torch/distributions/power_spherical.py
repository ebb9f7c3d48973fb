"""Power Spherical distribution (De Cao & Aziz, 2020): density, normaliser
and entropy (port of ``cliffordtpu/distributions/power_spherical.py``).

The samplers of that module (marginal-t Beta draw, T-transform, Householder
reflection) are not ported yet; the Clifford-torus posterior draws its
circles in closed form (``kernels/sampler.py``).

Constants as in the reference: 1e-7 is added to ``scale``, and the dot
product in ``log_prob`` is clamped to (-1 + 1e-7, 1 - 1e-7).
``torch.lgamma`` and ``torch.digamma`` carry the gradient to ``scale``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


class PowerSpherical:
    """PowerSpherical(loc, scale) on S^(d-1), d = loc.shape[-1];
    batch shape ``loc.shape[:-1]``.

    ``loc`` (..., d) is the unit mean direction, ``scale`` (...,) the
    concentration kappa >= 0."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def _alpha_beta(self):
        safe_scale = self.scale + _EPS
        beta = (self.dim - 1) / 2.0
        return beta + safe_scale, beta, safe_scale

    def log_normalizer(self) -> torch.Tensor:
        alpha, beta, _ = self._alpha_beta()
        return -((alpha + beta) * math.log(2) + torch.lgamma(alpha)
                 - torch.lgamma(alpha + beta) + beta * math.log(math.pi))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        dot = (self.loc * value).sum(-1)
        safe_dot = torch.clamp(dot, min=-1.0 + _EPS, max=1.0 - _EPS)
        return self.log_normalizer() + self.scale * torch.log1p(safe_dot)

    def entropy(self) -> torch.Tensor:
        alpha, beta, safe_scale = self._alpha_beta()
        return -(self.log_normalizer() + safe_scale * (
            math.log(2) + torch.digamma(alpha) - torch.digamma(alpha + beta)))
