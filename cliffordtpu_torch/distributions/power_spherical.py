"""Power Spherical distribution (De Cao & Aziz, 2020), rejection-free:
the marginal-t Beta draw, the T-transform, the Householder reflection,
density, normaliser and entropy (port of
``cliffordtpu/distributions/power_spherical.py``).

The Beta draw is one Gamma draw (``gamma.py``, implicit gradient in alpha)
against a chi-square of normals, with the JAX package's key splits, so
equal keys give equal samples, differentiable in ``loc`` and ``scale``.

Constants as in the reference: 1e-7 is added to ``scale``, to the norms
of the tangent draw and of the Householder vector, clamps 1 - t^2 from
below, and the dot product in ``log_prob`` is clamped to
(-1 + 1e-7, 1 - 1e-7).  ``torch.lgamma`` and ``torch.digamma`` carry the
gradient to ``scale``.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.distributions.gamma import gamma_sample

_EPS = 1e-7


def t_transform(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(t (..., 1), v (..., d-1)) -> (t, v sqrt(1 - t^2)) on S^(d-1)."""
    return torch.cat([t, v * torch.sqrt(torch.clamp(1.0 - t ** 2,
                                                    min=_EPS))], -1)


def beta_half_sample(key, alpha, n_half: int, shape,
                     rows: random.Rows = None, axis: int = 0
                     ) -> torch.Tensor:
    """Beta(alpha, n_half / 2) = X / (X + Y), X ~ Gamma(alpha) (implicit
    gradient), Y = half the sum of n_half squared normals; with ``rows``
    rows row0.. along ``axis`` of the global draw."""
    shape = tuple(shape)
    kx, ky = random.split_words(key)
    x = gamma_sample(kx, alpha, shape, rows=rows, axis=axis)
    z = random.normal(ky, shape + (n_half,), x.device, rows, axis)
    y = 0.5 * (z * z).sum(-1)
    return x / (x + y)


def marginal_t_sample(key, dim: int, scale, shape=()) -> torch.Tensor:
    """t = 2 Beta((d-1)/2 + scale + eps, (d-1)/2) - 1, the marginal of
    <loc, x>."""
    alpha = (dim - 1) / 2.0 + scale + _EPS
    return 2.0 * beta_half_sample(key, alpha, dim - 1, tuple(shape)) - 1.0


def marginal_t_entropy(dim: int, scale: torch.Tensor) -> torch.Tensor:
    """H[marginal t] = H[Beta(a, b)] + log 2."""
    a = (dim - 1) / 2.0 + scale + _EPS
    b = torch.tensor((dim - 1) / 2.0, dtype=a.dtype, device=a.device)
    ln_beta = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    h_beta = (ln_beta - (a - 1) * torch.digamma(a)
              - (b - 1) * torch.digamma(b)
              + (a + b - 2) * torch.digamma(a + b))
    return h_beta + math.log(2.0)


def _unit_tangent(key, shape, device, rows: random.Rows = None,
                  axis: int = 0) -> torch.Tensor:
    v = random.normal(key, shape, device, rows, axis)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)


def joint_ts_sample(key, dim: int, scale, shape=()) -> torch.Tensor:
    """A marginal-t draw beside a uniform S^(d-2) tangent draw."""
    k_t, k_v = random.split_words(key)
    t = marginal_t_sample(k_t, dim, scale, shape)[..., None]
    v = _unit_tangent(k_v, tuple(shape) + (dim - 1,), t.device)
    return torch.cat([t, v], -1)


def householder_reflect(x: torch.Tensor, loc: torch.Tensor,
                        eps: float = _EPS) -> torch.Tensor:
    """The Householder map sending e1 to loc (self-inverse); ``eps`` is
    added to the norm of e1 - loc."""
    u = -loc.clone()
    u[..., 0] += 1.0
    u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + eps)
    return x - 2.0 * (x * u).sum(-1, keepdim=True) * u


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

    def sample(self, key, sample_shape=(), rows: random.Rows = None
               ) -> torch.Tensor:
        """sample_shape + batch shape + (d,) points on S^(d-1), drawn with
        ``key``; differentiable in ``loc`` and ``scale``.  With ``rows=(row0,
        n_rows)`` the batch's first axis is rows row0.. of a global batch of
        n_rows, drawn as those rows of the global draw."""
        d = self.dim
        shape = tuple(sample_shape) + tuple(self.loc.shape[:-1])
        axis = len(tuple(sample_shape))
        k_t, k_v = random.split_words(key)
        alpha, _, _ = self._alpha_beta()
        alpha = torch.broadcast_to(alpha, self.loc.shape[:-1])
        t = 2.0 * beta_half_sample(k_t, alpha, d - 1, shape, rows,
                                   axis) - 1.0
        v = _unit_tangent(k_v, shape + (d - 1,), self.loc.device, rows, axis)
        y = t_transform(t[..., None].to(self.loc.dtype), v.to(self.loc.dtype))
        return householder_reflect(y, self.loc)

    rsample = sample

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
