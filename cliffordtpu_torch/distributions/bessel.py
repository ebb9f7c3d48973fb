"""Modified-Bessel helpers of the von Mises and vMF distributions (port of
``cliffordtpu/distributions/bessel.py``): ``log_ive`` as a 64-term
log-space power series (float32-exact for the clamped concentrations,
kappa <= 10, and differentiable by autograd), the Bessel-ratio bounds and
the von Mises entropy.
"""

from __future__ import annotations

import math

import torch

_SERIES_TERMS = 64


def log_iv_series(v, z, n_terms: int = _SERIES_TERMS) -> torch.Tensor:
    """log I_v(z) = logsumexp_k [(2k + v) log(z/2) - lgamma(k + 1)
    - lgamma(k + v + 1)], for v >= 0, z >= 0; I_v(0) = 1 if v == 0 else 0."""
    v = torch.as_tensor(v, dtype=torch.float32)
    z = torch.as_tensor(z, dtype=torch.float32)
    v, z = torch.broadcast_tensors(v.to(z.device), z)
    log_half_z = torch.log(torch.clamp(z, min=1e-30) / 2.0)
    k = torch.arange(n_terms, dtype=torch.float32, device=z.device)
    terms = ((2.0 * k + v[..., None]) * log_half_z[..., None]
             - torch.lgamma(k + 1.0) - torch.lgamma(k + v[..., None] + 1.0))
    out = torch.logsumexp(terms, -1)
    zero_val = torch.where(v == 0, 0.0, -math.inf)
    return torch.where(z == 0, zero_val, out)


def log_ive(v, z) -> torch.Tensor:
    """log(I_v(z) exp(-z))."""
    z = torch.as_tensor(z, dtype=torch.float32)
    return log_iv_series(v, z) - z


def ive(v, z) -> torch.Tensor:
    """I_v(z) exp(-z)."""
    return torch.exp(log_ive(v, z))


def ive_fraction_approx(v, z) -> torch.Tensor:
    """Lower bound on I_v(z) / I_{v-1}(z) (arXiv:1606.02008)."""
    return z / (v - 1 + torch.sqrt((v + 1) ** 2 + z ** 2))


def ive_fraction_approx2(v, z, eps: float = 1e-20) -> torch.Tensor:
    """Two-sided bound on I_v(z) / I_{v-1}(z) (arXiv:1902.02603), with
    the reference's 1e-20 clamps."""

    def delta_a(a):
        lamb = v + (a - 1.0) / 2.0
        return (v - 0.5) + lamb / (
            2 * torch.sqrt(torch.clamp(lamb ** 2 + z ** 2, min=eps)))

    delta_0, delta_2 = delta_a(0.0), delta_a(2.0)
    b_0 = z / torch.clamp(delta_0 + torch.sqrt(delta_0 ** 2 + z ** 2),
                          min=eps)
    b_2 = z / torch.clamp(delta_2 + torch.sqrt(delta_2 ** 2 + z ** 2),
                          min=eps)
    return (b_0 + b_2) / 2.0


def von_mises_entropy(kappa: torch.Tensor) -> torch.Tensor:
    """H[vM(kappa)] = log(2 pi I0(kappa)) - kappa I1(kappa) / I0(kappa),
    from i0e and i1e with 1e-7 inside the logs."""
    log_i0 = torch.log(torch.special.i0e(kappa) + 1e-7) + kappa
    log_i1 = torch.log(torch.special.i1e(kappa) + 1e-7) + kappa
    return (math.log(2 * math.pi) + log_i0
            - kappa * torch.exp(log_i1 - log_i0))
