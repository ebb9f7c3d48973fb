"""von Mises-Fisher distribution with a Householder-rotation sampler (port
of ``cliffordtpu/distributions/von_mises_fisher.py``).

* m = 3: the closed-form inverse CDF of w, in log space;
* otherwise: Ulrich's rejection with a fixed budget of K = 32 proposals
  and a first-accept select (the fallback is the last proposal).  Its
  Beta(c, c) proposals are two ``gamma_sample`` draws and carry no
  gradient; the gradient in ``scale`` flows through b(scale) and w(b, e);
* the Householder map has the reference's 1e-5 epsilon;
* ``entropy`` and ``log_prob`` use ``bessel.py``'s series.

The key splits are the JAX package's, so equal keys give equal samples.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.distributions.bessel import (
    ive_fraction_approx2,
    log_ive,
)
from cliffordtpu_torch.distributions.gamma import (
    first_accept_index,
    gamma_sample,
)
from cliffordtpu_torch.distributions.power_spherical import (
    householder_reflect,
)

_REJECTION_ROUNDS = 32


class VonMisesFisher:
    """vMF(loc, scale) on S^(m-1), m = loc.shape[-1]; ``scale`` (...,) or
    (..., 1), used as a trailing singleton."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def m(self) -> int:
        return self.loc.shape[-1]

    def _kappa1(self) -> torch.Tensor:
        """scale with a trailing singleton, broadcast to the batch shape."""
        s = self.scale
        if s.dim() < self.loc.dim():
            s = s[..., None]
        elif s.shape[-1] != 1:
            s = s[..., :1]
        return torch.broadcast_to(s, self.loc.shape[:-1] + (1,))

    @property
    def mean(self) -> torch.Tensor:
        return self.loc * ive_fraction_approx2(
            torch.tensor(self.m / 2, dtype=self.loc.dtype,
                         device=self.loc.device), self._kappa1())

    def sample(self, key, sample_shape=()) -> torch.Tensor:
        sample_shape = tuple(sample_shape)
        k_w, k_v = random.split_words(key)
        kappa1 = self._kappa1()
        kappa = torch.broadcast_to(kappa1, sample_shape + kappa1.shape)
        w = (self._sample_w3(k_w, kappa) if self.m == 3
             else self._sample_w_rej(k_w, kappa))
        v = random.normal(k_v, sample_shape + self.loc.shape[:-1]
                          + (self.m - 1,), device=self.loc.device)
        v = v.to(self.loc.dtype)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        w_ = torch.sqrt(torch.clamp(1.0 - w ** 2, min=1e-10))
        # the reference's vMF epsilon, 1e-5 (PowerSpherical's is 1e-7)
        return householder_reflect(torch.cat([w, w_ * v], -1), self.loc,
                                   eps=1e-5)

    rsample = sample

    def _sample_w3(self, key, kappa: torch.Tensor) -> torch.Tensor:
        """w = 1 + log(u + (1 - u) exp(-2 kappa)) / kappa, in log space."""
        u = random.uniform(key, kappa.shape, minval=1e-7, maxval=1.0 - 1e-7,
                           device=kappa.device)
        lse = torch.logaddexp(torch.log(u), torch.log1p(-u) - 2.0 * kappa)
        return 1.0 + lse / kappa

    def _sample_w_rej(self, key, kappa: torch.Tensor) -> torch.Tensor:
        """Fixed-budget Ulrich rejection."""
        m = float(self.m)
        c = torch.sqrt(4.0 * kappa ** 2 + (m - 1.0) ** 2)
        b_true = (-2.0 * kappa + c) / (m - 1.0)
        b_app = (m - 1.0) / (4.0 * kappa)
        # jnp.clip's form, whose gradient is split at a tie (kappa == 10,
        # where a clipped encoder head saturates); torch.clamp passes it
        s = torch.minimum(torch.maximum(kappa - 10.0, torch.zeros_like(kappa)),
                          torch.ones_like(kappa))
        b = b_app * s + b_true * (1.0 - s)
        a = (m - 1.0 + 2.0 * kappa + c) / 4.0
        d = (4.0 * a * b) / (1.0 + b) - (m - 1.0) * math.log(m - 1.0)
        K = _REJECTION_ROUNDS
        k_e, k_u = random.split_words(key)
        con = (m - 1.0) / 2.0
        k_e1, k_e2 = random.split_words(k_e)
        shape = (K,) + tuple(kappa.shape)
        with torch.no_grad():  # the proposals carry no gradient
            gx = gamma_sample(k_e1, con, shape, device=kappa.device)
            gy = gamma_sample(k_e2, con, shape, device=kappa.device)
            e = (gx / (gx + gy)).to(kappa.dtype)
        u = random.uniform(k_u, shape, minval=1e-7, maxval=1.0 - 1e-7,
                           device=kappa.device)
        w = (1.0 - (1.0 + b) * e) / (1.0 - (1.0 - b) * e)
        t = (2.0 * a * b) / (1.0 - (1.0 - b) * e)
        accept = ((m - 1.0) * torch.log(t) - t + d) > torch.log(u)
        return torch.gather(w, 0, first_accept_index(accept)[None])[0]

    def entropy(self) -> torch.Tensor:
        kappa = self._kappa1()
        out = -kappa * ive_fraction_approx2(
            torch.tensor(self.m / 2, dtype=kappa.dtype, device=kappa.device),
            kappa)
        return out[..., 0] + self._log_normalization()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self._log_unnormalized_prob(x) - self._log_normalization()

    def _log_unnormalized_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (self._kappa1() * self.loc * x).sum(-1)

    def _log_normalization(self) -> torch.Tensor:
        """With the reference's 1e-20 inside the log."""
        kappa = self._kappa1()[..., 0]
        m_by_2 = self.m / 2.0
        log_ive_val = torch.log(torch.exp(log_ive(m_by_2 - 1.0, kappa))
                                + 1e-20)
        return -((m_by_2 - 1.0) * torch.log(kappa)
                 - m_by_2 * math.log(2 * math.pi) - (kappa + log_ive_val))
