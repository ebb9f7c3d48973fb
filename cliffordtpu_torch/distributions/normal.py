"""Diagonal Gaussian, the baseline latent family (port of
``cliffordtpu/distributions/normal.py``): reparameterised draws,
elementwise log_prob and entropy, and the closed-form KL between two
Gaussians.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random


class Normal:
    """Normal(loc, scale), elementwise."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, key, sample_shape=(), rows: random.Rows = None
               ) -> torch.Tensor:
        """loc + scale * eps, eps = ``jax.random.normal(key, shape)``; with
        ``rows=(row0, n_rows)`` the batch (the first axis after
        ``sample_shape``) is rows row0.. of a global batch of n_rows, and
        eps is those rows of the global draw."""
        shape = tuple(sample_shape) + torch.broadcast_shapes(
            self.loc.shape, self.scale.shape)
        eps = random.normal(key, shape, self.loc.device, rows,
                            len(tuple(sample_shape)))
        return self.loc + self.scale * eps.to(self.loc.dtype)

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self) -> torch.Tensor:
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)


def kl_normal_normal(q: Normal, p: Normal) -> torch.Tensor:
    """Elementwise KL(q || p) for diagonal Gaussians."""
    var_ratio = (q.scale / p.scale) ** 2
    t1 = ((q.loc - p.loc) / p.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
