"""Clifford-torus PowerSpherical distribution, sampling only (port of
``cliffordtpu/distributions/clifford_torus.py:108-178``).

log_prob, entropy and the KL belong to training and come with it.
"""

from __future__ import annotations

import torch

from cliffordtpu_torch.kernels import sampler
from cliffordtpu_torch.ops.torus import angles_to_torus


class CliffordPowerSphericalDistribution:
    """Per-circle PowerSpherical concentration with the wrapped-phase
    reparameterisation theta = loc + (closed-form circle draw), embedded
    on the Clifford torus in R^{2d}.  Angle 0 is pinned to phase 0."""

    def __init__(self, loc: torch.Tensor, concentration: torch.Tensor):
        self.loc = loc  # (..., d) mean angles
        self.concentration = concentration  # broadcastable to loc

    @property
    def orig_dim(self) -> int:
        return self.loc.shape[-1]

    def _params(self):
        return torch.broadcast_tensors(self.loc, self.concentration)

    def sample(self, key) -> torch.Tensor:
        """One draw (..., 2d) on the keyed threefry stream: the same u and v
        that ``jax.random`` gives this key, through the fused kernel on the
        card (``kernels/sampler.py``)."""
        loc, kappa = self._params()
        d = loc.shape[-1]
        x, _, _, _ = sampler.sample_embed_keyed(
            key, loc.reshape(-1, d).float(), kappa.reshape(-1, d).float())
        return x.reshape(*loc.shape[:-1], 2 * d).to(loc.dtype)

    rsample = sample

    def sample_from_uniforms(self, u: torch.Tensor, v: torch.Tensor
                             ) -> torch.Tensor:
        """The same draw from explicit uniforms u, v of loc's shape."""
        loc, kappa = self._params()
        return angles_to_torus(sampler.circle_angles(loc, kappa, u, v))
