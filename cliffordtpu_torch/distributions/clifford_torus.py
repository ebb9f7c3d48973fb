"""Clifford-torus latent distributions (port of
``cliffordtpu/distributions/clifford_torus.py``):

* ``CliffordPowerSphericalDistribution``: per-circle PowerSpherical
  concentration with the wrapped-phase reparameterisation, the models'
  clifford latent;
* ``CliffordTorusDistribution``: a product of von Mises on the torus,
  sampled by a fixed-budget Best-Fisher rejection that carries no
  gradient.  Like the JAX class it has ``sample`` and ``entropy`` (circles
  1..d-1) and no ``log_prob``.
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.distributions.bessel import von_mises_entropy
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical
from cliffordtpu_torch.kernels import sampler as sampler_kernel
from cliffordtpu_torch.ops.torus import angles_to_torus, torus_to_angles

SAMPLERS = ("keyed", "unfused", "rng")


@torch.no_grad()
def _sample_von_mises(key, loc, concentration, sample_shape=(),
                      n_rounds: int = 32, rows: random.Rows = None
                      ) -> torch.Tensor:
    """Best-Fisher (1979) wrapped-Cauchy rejection with ``n_rounds``
    proposals and a first-accept select; all misses (< 1e-15 at
    kappa <= 10) give ``loc``, kappa < 1e-4 a uniform angle.  Elementwise,
    so ``rows`` (the batch's first axis, ``random.counters``) draws those
    rows of the global draw."""
    shape = tuple(sample_shape) + torch.broadcast_shapes(
        loc.shape, concentration.shape)
    kappa = torch.broadcast_to(concentration, shape)
    mu = torch.broadcast_to(loc, shape)
    safe_kappa = torch.clamp(kappa, min=1e-5)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * safe_kappa ** 2)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * safe_kappa)
    r = (1.0 + rho ** 2) / (2.0 * rho)
    u = random.uniform(key, (n_rounds, 3) + shape, minval=1e-7,
                       maxval=1.0 - 1e-7, device=loc.device, rows=rows,
                       axis=2 + len(tuple(sample_shape)))
    z = torch.cos(math.pi * u[:, 0])
    f = (1.0 + r * z) / (r + z)
    c = safe_kappa * (r - f)
    accept = (c * (2.0 - c) - u[:, 1] > 0.0) | (
        torch.log(c / u[:, 1]) + 1.0 - c >= 0.0)
    theta = torch.sign(u[:, 2] - 0.5) * torch.arccos(torch.clamp(f, -1.0,
                                                                 1.0))
    idx = accept.to(torch.uint8).argmax(0)
    chosen = torch.gather(theta, 0, idx[None])[0]
    delta = torch.where(accept.any(0), chosen, 0.0)
    uniform = (u[0, 0] * 2.0 - 1.0) * math.pi
    delta = torch.where(kappa < 1e-4, uniform, delta)
    return mu + delta


class CliffordTorusDistribution:
    """Product of von Mises on the Clifford torus; event shape (2d,),
    d = loc.shape[-1]."""

    def __init__(self, loc: torch.Tensor, concentration: torch.Tensor):
        self.loc = loc  # (..., d) mean angles
        self.concentration = concentration  # broadcastable to loc

    @property
    def orig_dim(self) -> int:
        return self.loc.shape[-1]

    def _params(self):
        return torch.broadcast_tensors(self.loc, self.concentration)

    def sample(self, key, sample_shape=(), rows: random.Rows = None
               ) -> torch.Tensor:
        """Torus points sample_shape + (..., 2d); no gradient, as in the
        reference.  ``rows``: as ``CliffordPowerSphericalDistribution``."""
        loc, kappa = self._params()
        return angles_to_torus(_sample_von_mises(key, loc, kappa,
                                                 sample_shape, rows=rows))

    rsample = sample

    def entropy(self) -> torch.Tensor:
        """Sums circles 1..d-1."""
        _, kappa = self._params()
        return von_mises_entropy(kappa)[..., 1:].sum(-1)


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

    @staticmethod
    def _circle_ps(loc_angles, kappa) -> PowerSpherical:
        mean_dirs = torch.stack([torch.cos(loc_angles),
                                 torch.sin(loc_angles)], -1)
        return PowerSpherical(mean_dirs, kappa)

    def sample(self, key, sample_shape=(), sampler: str = "keyed",
               rows: random.Rows = None) -> torch.Tensor:
        """Reparameterised draws sample_shape + (..., 2d), differentiable in
        ``loc`` and ``concentration``.  With a ``sample_shape`` the draw
        takes the ``"unfused"`` route whatever ``sampler`` says, as the JAX
        package never fuses one: u and v of shape sample_shape + loc's on
        the split key.  Without one, ``sampler`` names the route
        (``SAMPLERS``), the port's form of the JAX package's
        ``CLIFFORDTPU_SAMPLER``:

        * ``"keyed"`` (``pallas_keyed``): the fused keyed kernel
          (``kernels/sampler.py::sample_embed_keyed``), one launch, on the
          same u and v that ``jax.random`` gives this key;
        * ``"unfused"`` (JAX's default): the same u and v from
          ``random.uniform``, the circle formula in tensor operations, then
          ``ops.torus.angles_to_torus`` (the embedding kernel for large
          latents on the card);
        * ``"rng"`` (``pallas_rng``): the fused Philox kernel
          (``sample_embed_rng``), a different stream by design.

        ``rows=(row0, n_rows)``: the batch (the first axis after
        ``sample_shape``) is rows row0.. of a global batch of n_rows, as a
        rank of a data-parallel step holds it; every route draws exactly
        those rows of the global draw, bit for bit.  The fused kernels
        count per (row, circle) over the flattened rows, so the tokens of
        a row (``loc`` (B, T, d)) fold in: flat row row0 * T."""
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got "
                             f"{sampler!r}")
        loc, kappa = self._params()
        d = loc.shape[-1]
        sample_shape = tuple(sample_shape)
        if sample_shape or sampler == "unfused":
            shape = sample_shape + loc.shape
            k_u, k_v = random.split_words(key)
            axis = len(sample_shape)
            u = random.uniform(k_u, shape, minval=sampler_kernel.U_MIN,
                               device=loc.device, rows=rows, axis=axis)
            v = random.uniform(k_v, shape, device=loc.device, rows=rows,
                               axis=axis)
            return angles_to_torus(
                sampler_kernel.circle_angles(loc, kappa, u, v))
        fused = (sampler_kernel.sample_embed_keyed if sampler == "keyed"
                 else sampler_kernel.sample_embed_rng)
        flat_rows = None
        if rows is not None:
            per_row = math.prod(loc.shape[1:-1])
            flat_rows = (rows[0] * per_row, rows[1] * per_row)
        x, _, _, _ = fused(key, loc.reshape(-1, d).float(),
                           kappa.reshape(-1, d).float(), rows=flat_rows)
        return x.reshape(*loc.shape[:-1], 2 * d).to(loc.dtype)

    rsample = sample

    def sample_from_uniforms(self, u: torch.Tensor, v: torch.Tensor
                             ) -> torch.Tensor:
        """The same draw from explicit uniforms u, v of loc's shape."""
        loc, kappa = self._params()
        return angles_to_torus(
            sampler_kernel.circle_angles(loc, kappa, u, v))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Sums ALL d circles, as the reference does."""
        loc, kappa = self._params()
        angles = torus_to_angles(value)
        vecs = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
        return self._circle_ps(loc, kappa).log_prob(vecs).sum(-1)

    def entropy(self) -> torch.Tensor:
        """Sums circles 1..d-1 (angle 0 is pinned)."""
        loc, kappa = self._params()
        return self._circle_ps(loc, kappa).entropy()[..., 1:].sum(-1)
