"""MLP VAE for MNIST (port of ``cliffordtpu/nn/mlp_vae.py``).

Encoder 784-256-128 (ReLU), heads per latent family, decoder 128-256-784
logits; the decoder reads the 2d-wide torus point of a clifford latent.
Xavier-uniform weights and zero biases, drawn from ``seed``.  Heads:

* normal: mean (unit-normalised with ``l2_normalize``) and log-variance;
* powerspherical / vmf: unit mean, kappa = clip(softplus + 0.8, <= 10);
* clifford: raw mean angles, kappa = clip(softplus + 0.03, <= 10).

``MLPVAE`` trains one model.  ``LaneMLPVAE`` holds T models of the same
shape in stacked parameters (a leading lane axis on every weight) and
draws each lane's latent with its own key: the port's counterpart of
``jax.vmap`` over trials (``train/loop.py::fit_trials``).  Its layers run
lane by lane the product ``nn.Linear`` runs, so that a lane rounds as its
own ``MLPVAE`` does: a batched product rounds otherwise, and a ReLU input
near 0 turns that rounding into a different gradient, which Adam's
normalised step carries on (up to 2.4e-4 apart in two epochs on the card,
``scripts/torch_trial_lanes.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cliffordtpu_torch.distributions.reparam import (
    reparameterize,
    sample_latent,
)
from cliffordtpu_torch.nn.layers import reset_parameters

DISTRIBUTIONS = ("normal", "powerspherical", "vmf", "clifford")
LAYERS = ("enc1", "enc2", "fc_mean", "fc_var", "fc_scale", "dec1", "dec2",
          "dec3")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


class LaneLinear(nn.Module):
    """T independent ``nn.Linear`` layers: weight (T, out, in), bias
    (T, out); x (T, B, in) -> (T, B, out), each lane through
    ``F.linear``."""

    def __init__(self, lanes: int, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(lanes, d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(lanes, d_out))

    def forward(self, x):
        return torch.stack([F.linear(*lane) for lane in zip(
            x.unbind(0), self.weight.unbind(0), self.bias.unbind(0))])


class MLPVAE(nn.Module):
    """``forward(x, key)`` -> ((z_mean, z_param2), (q_z, p_z), z, x_recon)
    for images or rows x (B, ...) of 784 pixels and the sampling ``key``
    (two uint32 words; a JAX step derives it with ``make_rng("sample")``,
    ``random.sample_key``).  ``h_dim`` is kept, unused, as in the JAX
    module.  ``sampler`` is the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``, default "keyed")."""

    def __init__(self, h_dim: int, z_dim: int, distribution: str = "normal",
                 l2_normalize: bool = False, sampler: Optional[str] = None,
                 seed: Optional[int] = 0):
        super().__init__()
        if distribution not in DISTRIBUTIONS:
            raise ValueError(f"distribution must be one of {DISTRIBUTIONS}, "
                             f"got {distribution!r}")
        self.h_dim = h_dim
        self.z_dim = z_dim
        self.distribution = distribution
        self.l2_normalize = l2_normalize
        self.sampler = sampler
        self.enc1 = self._dense(784, 256)
        self.enc2 = self._dense(256, 128)
        self.fc_mean = self._dense(128, z_dim)
        if distribution == "normal":
            self.fc_var = self._dense(128, z_dim)
        else:
            self.fc_scale = self._dense(128, 1)
        self.dec1 = self._dense(2 * z_dim if distribution == "clifford"
                                else z_dim, 128)
        self.dec2 = self._dense(128, 256)
        self.dec3 = self._dense(256, 784)
        if seed is not None:
            reset_parameters(self, seed)

    def _dense(self, d_in: int, d_out: int) -> nn.Module:
        return nn.Linear(d_in, d_out)

    def encode(self, x):
        """Rows (..., 784) -> (z_mean, z_param2): the log-variance (..., d)
        for normal, else the concentration (..., 1)."""
        h = F.relu(self.enc2(F.relu(self.enc1(x))))
        z_mean = self.fc_mean(h)
        if self.distribution == "normal":
            if self.l2_normalize:
                z_mean = l2_normalize(z_mean)
            return z_mean, self.fc_var(h)
        floor = 0.03 if self.distribution == "clifford" else 0.8
        if self.distribution != "clifford":
            z_mean = l2_normalize(z_mean)
        return z_mean, torch.clamp(F.softplus(self.fc_scale(h)) + floor,
                                   max=10.0)

    def decode(self, z):
        """Latents (..., k) -> logits (..., 784)."""
        return self.dec3(F.relu(self.dec2(F.relu(self.dec1(z)))))

    def draw(self, key, z_mean, z_param2, sampler=None):
        """(q_z, p_z, z): the posterior, the prior and one draw of q_z."""
        q_z, p_z = reparameterize(self.distribution, z_mean, z_param2,
                                  self.z_dim)
        z = sample_latent(key, self.distribution, q_z, self.l2_normalize,
                          sampler or self.sampler)
        return q_z, p_z, z

    def forward(self, x, key):
        z_mean, z_param2 = self.encode(x.reshape(x.shape[0], -1))
        q_z, p_z, z = self.draw(key, z_mean, z_param2)
        return (z_mean, z_param2), (q_z, p_z), z, self.decode(z)

    def get_flat_latent(self, x, key, sampler=None):
        """Encode and draw: the flat latent (B, k)."""
        z_mean, z_param2 = self.encode(x.reshape(x.shape[0], -1))
        return self.draw(key, z_mean, z_param2, sampler)[2]


class LaneMLPVAE(MLPVAE):
    """T ``MLPVAE``s of one shape in stacked parameters (each of
    ``MLPVAE``'s names with a leading lane axis; zero until loaded, as
    ``train/loop.py::stack_trial_states`` does).  ``forward(x, keys)``
    takes x (T, B, ...) and T sampling keys; lane t computes what its own
    ``MLPVAE`` computes on x[t] and keys[t].  The posterior and prior it
    returns cover all lanes, (T, B, ...)."""

    def __init__(self, lanes: int, h_dim: int, z_dim: int,
                 distribution: str = "normal", l2_normalize: bool = False,
                 sampler: Optional[str] = None):
        self.lanes = lanes
        super().__init__(h_dim, z_dim, distribution, l2_normalize, sampler,
                         seed=None)

    def _dense(self, d_in: int, d_out: int) -> nn.Module:
        return LaneLinear(self.lanes, d_in, d_out)

    def forward(self, x, keys: Sequence):
        if len(keys) != self.lanes:
            raise ValueError(f"{self.lanes} lanes need as many keys, got "
                             f"{len(keys)}")
        z_mean, z_param2 = self.encode(x.reshape(self.lanes, x.shape[1], -1))
        q_z, p_z = reparameterize(self.distribution, z_mean, z_param2,
                                  self.z_dim)
        z = torch.stack([sample_latent(key, self.distribution, _lane(q_z, t),
                                       self.l2_normalize, self.sampler)
                         for t, key in enumerate(keys)])
        return (z_mean, z_param2), (q_z, p_z), z, self.decode(z)


def _lane(q_z, t: int):
    """Lane t of a posterior over lane-stacked parameters: the same family
    on the lane's slices of its location and its scale (or concentration)."""
    second = getattr(q_z, "concentration", None)
    if second is None:
        second = q_z.scale
    return type(q_z)(q_z.loc[t], second[t])
