"""ResNet CNN VAE (port of ``cliffordtpu/nn/conv_vae.py``): ``ResBlock``,
``ResUpBlock``, ``Encoder``, ``Decoder``, ``CNNVAE``, the clifford
concentration-floor schedule and ``cnn_vae_loss``, which the ViT family
shares.

Layouts at the public functions follow the JAX package: images
(B, H, W, C), latents (B, 2d).  The convolution stacks run in PyTorch's
NCHW; where the JAX modules flatten their NHWC feature map (before the
encoder's heads, after the decoder's first Dense) the port permutes the
2 x 2 x 512 map to NHWC order first, so the head and Dense weights carry
across as plain transposes (``param_import.py::cnnvae_from_jax``).

``compute_dtype`` plays the role of JAX's ``dtype``: the convolution stacks
and the decoder's Dense run in it; the encoder's heads, the sampler, the
loss and the decoder's last transposed convolution with its tanh are
float32.  Parameters are float32 throughout (``nn/layers.py``).

The heads of the three latents the JAX model has: clifford (mean angles
and one concentration; the decoder reads the 2d-wide torus point),
gaussian (mean and log-variance) and powerspherical (a unit mean and one
concentration); the last two decode a d-wide latent.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cliffordtpu_torch.distributions.kl import kl_divergence
from cliffordtpu_torch.nn.layers import Conv, ConvT, Linear, reset_parameters
from cliffordtpu_torch.nn.mlp_vae import l2_normalize
from cliffordtpu_torch.nn.reparam import reparameterize, sample_latent

HEADS = ("clifford", "gaussian", "powerspherical")


def clifford_concentration_floor(latent_dim: int) -> float:
    """The kappa floor, scaled with the latent dim."""
    if latent_dim < 256:
        return 0.04
    elif latent_dim <= 512:
        return 0.07
    elif latent_dim <= 1024:
        return 0.10
    elif latent_dim <= 2048:
        return 0.13
    return 0.16


class ResBlock(nn.Module):
    """4x4 stride-2 convolution + LeakyReLU(0.2), plus a skip of a 1x1
    convolution (when the channels change) THEN a 2x2 average pool.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, 4, 2, 1, dtype, bias=True)
        self.skip = (Conv(in_ch, out_ch, 1, dtype=dtype, bias=True)
                     if in_ch != out_ch else None)

    def forward(self, x):
        h = F.leaky_relu(self.conv(x), 0.2)
        skip = x.to(h.dtype) if self.skip is None else self.skip(x)
        return h + F.avg_pool2d(skip, 2)


class ResUpBlock(nn.Module):
    """4x4 stride-2 transposed convolution + LeakyReLU(0.2), plus a skip of
    a 1x1 convolution (when the channels change) then a nearest x2
    upsample.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = ConvT(in_ch, out_ch, 4, 1, dtype, bias=True)
        self.skip = (Conv(in_ch, out_ch, 1, dtype=dtype, bias=True)
                     if in_ch != out_ch else None)

    def forward(self, x):
        h = F.leaky_relu(self.conv(x), 0.2)
        skip = x.to(h.dtype) if self.skip is None else self.skip(x)
        return h + F.interpolate(skip, scale_factor=2, mode="nearest")


def _check_head(distribution: str):
    if distribution not in HEADS:
        raise ValueError(f"distribution must be one of {HEADS}, got "
                         f"{distribution!r}")


class Encoder(nn.Module):
    """Image (B, H, W, C) -> the heads, float32: clifford (mu (B, d),
    kappa (B, 1) = clip(softplus(.) + floor, <= 10)); gaussian (mu,
    l2-normalised with ``l2_normalize``, and log_var (B, d));
    powerspherical (unit mu, kappa = clip(softplus(.) + 0.5, <= 10))."""

    def __init__(self, latent_dim: int, in_channels: int,
                 distribution: str = "clifford",
                 concentration_floor: float = 0.1, img_size: int = 32,
                 dtype=torch.float32, l2_normalize: bool = False):
        super().__init__()
        _check_head(distribution)
        chs = ([64, 128, 256, 512, 512] if img_size == 64
               else [64, 128, 256, 512])
        self.distribution = distribution
        self.l2_normalize = l2_normalize
        self.concentration_floor = concentration_floor
        self.blocks = nn.ModuleList(
            ResBlock(a, b, dtype) for a, b in zip([in_channels] + chs, chs))
        self.mu = Linear(512 * 2 * 2, latent_dim, torch.float32, bias=True)
        if distribution == "gaussian":
            self.log_var = Linear(512 * 2 * 2, latent_dim, torch.float32,
                                  bias=True)
        else:
            self.kappa = Linear(512 * 2 * 2, 1, torch.float32, bias=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        # the JAX module flattens its NHWC map: (h, w, c) order
        x = x.float().permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        mu = self.mu(x)
        if self.distribution == "gaussian":
            if self.l2_normalize:
                mu = l2_normalize(mu)
            return mu, self.log_var(x)
        if self.distribution == "powerspherical":
            return l2_normalize(mu), torch.clamp(
                F.softplus(self.kappa(x)) + 0.5, max=10.0)
        kappa = torch.clamp(
            F.softplus(self.kappa(x)) + self.concentration_floor, max=10.0)
        return mu, kappa


class Decoder(nn.Module):
    """Latent (B, z_dim) -> image (B, H, W, C) in (-1, 1).  The last
    transposed convolution and the tanh are float32."""

    def __init__(self, z_dim: int, out_channels: int, img_size: int = 32,
                 dtype=torch.float32):
        super().__init__()
        chs = [512, 256, 128, 64] if img_size == 64 else [256, 128, 64]
        self.fc = Linear(z_dim, 512 * 2 * 2, dtype, bias=True)
        self.blocks = nn.ModuleList(
            ResUpBlock(a, b, dtype) for a, b in zip([512] + chs, chs))
        self.conv_out = ConvT(chs[-1], out_channels, 4, 1, torch.float32,
                              bias=True)

    def forward(self, z):
        # the JAX module reshapes to an NHWC map (B, 2, 2, 512)
        x = self.fc(z).reshape(z.shape[0], 2, 2, 512).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        return torch.tanh(self.conv_out(x.float())).permute(0, 2, 3, 1)


class CNNVAE(nn.Module):
    """ResNet CNN VAE with one latent per image (``HEADS``): ``forward``
    (the training path), ``encode`` / ``encode_heads``, ``reparam``,
    ``decode``, ``get_flat_latent``, ``loss_sigmas``.

    ``sampler`` is the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``, default "keyed"); the
    other latents have one route and refuse a ``sampler``.  With
    ``l2_normalize`` a gaussian model normalises its mean and its draw.
    ``seed`` makes the random initialisation reproducible; weights
    carried from JAX replace it (``nn/param_import.py::cnnvae_from_jax``)."""

    def __init__(self, latent_dim: int, in_channels: int,
                 distribution: str = "clifford", recon_loss_type: str = "l1",
                 l1_weight: float = 1.0, img_size: int = 32,
                 use_learnable_beta: bool = False,
                 sampler: Optional[str] = None, l2_normalize: bool = False,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        _check_head(distribution)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        self.latent_dim = latent_dim
        self.in_channels = in_channels
        self.distribution = distribution
        self.recon_loss_type = recon_loss_type
        self.l1_weight = l1_weight
        self.img_size = img_size
        self.use_learnable_beta = use_learnable_beta
        self.sampler = sampler
        self.l2_normalize = l2_normalize
        self.compute_dtype = compute_dtype
        self.floor = clifford_concentration_floor(latent_dim)
        self.encoder = Encoder(latent_dim, in_channels, distribution,
                               self.floor, img_size, compute_dtype,
                               l2_normalize)
        self.decoder = Decoder(
            2 * latent_dim if distribution == "clifford" else latent_dim,
            in_channels, img_size, compute_dtype)
        if use_learnable_beta:
            self.log_sigma_0 = nn.Parameter(torch.zeros(1))
            self.log_sigma_1 = nn.Parameter(torch.zeros(1))
        reset_parameters(self, seed)

    def encode(self, x):
        """Image (B, H, W, C) -> the heads: (mu (B, d), kappa (B, 1)) or,
        gaussian, (mu, log_var (B, d))."""
        return self.encoder(x)

    encode_heads = encode

    def decode(self, z):
        return self.decoder(z)

    def reparam(self, mu, params, key, sampler=None):
        """(z, q_z, p_z): the latent z drawn with the sampling ``key`` (two
        uint32 words), the posterior and the prior.  Clifford: the torus
        point (B, 2d), kappa (B, 1) broadcast over the d circles without a
        copy; otherwise z (B, d)."""
        if self.distribution == "clifford":
            params = params.expand(mu.shape)
        q_z, p_z = reparameterize(self.distribution, mu, params,
                                  self.latent_dim)
        return (sample_latent(key, self.distribution, q_z, self.l2_normalize,
                              sampler or self.sampler), q_z, p_z)

    def forward(self, x, key):
        """Image (B, H, W, C) and the sampling ``key`` ->
        (x_recon, q_z, p_z, mu)."""
        mu, params = self.encoder(x)
        z, q_z, p_z = self.reparam(mu, params, key)
        return self.decoder(z), q_z, p_z, mu

    def get_flat_latent(self, x, key, sampler=None):
        """(B, 2d) or (B, d) sampled latents."""
        mu, params = self.encoder(x)
        return self.reparam(mu, params, key, sampler)[0]

    def loss_sigmas(self):
        """(sigma_0, sigma_1), each (1,), of the learnable-beta loss, or
        (None, None)."""
        if self.use_learnable_beta:
            return torch.exp(self.log_sigma_0), torch.exp(self.log_sigma_1)
        return None, None


def cnn_vae_loss(x, x_recon, q_z, p_z, distribution, beta=1.0,
                 recon_loss_type="l1", l1_weight=1.0, sigmas=(None, None)):
    """l1 | mse reconstruction summed over pixels and divided by the batch
    size, plus ``beta`` times the mean KL(q_z || p_z).  With ``sigmas``
    (sigma_0, sigma_1), each of shape (1,) (a model's ``loss_sigmas()``),
    the total is the learnable-beta form recon / sigma_0^2 + KL / sigma_1^2
    + sigma_0^2 + sigma_1^2 and ``beta`` is not used.  Returns a dict of
    scalar tensors: total_loss, recon_loss, kld_loss, entropy,
    effective_beta, and sigma_0, sigma_1 when they are given.  The
    gaussian KL is summed over the latent dims before the mean."""
    B = x.shape[0]
    kl = kl_divergence(q_z, p_z)
    kld = kl.sum(-1).mean() if distribution == "gaussian" else kl.mean()
    if recon_loss_type == "mse":
        recon_loss = ((x_recon - x) ** 2).sum() / B
    elif recon_loss_type == "l1":
        recon_loss = l1_weight * (x_recon - x).abs().sum() / B
    else:
        raise ValueError(recon_loss_type)
    sigma_0, sigma_1 = sigmas
    if sigma_0 is not None:
        total = (recon_loss / sigma_0[0] ** 2 + kld / sigma_1[0] ** 2
                 + sigma_0[0] ** 2 + sigma_1[0] ** 2)
        effective_beta = (sigma_0[0] / sigma_1[0]) ** 2
    else:
        total = recon_loss + beta * kld
        effective_beta = torch.as_tensor(beta, dtype=torch.float32,
                                         device=x.device)
    with torch.no_grad():  # reported only; the KL term carries the gradient
        entropy = q_z.entropy().mean()
    out = {
        "total_loss": total,
        "recon_loss": recon_loss,
        "kld_loss": kld,
        "entropy": entropy,
        "effective_beta": effective_beta,
    }
    if sigma_0 is not None:
        out["sigma_0"] = sigma_0[0]
        out["sigma_1"] = sigma_1[0]
    return out
