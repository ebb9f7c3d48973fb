"""CNN-only per-token VAE (port of ``cliffordtpu/nn/hybrid_vae.py``).

Each spatial token after the down-stack gets its own latent: 1x1
convolution heads give per-token (mu, kappa) or (mu, log_var), and the
decoder projects every token back and upsamples.  The public functions
take JAX's layouts, images (B, H, W, C) and latents (B, T, k) or flat
(B, T*k); the stacks run in PyTorch's NCHW, and the tokens are read and
written in JAX's NHWC order t = h * W + w.

The down blocks are ``vit_vae.ResDownBlock``.  The up block differs from
``vit_vae.ResUpBlock``: its second residual has one GroupNorm + SiLU + 3x3
convolution where the ViT block has two.

The heads, as the JAX encoder computes them: gaussian (mean and a
``fc_logvar`` log-variance, (B, T, d) each); powerspherical (a unit mean
and kappa = clip(softplus(.) + 0.8, <= 10), (B, T)); clifford (mean angles
and kappa = clip(softplus(.) + ``concentration_floor``, <= 10), (B, T)).
The JAX encoder sends any other name down the clifford branch; of those
only "vmf" then runs in JAX (a von Mises-Fisher posterior on the raw means
with the floored kappa, decoded d-wide), so the port takes "vmf" and
refuses every other name.  A clifford draw broadcasts kappa (B, T) over
the d circles without a copy; the keyed sampler reads it in place at its
strides, and autograd sums d kappa back to (B, T).
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
from cliffordtpu_torch.nn.layers import Conv, ConvT, Linear, reset_parameters
from cliffordtpu_torch.nn.mlp_vae import l2_normalize
from cliffordtpu_torch.nn.vit_vae import GroupNorm, ResDownBlock

HEADS = ("clifford", "gaussian", "powerspherical", "vmf")


class HybridResUpBlock(nn.Module):
    """GN, SiLU, 4x4 s2 transposed convolution, GN, SiLU, 3x3 convolution,
    plus a 2x2 s2 transposed shortcut; then one GN + SiLU + 3x3 residual.
    NCHW."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = ConvT(in_ch, out_ch, 4, 1, torch.float32)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, 1)
        self.shortcut = ConvT(in_ch, out_ch, 2, 0, torch.float32)
        self.norm3 = GroupNorm(out_ch)
        self.conv3 = Conv(out_ch, out_ch, 3, 1, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        x = self.shortcut(x) + h
        return x + self.conv3(F.silu(self.norm3(x)))


class HybridEncoder(nn.Module):
    """Image (B, H, W, C) -> per-token heads (see the module docstring)."""

    def __init__(self, latent_dim: int, in_channels: int, distribution: str,
                 cnn_chs: Sequence[int], concentration_floor: float = 0.03):
        super().__init__()
        chs = list(cnn_chs)
        self.distribution = distribution
        self.concentration_floor = concentration_floor
        self.input_conv = Conv(in_channels, chs[0], 3, 1, 1)
        self.down = nn.ModuleList(ResDownBlock(a, b)
                                  for a, b in zip(chs, chs[1:]))
        self.fc_mu = Conv(chs[-1], latent_dim, 1, bias=True)
        if distribution == "gaussian":
            self.fc_logvar = Conv(chs[-1], latent_dim, 1, bias=True)
        else:
            self.fc_kappa = Conv(chs[-1], 1, 1, bias=True)

    @staticmethod
    def _tokens(x):
        """(B, C, H, W) -> (B, H*W, C) in NHWC token order."""
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])

    def forward(self, x):
        x = self.input_conv(x.permute(0, 3, 1, 2))
        for block in self.down:
            x = block(x)
        mu = self._tokens(self.fc_mu(x))
        if self.distribution == "gaussian":
            return mu, self._tokens(self.fc_logvar(x))
        kappa = self._tokens(self.fc_kappa(x))[..., 0]
        if self.distribution == "powerspherical":
            return l2_normalize(mu), torch.clamp(F.softplus(kappa) + 0.8,
                                                 max=10.0)
        return mu, torch.clamp(F.softplus(kappa) + self.concentration_floor,
                               max=10.0)


class HybridDecoder(nn.Module):
    """Latents (B, T, k) -> image (B, H, W, C) in (-1, 1)."""

    def __init__(self, dec_latent_dim: int, out_channels: int,
                 cnn_chs: Sequence[int], spatial_size: int):
        super().__init__()
        chs = list(cnn_chs)
        self.spatial_size = spatial_size
        self.input_proj = Linear(dec_latent_dim, chs[0], torch.float32)
        self.up = nn.ModuleList(HybridResUpBlock(a, b)
                                for a, b in zip(chs, chs[1:]))
        self.norm_out = GroupNorm(chs[-1])
        self.output_conv = Conv(chs[-1], out_channels, 3, 1, 1, bias=True)

    def forward(self, z):
        s = self.spatial_size
        x = self.input_proj(z)  # (B, T, C0), tokens in NHWC order
        x = x.reshape(z.shape[0], s, s, -1).permute(0, 3, 1, 2)
        for block in self.up:
            x = block(x)
        x = self.output_conv(F.silu(self.norm_out(x)))
        return torch.tanh(x).permute(0, 2, 3, 1)


class HybridVAE(nn.Module):
    """Per-token CNN VAE (``HEADS``): ``forward`` (the training path),
    ``encode_heads``, ``reparam``, ``decode``, ``get_flat_latent``,
    ``loss_sigmas``; ``token_spatial_size`` and ``num_tokens``.

    Channels default to [64, 128, 256] ([64, 128, 256, 512] at
    ``img_size`` 64), the decoder's to the encoder's reversed.  ``sampler``
    is the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``, default "keyed"); the
    other latents have one route and refuse a ``sampler``.  ``seed`` makes
    the random initialisation reproducible; weights carried from JAX
    replace it (``nn/param_import.py::hybridvae_from_jax``).  Float32."""

    def __init__(self, latent_dim: int = 16, in_channels: int = 3,
                 distribution: str = "clifford", recon_loss_type: str = "l1",
                 l1_weight: float = 1.0,
                 encoder_chs: Optional[Sequence[int]] = None,
                 decoder_chs: Optional[Sequence[int]] = None,
                 use_learnable_beta: bool = False, l2_normalize: bool = False,
                 concentration_floor: float = 0.03, img_size: int = 32,
                 sampler: Optional[str] = None, seed: int = 0):
        super().__init__()
        if distribution not in HEADS:
            raise ValueError(f"distribution must be one of {HEADS}, got "
                             f"{distribution!r}")
        enc = list(encoder_chs) if encoder_chs else (
            [64, 128, 256, 512] if img_size == 64 else [64, 128, 256])
        dec = list(decoder_chs) if decoder_chs else enc[::-1]
        self.latent_dim = latent_dim
        self.in_channels = in_channels
        self.distribution = distribution
        self.recon_loss_type = recon_loss_type
        self.l1_weight = l1_weight
        self.use_learnable_beta = use_learnable_beta
        self.l2_normalize = l2_normalize
        self.concentration_floor = concentration_floor
        self.img_size = img_size
        self.sampler = sampler
        self.token_spatial_size = img_size // (2 ** (len(enc) - 1))
        self.num_tokens = self.token_spatial_size ** 2
        self.dec_latent_dim = (2 * latent_dim if distribution == "clifford"
                               else latent_dim)
        self.encoder = HybridEncoder(latent_dim, in_channels, distribution,
                                     enc, concentration_floor)
        self.decoder = HybridDecoder(self.dec_latent_dim, in_channels, dec,
                                     self.token_spatial_size)
        if use_learnable_beta:
            self.log_sigma_0 = nn.Parameter(torch.zeros(1))
            self.log_sigma_1 = nn.Parameter(torch.zeros(1))
        reset_parameters(self, seed)

    def encode_heads(self, x):
        """Image (B, H, W, C) -> per-token heads: (mu (B, T, d), kappa
        (B, T)) or, gaussian, (mu, log_var (B, T, d))."""
        return self.encoder(x)

    def decode(self, z):
        """(B, T, k) or flat (B, T*k) latents -> image (B, H, W, C), k =
        ``dec_latent_dim`` (2d for clifford, d otherwise)."""
        if z.dim() == 2:
            z = z.reshape(z.shape[0], self.num_tokens, self.dec_latent_dim)
        return self.decoder(z)

    def reparam(self, mu, params, key, sampler=None, rows=None):
        """(z, q_z, p_z): per-token latents drawn with the sampling ``key``
        (two uint32 words), the posterior and the prior.  Clifford: torus
        points (B, T, 2d) with kappa (B, T) broadcast over the d circles;
        otherwise (B, T, d).  ``rows``: as ``CNNVAE.reparam``."""
        if self.distribution == "clifford":
            params = params[..., None].expand(mu.shape)
        q_z, p_z = reparameterize(self.distribution, mu, params,
                                  self.latent_dim)
        z = sample_latent(key, self.distribution, q_z, self.l2_normalize,
                          sampler or self.sampler, rows)
        return z, q_z, p_z

    def forward(self, x, key, rows=None):
        """Image (B, H, W, C) and the sampling ``key`` ->
        (x_recon, q_z, p_z, mu); ``rows`` as ``reparam``."""
        mu, params = self.encoder(x)
        z, q_z, p_z = self.reparam(mu, params, key, rows=rows)
        return self.decode(z), q_z, p_z, mu

    def get_flat_latent(self, x, key, sampler=None):
        """(B, num_tokens * k) sampled latents."""
        mu, params = self.encoder(x)
        z, _, _ = self.reparam(mu, params, key, sampler)
        return z.reshape(z.shape[0], -1)

    def loss_sigmas(self):
        """(sigma_0, sigma_1), each (1,), of the learnable-beta loss, or
        (None, None)."""
        if self.use_learnable_beta:
            return torch.exp(self.log_sigma_0), torch.exp(self.log_sigma_1)
        return None, None
