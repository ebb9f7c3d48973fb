"""Hybrid CNN+ViT S-VAE with per-token Clifford latents: the port of
``cliffordtpu/nn/vit_vae.py`` (serving and training paths) in PyTorch.

Layouts at the public functions follow the JAX package: images
(B, H, W, C), tokens (B, S, D), attention heads (B, S, H, hd).  Convolutions
run in PyTorch's NCHW inside the modules.

``compute_dtype`` plays the role of JAX's ``dtype``.  Every parameter is
held in float32, as flax holds them, so gradients, Adam moments and weight
decay are float32; the convolutions of the CNN stacks and the transformer
projections cast their input and their weight to ``compute_dtype``
(float32 or bfloat16) where they use them.  Norms, the register tokens,
the encoder head, ``quant_proj``, ``post_quant_proj``, the decoder's first
and last convolutions and the distribution math run in float32.  The
attention core of every block is ``kernels/attention.py::fused_attention``:
the fused RoPE + attention kernels, forward and backward, where they hold
the shape, and the dense route where they cannot (S 260 at image 256 in
float32 and under autograd), as the JAX module leaves such shapes to XLA.

The per-token heads: clifford (mean angles and a concentration, the
decoder reads 2d-wide torus points), gaussian (mean and log-variance from
a 2d-wide ``quant_proj``), powerspherical (a unit mean and a
concentration; the draw is scaled by sqrt(d)) and vmf (the clifford head:
raw means and a floored concentration, one per token, into a von
Mises-Fisher posterior; the decoder reads d-wide draws).  ``CNNVAE`` has
no vmf head, in the JAX package either.

Not ported yet: ``fused_proj`` and ``scan_layers``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cliffordtpu_torch.distributions.kl import kl_divergence
from cliffordtpu_torch.kernels import attention as attention_kernel
from cliffordtpu_torch.nn.layers import Conv as _Conv
from cliffordtpu_torch.nn.layers import ConvT as _ConvT
from cliffordtpu_torch.nn.layers import Linear as _Linear
from cliffordtpu_torch.nn.layers import reset_parameters
from cliffordtpu_torch.nn.mlp_vae import l2_normalize
from cliffordtpu_torch.nn.reparam import reparameterize, sample_latent
from cliffordtpu_torch.nn.rope import apply_rotary_half, rope_2d_cos_sin

# the per-token latents of the model (``CNNVAE``'s ``HEADS`` and vmf)
HEADS = ("clifford", "gaussian", "powerspherical", "vmf")

__all__ = [
    "rope_2d_cos_sin", "apply_rotary_half", "RMSNorm", "GroupNorm",
    "SwiGLU", "Attention", "TransformerBlock", "ResDownBlock", "ResUpBlock",
    "ViTEncoder", "ViTDecoder", "default_config", "CliffordARVAE", "HEADS",
]


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(epsilon=1e-6)``: statistics in float32, returns the
    input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        ms = xf.pow(2).mean(-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + self.eps) * self.weight)).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax ``_gn``: groups = min(32, max(1, ch // 4)), eps 1e-6, statistics
    in float32, returns the input dtype."""

    def __init__(self, ch: int):
        super().__init__(min(32, max(1, ch // 4)), ch, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class SwiGLU(nn.Module):
    """w2(silu(w1 x) * w3 x), d_ff = 8/3 d rounded up to 256."""

    def __init__(self, d_model: int, dtype=torch.float32):
        super().__init__()
        d_ff = ((int(d_model * 8 / 3) + 255) // 256) * 256
        self.w1 = _Linear(d_model, d_ff, dtype)
        self.w3 = _Linear(d_model, d_ff, dtype)
        self.w2 = _Linear(d_ff, d_model, dtype)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Attention(nn.Module):
    """Non-causal multi-head attention with 2-D RoPE.  The projections are
    plain matrix products; the core is ``fused_attention``, which takes
    the kernels or the dense route by shape."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.wq = _Linear(d_model, d_model, dtype)
        self.wk = _Linear(d_model, d_model, dtype)
        self.wv = _Linear(d_model, d_model, dtype)
        self.wo = _Linear(d_model, d_model, dtype)

    def forward(self, x, cos, sin):
        B, S, D = x.shape
        heads = (B, S, self.n_heads, D // self.n_heads)
        q = self.wq(x).view(heads)
        k = self.wk(x).view(heads)
        v = self.wv(x).view(heads)
        out = attention_kernel.fused_attention(q, k, v, cos, sin)
        return self.wo(out.reshape(B, S, D))


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(norm1(x)), then + ffn(norm2(x))."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(d_model)
        self.attn = Attention(d_model, n_heads, dtype)
        self.norm2 = RMSNorm(d_model)
        self.ffn = SwiGLU(d_model, dtype)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm1(x), cos, sin).to(x.dtype)
        return x + self.ffn(self.norm2(x)).to(x.dtype)


class ResDownBlock(nn.Module):
    """GN, SiLU, 3x3 s2 conv, GN, SiLU, 3x3 conv, plus a 2x2 s2 shortcut.
    NCHW in and out."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = _Conv(in_ch, out_ch, 3, 2, 1, dtype)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = _Conv(out_ch, out_ch, 3, 1, 1, dtype)
        self.shortcut = _Conv(in_ch, out_ch, 2, 2, 0, dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return self.shortcut(x) + h


class ResUpBlock(nn.Module):
    """Decoder up-block with the extra two-conv residual.  NCHW."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = _ConvT(in_ch, out_ch, 4, 1, dtype)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = _Conv(out_ch, out_ch, 3, 1, 1, dtype)
        self.shortcut = _ConvT(in_ch, out_ch, 2, 0, dtype)
        self.norm3 = GroupNorm(out_ch)
        self.conv3 = _Conv(out_ch, out_ch, 3, 1, 1, dtype)
        self.norm4 = GroupNorm(out_ch)
        self.conv4 = _Conv(out_ch, out_ch, 3, 1, 1, dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        x = self.shortcut(x) + h
        h = self.conv3(F.silu(self.norm3(x)))
        h = self.conv4(F.silu(self.norm4(h)))
        return x + h


class _RopeStack(nn.Module):
    """Register tokens + the RoPE tables + the transformer layers, shared
    by the encoder and the decoder."""

    def __init__(self, n_layers, n_heads, d_model, image_size, patch_size,
                 register_tokens, dtype):
        super().__init__()
        self.register_tokens = register_tokens
        self.register_token = nn.Parameter(
            torch.zeros(register_tokens, d_model))
        cos, sin = rope_2d_cos_sin(image_size, image_size // patch_size,
                                   d_model // n_heads,
                                   cls_token_num=register_tokens)
        self.register_buffer("rope_cos", torch.from_numpy(cos),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin),
                             persistent=False)
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, n_heads, dtype) for _ in range(n_layers))

    def run_blocks(self, x):
        """(B, T, D) tokens -> (B, T, D), registers prepended then dropped."""
        reg = self.register_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([reg, x], dim=1)
        for layer in self.layers:
            x = layer(x, self.rope_cos, self.rope_sin)
        return x[:, self.register_tokens:]


class ViTEncoder(_RopeStack):
    """Conv patchify -> ViT blocks -> RMSNorm + Dense (float32).
    Image (B, H, W, C) -> tokens (B, T, d_model)."""

    def __init__(self, n_layers: int, n_heads: int, d_model: int,
                 cnn_chs: Sequence[int], image_size: int, patch_size: int,
                 in_channels: int, register_tokens: int = 4,
                 dtype=torch.float32):
        super().__init__(n_layers, n_heads, d_model, image_size, patch_size,
                         register_tokens, dtype)
        self.conv_in = _Conv(in_channels, cnn_chs[0], 3, 1, 1, dtype)
        self.down = nn.ModuleList(
            ResDownBlock(a, b, dtype) for a, b in zip(cnn_chs, cnn_chs[1:]))
        self.norm = RMSNorm(d_model)
        self.output = _Linear(d_model, d_model, torch.float32)

    def forward(self, image):
        x = self.conv_in(image.permute(0, 3, 1, 2))
        for block in self.down:
            x = block(x)
        x = x.flatten(2).transpose(1, 2)  # (B, H*W, C), row-major tokens
        x = self.run_blocks(x)
        return self.output(self.norm(x.float()))


class ViTDecoder(_RopeStack):
    """Conv in -> ViT blocks -> conv unpatchify.  Tokens (B, T, d_model)
    -> image (B, H, W, out_channels)."""

    def __init__(self, n_layers: int, n_heads: int, d_model: int,
                 cnn_chs: Sequence[int], out_channels: int, image_size: int,
                 patch_size: int, register_tokens: int = 4,
                 dtype=torch.float32):
        super().__init__(n_layers, n_heads, d_model, image_size, patch_size,
                         register_tokens, dtype)
        self.compute_dtype = dtype
        self.conv_in = _Conv(d_model, d_model, 3, 1, 1, torch.float32)
        self.up = nn.ModuleList(
            ResUpBlock(a, b, dtype) for a, b in zip(cnn_chs, cnn_chs[1:]))
        self.norm_out = GroupNorm(cnn_chs[-1])
        self.conv_out = _Conv(cnn_chs[-1], out_channels, 3, 1, 1,
                              torch.float32)

    def forward(self, x):
        B, T, C = x.shape
        g = math.isqrt(T)
        h = self.conv_in(x.float().transpose(1, 2).reshape(B, C, g, g))
        x = h.flatten(2).transpose(1, 2).to(self.compute_dtype)
        x = self.run_blocks(x)
        x = x.transpose(1, 2).reshape(B, -1, g, g)
        for block in self.up:
            x = block(x)
        x = self.conv_out(F.silu(self.norm_out(x.float())))
        return x.permute(0, 2, 3, 1)


def default_config(image_size: int) -> dict:
    """Per-image-size defaults (``cliffordtpu/nn/vit_vae.py:462``)."""
    if image_size == 256:
        return dict(cnn_chs=[64, 64, 128, 256, 512], z_channels=512,
                    encoder_vit_layers=6, decoder_vit_layers=12,
                    patch_size=16)
    if image_size == 64:
        return dict(cnn_chs=[64, 128, 256, 512], z_channels=512,
                    encoder_vit_layers=4, decoder_vit_layers=8, patch_size=8)
    if image_size == 32:
        return dict(cnn_chs=[64, 256, 512], z_channels=512,
                    encoder_vit_layers=4, decoder_vit_layers=8, patch_size=4)
    num_stages = max(1, int(math.log2(image_size)) - 3)
    chs, c = [64], 64
    for _ in range(num_stages):
        c = min(c * 2, 512)
        chs.append(c)
    return dict(cnn_chs=chs, z_channels=chs[-1], encoder_vit_layers=4,
                decoder_vit_layers=8,
                patch_size=image_size // (2 ** num_stages))


class CliffordARVAE(nn.Module):
    """Hybrid CNN+ViT S-VAE with per-token latents (``HEADS``): ``forward``
    (the training path), ``encode``, ``encode_heads``, ``reparam``,
    ``decode``, ``get_flat_latent``, ``loss_sigmas``.

    ``sampler`` is the route of a clifford draw
    (``distributions/clifford_torus.py::SAMPLERS``, default "keyed"); the
    other latents have one route and refuse a ``sampler``.  With
    ``l2_normalize`` a gaussian draw is normalised.  ``seed`` makes the
    random initialisation (xavier-uniform weights, unit-normal register
    tokens, zero biases) reproducible; weights carried from JAX replace it
    (``nn/param_import.py``)."""

    def __init__(self, latent_dim: int = 16, image_size: int = 256,
                 in_channels: int = 3, distribution: str = "clifford",
                 recon_loss_type: str = "l1", l1_weight: float = 1.0,
                 use_learnable_beta: bool = False,
                 cnn_chs: Optional[Sequence[int]] = None,
                 z_channels: Optional[int] = None,
                 encoder_vit_layers: Optional[int] = None,
                 decoder_vit_layers: Optional[int] = None,
                 patch_size: Optional[int] = None, register_tokens: int = 4,
                 concentration_floor: float = 0.03,
                 sampler: Optional[str] = None, l2_normalize: bool = False,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if distribution not in HEADS:
            raise ValueError(f"distribution must be one of {HEADS}, got "
                             f"{distribution!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        cfg = default_config(image_size)
        cnn_chs = list(cnn_chs or cfg["cnn_chs"])
        zc = z_channels or cfg["z_channels"]
        patch_size = patch_size or cfg["patch_size"]
        n_heads = max(1, zc // 64)
        self.latent_dim = latent_dim
        self.image_size = image_size
        self.in_channels = in_channels
        self.distribution = distribution
        self.recon_loss_type = recon_loss_type
        self.l1_weight = l1_weight
        self.use_learnable_beta = use_learnable_beta
        self.concentration_floor = concentration_floor
        self.sampler = sampler
        self.l2_normalize = l2_normalize
        self.compute_dtype = compute_dtype
        grid = image_size // (2 ** (len(cnn_chs) - 1))
        self.num_tokens = grid * grid
        self.encoder_vit = ViTEncoder(
            encoder_vit_layers or cfg["encoder_vit_layers"], n_heads, zc,
            cnn_chs, image_size, patch_size, in_channels, register_tokens,
            compute_dtype)
        self.quant_proj = _Linear(
            zc, 2 * latent_dim if distribution == "gaussian"
            else latent_dim + 1, torch.float32, bias=True)
        self.dec_latent_dim = (2 * latent_dim if distribution == "clifford"
                               else latent_dim)
        self.post_quant_proj = _Linear(self.dec_latent_dim, zc,
                                       torch.float32)
        self.decoder_vit = ViTDecoder(
            decoder_vit_layers or cfg["decoder_vit_layers"], n_heads, zc,
            cnn_chs[::-1], in_channels, image_size, patch_size,
            register_tokens, compute_dtype)
        if use_learnable_beta:
            self.log_sigma_0 = nn.Parameter(torch.zeros(1))
            self.log_sigma_1 = nn.Parameter(torch.zeros(1))
        reset_parameters(self, seed)

    def encode_heads(self, x):
        """Image (B, H, W, C) -> per-token heads: clifford (mu (B, T, d),
        kappa (B, T) = clip(softplus(.) + floor, <= 10)); gaussian (mu,
        log_var (B, T, d)); powerspherical (unit mu, kappa =
        clip(softplus(.) + 0.8, <= 10)); vmf as clifford."""
        proj = self.quant_proj(self.encoder_vit(x))
        if self.distribution == "gaussian":
            return proj[..., :self.latent_dim], proj[..., self.latent_dim:]
        mu, kappa = proj[..., :-1], proj[..., -1]
        if self.distribution == "powerspherical":
            return l2_normalize(mu), torch.clamp(F.softplus(kappa) + 0.8,
                                                 max=10.0)
        kappa = torch.clamp(F.softplus(kappa) + self.concentration_floor,
                            max=10.0)
        return mu, kappa

    def reparam(self, mu, params, key, sampler=None):
        """(z, q_z, p_z): per-token latents drawn with the sampling ``key``
        (two uint32 words), the posterior and the prior.  Clifford: torus
        points (B, T, 2d); powerspherical: (B, T, d) scaled by sqrt(d);
        gaussian and vmf: (B, T, d), the vmf concentration (B, T) not
        broadcast."""
        if self.distribution == "clifford":
            params = params[..., None].expand(mu.shape)
        q_z, p_z = reparameterize(self.distribution, mu, params,
                                  self.latent_dim)
        z = sample_latent(key, self.distribution, q_z, self.l2_normalize,
                          sampler or self.sampler)
        if self.distribution == "powerspherical":
            z = z * (self.latent_dim ** 0.5)
        return z, q_z, p_z

    def decode(self, z):
        """(B, T, k) or flat (B, T*k) latents -> image (B, H, W, C), k =
        ``dec_latent_dim`` (2d for clifford, d otherwise)."""
        if z.dim() == 2:
            z = z.reshape(z.shape[0], self.num_tokens, self.dec_latent_dim)
        return self.decoder_vit(self.post_quant_proj(z))

    def forward(self, x, key):
        """Image (B, H, W, C) and the sampling ``key`` ->
        (x_recon, q_z, p_z, mu)."""
        mu, params = self.encode_heads(x)
        z, q_z, p_z = self.reparam(mu, params, key)
        return self.decode(z), q_z, p_z, mu

    def encode(self, x, key):
        """(z, kl_loss): sampled latents and the mean KL(q_z || p_z), the
        gaussian one summed over the latent dims first."""
        mu, params = self.encode_heads(x)
        z, q_z, p_z = self.reparam(mu, params, key)
        kl = kl_divergence(q_z, p_z)
        return z, (kl.sum(-1) if self.distribution == "gaussian"
                   else kl).mean()

    def get_flat_latent(self, x, key, sampler=None):
        """(B, num_tokens * k) sampled latents."""
        mu, params = self.encode_heads(x)
        z, _, _ = self.reparam(mu, params, key, sampler)
        return z.reshape(z.shape[0], -1)

    def loss_sigmas(self):
        """(sigma_0, sigma_1), each (1,), of the learnable-beta loss, or
        (None, None)."""
        if self.use_learnable_beta:
            return torch.exp(self.log_sigma_0), torch.exp(self.log_sigma_1)
        return None, None

    def normalize(self, x):
        """L2 normalise * sqrt(d)."""
        return l2_normalize(x) * (self.latent_dim ** 0.5)
