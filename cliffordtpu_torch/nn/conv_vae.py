"""The VAE loss shared by the convolutional and ViT families, and the
clifford concentration-floor schedule (port of ``cnn_vae_loss`` and
``clifford_concentration_floor`` in ``cliffordtpu/nn/conv_vae.py``).

The CNN encoder / decoder modules and the learnable-beta (sigma) form of
the loss are not ported yet.
"""

from __future__ import annotations

import torch

from cliffordtpu_torch.distributions.kl import kl_divergence


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


def cnn_vae_loss(x, x_recon, q_z, p_z, distribution, beta=1.0,
                 recon_loss_type="l1", l1_weight=1.0, sigmas=(None, None)):
    """l1 | mse reconstruction summed over pixels and divided by the batch
    size, plus ``beta`` times the mean KL(q_z || p_z).  Returns a dict of
    scalar tensors: total_loss, recon_loss, kld_loss, entropy,
    effective_beta."""
    if distribution != "clifford":
        raise NotImplementedError(
            f"only the clifford latent is ported, not {distribution!r}")
    if sigmas[0] is not None or sigmas[1] is not None:
        raise NotImplementedError("the learnable-beta loss is not ported")
    B = x.shape[0]
    kld = kl_divergence(q_z, p_z).mean()
    if recon_loss_type == "mse":
        recon_loss = ((x_recon - x) ** 2).sum() / B
    elif recon_loss_type == "l1":
        recon_loss = l1_weight * (x_recon - x).abs().sum() / B
    else:
        raise ValueError(recon_loss_type)
    total = recon_loss + beta * kld
    with torch.no_grad():  # reported only; the KL term carries the gradient
        entropy = q_z.entropy().mean()
    return {
        "total_loss": total,
        "recon_loss": recon_loss,
        "kld_loss": kld,
        "entropy": entropy,
        "effective_beta": torch.as_tensor(beta, dtype=torch.float32,
                                          device=x.device),
    }
