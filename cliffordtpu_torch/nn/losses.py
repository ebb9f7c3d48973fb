"""VAE losses and test metrics (port of ``cliffordtpu/nn/losses.py``).

The model holds its parameters, so where a JAX function takes
(model, params) these take the model alone.  The bounds and the metrics
compute values only, without gradients.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.distributions.kl import kl_divergence
from cliffordtpu_torch.distributions.reparam import reparameterize


def bce_with_logits(logits, targets):
    """Elementwise binary cross-entropy on logits (stable form)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def vae_loss_from_outputs(x, outputs, beta=1.0, lane_axes: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """ELBO pieces of an ``MLPVAE`` forward pass: recon = BCE-with-logits
    summed / B; kl = the mean of the whole KL tensor (for normal the
    per-dim mean, the reference's quirk); total = recon + beta kl; elbo =
    -recon - kl; entropy = mean H[q_z], reported only.  Each piece reduces
    over every axis after the ``lane_axes`` leading ones: scalars for one
    model, (T,) for the T lanes of a ``LaneMLPVAE`` (x (T, B, ...))."""
    _, (q_z, p_z), _, x_recon = outputs
    x_flat = x.reshape(*x.shape[:lane_axes + 1], -1)
    recon = (bce_with_logits(x_recon, x_flat).flatten(lane_axes).sum(-1)
             / x_flat.shape[lane_axes])
    kl = kl_divergence(q_z, p_z).flatten(lane_axes).mean(-1)
    with torch.no_grad():
        entropy = q_z.entropy().flatten(lane_axes).mean(-1)
    return {"total": recon + beta * kl, "recon": recon, "kl": kl,
            "entropy": entropy, "elbo": -recon - kl}


def _iwae_mean(log_w: torch.Tensor) -> torch.Tensor:
    """log (1/n) sum_i w_i per row, averaged over the batch; log_w (n, B)."""
    return (torch.logsumexp(log_w, 0) - math.log(log_w.shape[0])).mean()


@torch.no_grad()
def iwae_log_likelihood(key, model, x, n_samples: int = 10) -> torch.Tensor:
    """Importance-weighted log-likelihood bound of an ``MLPVAE``: n draws of
    q_z on ``key`` (``q_z.sample(key, (n,))``), BCE decoder likelihood."""
    x_flat = x.reshape(x.shape[0], -1)
    z_mean, z_param2 = model.encode(x_flat)
    q_z, p_z = reparameterize(model.distribution, z_mean, z_param2,
                              model.z_dim)
    z = q_z.sample(key, (n_samples,))
    log_p_z, log_q = p_z.log_prob(z), q_z.log_prob(z)
    if model.distribution == "normal":
        log_p_z, log_q = log_p_z.sum(-1), log_q.sum(-1)
    log_p_x_z = -bce_with_logits(model.decode(z), x_flat[None]).sum(-1)
    return _iwae_mean(log_p_x_z + log_p_z - log_q)


@torch.no_grad()
def iwae_log_likelihood_cnn(key, model, x, n_samples: int = 10,
                            recon_loss_type=None) -> torch.Tensor:
    """Importance-weighted bound for ``CNNVAE`` and ``CliffordARVAE``: the
    decoder likelihood matches the training reconstruction loss (l1 -> unit
    Laplace, mse -> unit Gaussian, summed over pixels); per-token models sum
    their log-densities over the tokens.  The powerspherical sqrt(d) scale
    of the per-token model and the gaussian l2 projection are folded into
    the decoder, so the weights use q and p of the raw draw.  The samples
    are decoded one at a time, as ``jax.lax.map`` does."""
    dist = model.distribution
    recon = recon_loss_type or getattr(model, "recon_loss_type", "l1")
    mu, head = model.encode_heads(x)
    if dist == "clifford":
        if head.dim() == mu.dim() - 1:
            head = head[..., None]  # per-token scalar kappa
        head = torch.broadcast_to(head, mu.shape)
    q_z, p_z = reparameterize(dist, mu, head, model.latent_dim)
    z = q_z.sample(key, (n_samples,))
    log_q, log_p = q_z.log_prob(z), p_z.log_prob(z)
    if dist in ("normal", "gaussian"):
        log_q, log_p = log_q.sum(-1), log_p.sum(-1)
    log_p = torch.broadcast_to(log_p, log_q.shape)
    while log_q.dim() > 2:  # per-token models: sum over the token axis
        log_q, log_p = log_q.sum(-1), log_p.sum(-1)
    if dist in ("normal", "gaussian") and getattr(model, "l2_normalize",
                                                  False):
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    if dist == "powerspherical" and hasattr(model, "num_tokens"):
        z = z * (model.latent_dim ** 0.5)
    diff = torch.stack([model.decode(z_i) for z_i in z]) - x[None]
    axes = tuple(range(2, diff.dim()))
    n_pix = math.prod(x.shape[1:])
    if recon == "l1":
        log_p_x_z = -diff.abs().sum(axes) - math.log(2.0) * n_pix
    else:
        log_p_x_z = (-0.5 * (diff ** 2).sum(axes)
                     - 0.5 * math.log(2.0 * math.pi) * n_pix)
    return _iwae_mean(log_p_x_z + log_p - log_q)


@torch.no_grad()
def compute_test_metrics(key, model, batches, n_iwae_samples: int = 10
                         ) -> Dict[str, float]:
    """Dataset means of ll (the IWAE bound), entropy, recon (the negated
    BCE) and kl of an ``MLPVAE`` over ``batches``, an iterable of (x, y)
    arrays or tensors.  Batch i takes ``split(fold_in(key, i))`` = (k1,
    k2): the forward pass's sampling key from k1 (as ``model.apply(...,
    rngs={"sample": k1})`` derives it), the IWAE draws on k2."""
    device = next(model.parameters()).device
    totals = {"ll": 0.0, "entropy": 0.0, "recon": 0.0, "kl": 0.0}
    n_total = 0
    for i, (x, _) in enumerate(batches):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        k1, k2 = random.split_words(random.fold_in_words(key, i))
        res = vae_loss_from_outputs(x, model(x, random.sample_key(k1)), 1.0)
        B = x.shape[0]
        totals["recon"] += float(-res["recon"]) * B
        totals["kl"] += float(res["kl"]) * B
        totals["entropy"] += float(res["entropy"]) * B
        totals["ll"] += float(iwae_log_likelihood(
            k2, model, x, n_iwae_samples)) * B
        n_total += B
    return {k: v / n_total for k, v in totals.items()}
