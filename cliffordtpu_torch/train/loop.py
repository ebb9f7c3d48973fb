"""Train and eval steps (port of ``cliffordtpu/train/loop.py``
``make_cnn_train_step`` / ``make_cnn_eval_step``).

A step is eager PyTorch: forward, ``cnn_vae_loss``, backward through the
hand-written kernels, global-norm clip, Adam(W).  The losses stay on the
device and the step forces no host synchronisation.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from cliffordtpu_torch.nn.conv_vae import cnn_vae_loss
from cliffordtpu_torch.train.state import ClippedOptimizer


def _losses(model, x, key, beta) -> Dict[str, torch.Tensor]:
    x_recon, q_z, p_z, _ = model(x, key)
    return cnn_vae_loss(x, x_recon, q_z, p_z, model.distribution, beta=beta,
                        recon_loss_type=model.recon_loss_type,
                        l1_weight=model.l1_weight,
                        sigmas=model.loss_sigmas())


def make_cnn_train_step(model, optimizer: ClippedOptimizer) -> Callable:
    """``train_step(x, key, beta) -> losses`` for ``CNNVAE`` and
    ``CliffordARVAE`` (with the learnable-beta sigmas when the model has
    them, and then ``beta`` is not used): loss,
    backward, clip at the optimizer's ``clip_norm``, update.  ``x`` is a
    batch of images (B, H, W, C) on the model's device, ``key`` the
    sampling key (two uint32 words), ``beta`` a float or a scalar tensor on
    the device.  ``losses`` holds the five outputs of ``cnn_vae_loss`` and
    ``grad_norm``, the global gradient norm from before the clip."""

    def train_step(x, key, beta):
        optimizer.zero_grad()
        losses = _losses(model, x, key, beta)
        losses["total_loss"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = optimizer.step()
        return losses

    return train_step


def make_cnn_eval_step(model) -> Callable:
    """``eval_step(x, key, beta) -> losses`` without gradients."""

    @torch.no_grad()
    def eval_step(x, key, beta):
        return _losses(model, x, key, beta)

    return eval_step
