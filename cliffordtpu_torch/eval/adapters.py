"""Model access for the evaluation battery (port of
``cliffordtpu/eval/adapters.py``).

``ModelHandle`` wraps one of the port's models on its device.  Its keys
are those of the JAX handle: ``flat_z(x, key)`` takes the rng that the
JAX handle passes to ``model.apply`` and draws with the sampling key that
flax's ``make_rng("sample")`` derives from it (``random.sample_key``), so
one key gives the JAX latents.  Inputs may be numpy arrays or tensors;
outputs are tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from cliffordtpu_torch import random


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ModelHandle:
    model: nn.Module

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def distribution(self) -> str:
        return getattr(self.model, "distribution", "normal")

    @property
    def latent_dim(self) -> int:
        return getattr(self.model, "latent_dim",
                       getattr(self.model, "z_dim", 0))

    @property
    def num_tokens(self) -> Optional[int]:
        return getattr(self.model, "num_tokens", None)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def flat_z(self, x, key) -> torch.Tensor:
        """Sampled latents, flat per example (B, T*k)."""
        z = self.model.get_flat_latent(self._input(x),
                                       random.sample_key(key))
        return z.reshape(z.shape[0], -1)

    @torch.inference_mode()
    def latent_mu(self, x, key=None) -> torch.Tensor:
        """Posterior means, flat per example: ``encode_heads(x)[0]`` for
        the per-image and per-token models (flattened over the tokens),
        ``encode(x)[0]`` on flattened rows for ``MLPVAE``.  ``key`` is
        not used, as in the JAX handle."""
        x = self._input(x)
        if hasattr(self.model, "encode_heads"):
            mu, _ = self.model.encode_heads(x)
        else:
            mu, _ = self.model.encode(x.reshape(x.shape[0], -1))
        return mu.reshape(mu.shape[0], -1)

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        """The decoder on flat (per-token) latents."""
        return self.model.decode(self._input(z))

    def to_image(self, x_recon: torch.Tensor) -> torch.Tensor:
        """Decoder output -> [0, 1] by the model family's activation:
        sigmoid for ``MLPVAE``'s logits, (x + 1) / 2 clipped for the tanh
        CNN decoders."""
        if type(self.model).__name__ == "MLPVAE":
            return torch.sigmoid(x_recon)
        return torch.clamp(x_recon * 0.5 + 0.5, 0, 1)

    def decode_images(self, z, img_shape) -> np.ndarray:
        """decode(z) as (N, *img_shape) images in [0, 1], numpy."""
        return to_numpy(self.to_image(self.decode(z))).reshape(-1, *img_shape)

    def collect_flat_z(self, x, y, key, limit: int = 200, batch: int = 100):
        """Up to ``limit`` examples as flat sampled latents, batch s (at
        offset s) drawn with ``fold_in(key, s)``; returns (latents on the
        device, labels as numpy)."""
        zs, ys, n = [], [], 0
        for s in range(0, min(len(x), limit * 2), batch):
            xb = x[s:s + batch]
            zs.append(self.flat_z(xb, random.fold_in_words(key, s)))
            ys.append(np.asarray(y[s:s + batch]))
            n += xb.shape[0]
            if n >= limit:
                break
        return torch.cat(zs, 0)[:limit], np.concatenate(ys, 0)[:limit]
