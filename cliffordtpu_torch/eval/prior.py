"""Prior sampling per latent family (port of
``cliffordtpu/eval/prior.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.ops.torus import angles_to_torus


def sample_prior_z(key, dist_name: str, latent_dim: int, n: int,
                   l2_normalize: bool = False,
                   num_tokens: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """n latents from the prior: uniform angles embedded on the torus
    (n, 2d) for clifford, unit normals for powerspherical (or with
    ``l2_normalize``), normals otherwise.  With ``num_tokens`` T, n * T
    draws flattened to (n, T * k), as a per-token decoder reads them.
    ``device`` defaults to the card (``resolve_device``)."""
    device = resolve_device(device)
    if num_tokens is not None:
        flat = sample_prior_z(key, dist_name, latent_dim, n * num_tokens,
                              l2_normalize=l2_normalize, device=device)
        return flat.reshape(n, -1)
    if dist_name == "clifford":
        angles = random.uniform(key, (n, latent_dim), device=device) \
            * (2 * math.pi)
        return angles_to_torus(angles)
    z = random.normal(key, (n, latent_dim), device=device)
    if dist_name == "powerspherical" or l2_normalize:
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1,
                                                     keepdim=True), min=1e-8)
    return z
