"""2-D rotary position embeddings (port of ``cliffordtpu/nn/vit_vae.py``
``rope_2d_cos_sin`` and ``apply_rotary_half``), shared by the models and
the attention kernel's plain version; outside ``nn`` so that the kernels
import no model code.

The head basis is JAX's half-split one: pair i is (x[i], x[i + hd/2]).  The
port's q and k weights are JAX's as they are, so no permutation is needed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_2d_cos_sin(image_size: int, patch_grid: int, head_dim: int,
                    cls_token_num: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape (S, head_dim // 2), S = cls + grid**2;
    the register (cls) tokens come first and get angle 0."""
    ys, xs = np.meshgrid(np.arange(patch_grid), np.arange(patch_grid),
                         indexing="ij")
    pos = np.stack([ys.ravel(), xs.ravel()], -1).astype(np.float32)
    half = head_dim // 4
    freqs = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float32) / half))
    angles = np.concatenate(
        [np.outer(pos[:, 0], freqs), np.outer(pos[:, 1], freqs)], -1)
    if cls_token_num > 0:
        angles = np.concatenate(
            [np.zeros((cls_token_num, angles.shape[1]), np.float32), angles],
            0)
    return np.cos(angles), np.sin(angles)


def apply_rotary_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                      ) -> torch.Tensor:
    """Rotate the half pairs of x (B, S, H, hd) by the first S rows of the
    (S', hd/2) tables: ``[x0 cos - x1 sin | x0 sin + x1 cos]``."""
    S, half = x.shape[1], x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    cos = cos[:S][None, :, None, :].to(x.dtype)
    sin = sin[:S][None, :, None, :].to(x.dtype)
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
