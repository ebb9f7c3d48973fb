"""Data helpers of ``cliffordtpu/data/loaders.py`` that the train loop
needs; the dataset loaders themselves are not ported yet."""

from __future__ import annotations

import torch

from cliffordtpu_torch import random


def binarize_with_random_threshold(key, x: torch.Tensor) -> torch.Tensor:
    """Dynamic binarisation, keyed: ``x > uniform(key, x.shape)`` in x's
    dtype, the threshold words those of ``jax.random.uniform``."""
    return (x > random.uniform(key, x.shape, device=x.device)).to(x.dtype)


def binarize_lanes(keys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``binarize_with_random_threshold`` for T lanes at once: ``keys``
    int64 (T, 2) on x's device, ``x`` (T, ...), lane t thresholded by the
    draw of its own key."""
    return (x > random.lane_uniform(keys, x.shape[1:])).to(x.dtype)
