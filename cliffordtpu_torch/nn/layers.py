"""Layers with float32 parameters that compute in another dtype.

Every parameter is held in float32, as flax holds them, so gradients, Adam
moments and weight decay are float32; a layer casts its input and its
parameters to ``compute_dtype`` (float32 or bfloat16) where it uses them,
which is what flax's ``dtype=`` argument does.  Convolutions are NCHW.
``reset_parameters`` draws the models' initialisation from a seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=...)``."""

    def __init__(self, d_in, d_out, dtype, bias=False):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)`` with symmetric padding."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0,
                 dtype=torch.float32, bias=False):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvT(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(dtype=...)`` with stride 2: 4x4 "SAME" is
    torch's padding 1, 2x2 "VALID" its padding 0, with the kernel flipped
    and permuted when it is carried across (``param_import.py``)."""

    def __init__(self, c_in, c_out, k, padding, dtype, bias=False):
        super().__init__(c_in, c_out, k, stride=2, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding)


# fused projections: how many equal slices their output axis holds; each
# is drawn with one slice's fan_out (JAX's ``_sliced_xavier``)
FUSED_SLICES = {"wqkv": 3, "w13": 2}


@torch.no_grad()
def reset_parameters(module: nn.Module, seed: int):
    """JAX's initialisers, drawn in float32 from ``seed``: xavier-uniform
    weights (a fused projection's with one slice's fan_out), unit-normal
    register tokens, unit norm scales, zero biases and zero log-sigmas.
    A parameter stacked on a leading layer axis (``vit_vae.StackedBlocks``,
    under ``.scan.``) takes each layer's fans from its trailing axes."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        shape = p.shape[1:] if ".scan." in f".{name}" else p.shape
        if name.endswith("register_token"):
            val = torch.randn(p.shape, generator=gen)
        elif name.endswith(".bias") or "log_sigma" in name:
            val = torch.zeros(p.shape)
        elif len(shape) == 1:  # norm scales
            val = torch.ones(p.shape)
        else:
            rf = math.prod(shape[2:])  # receptive field (1 for Linear)
            fan_out = shape[0] // FUSED_SLICES.get(name.split(".")[-2], 1)
            limit = math.sqrt(6.0 / ((fan_out + shape[1]) * rf))
            val = (torch.rand(p.shape, generator=gen) * 2 - 1) * limit
        p.copy_(val)
