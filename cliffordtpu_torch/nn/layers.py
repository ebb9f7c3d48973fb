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


@torch.no_grad()
def reset_parameters(module: nn.Module, seed: int):
    """JAX's initialisers, drawn in float32 from ``seed``: xavier-uniform
    weights, unit-normal register tokens, unit norm scales, zero biases and
    zero log-sigmas."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("register_token"):
            val = torch.randn(p.shape, generator=gen)
        elif name.endswith(".bias") or "log_sigma" in name:
            val = torch.zeros(p.shape)
        elif p.dim() == 1:  # norm scales
            val = torch.ones(p.shape)
        else:
            rf = p[0, 0].numel()  # receptive field (1 for Linear)
            limit = math.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * rf))
            val = (torch.rand(p.shape, generator=gen) * 2 - 1) * limit
        p.copy_(val)
