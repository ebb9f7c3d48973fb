"""Fixed-budget Gamma sampler (port of
``cliffordtpu/distributions/gamma.py``): K = 6 Marsaglia-Tsang proposals
with a first-accept select and the alpha < 1 boost (z ~ Gamma(alpha + 1),
then z * U^(1/alpha)); the fallback after six misses is the last proposal.

The draws are the JAX package's: keys ``split(key, 3)`` for the normals,
the uniforms (minval 1e-20) and the boost's uniforms, so equal keys select
equal proposals.  The gradient in alpha is the implicit one, dz/dalpha at
a fixed quantile, -(dF/dalpha) / (dF/dz) for the regularised incomplete
gamma function F.  ``random_gamma_grad`` computes it as
``jax.lax.random_gamma_grad`` does (``jax._src.lax.special``): the power
series of F where z <= max(1, alpha), its continued fraction above, each
with the derivative in alpha carried along and iterated until that
derivative stops changing in float32.  (``torch._standard_gamma_grad``
is an approximation that strays up to 7e-4 from the exact value, against
about 1e-5 for this one.)
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from cliffordtpu_torch import random

_BUDGET = 6
_TINY = 1e-20
_EPS = float(torch.finfo(torch.float32).eps)
_LOG_MAX = math.log(float(torch.finfo(torch.float32).max))
_CF_MAX_ROUNDS = 2000  # the continued fraction's cap, as jax's
_ROUNDS_PER_CHECK = 8  # iterations between two host checks of convergence


def _series_grad(x, a, enabled):
    """d z / d alpha from the power series of F (``_igamma_series`` in
    SAMPLE_DERIVATIVE mode)."""
    r, c, ans = a, torch.ones_like(a), torch.ones_like(a)
    dc_da, dans_da = torch.zeros_like(a), torch.zeros_like(a)
    while bool(enabled.any()):
        for _ in range(_ROUNDS_PER_CHECK):
            r1 = r + 1.0
            dc_da1 = dc_da * (x / r1) - (c * x) / (r1 * r1)
            dans_da1 = dans_da + dc_da1
            c1 = c * (x / r1)
            ans1 = ans + c1
            keep = enabled
            enabled = keep & ((dc_da1 / dans_da1).abs() > _EPS)
            r = torch.where(keep, r1, r)
            c = torch.where(keep, c1, c)
            ans = torch.where(keep, ans1, ans)
            dc_da = torch.where(keep, dc_da1, dc_da)
            dans_da = torch.where(keep, dans_da1, dans_da)
    dlogax_da = torch.log(x) - torch.digamma(a + 1.0)
    return -(dans_da + ans * dlogax_da) * x / a


def _continued_fraction_grad(x, a, enabled):
    """d z / d alpha from the continued fraction of 1 - F
    (``_igammac_continued_fraction`` in SAMPLE_DERIVATIVE mode, negated),
    at most ``_CF_MAX_ROUNDS`` iterations."""
    y = 1.0 - a
    z = x + y + 1.0
    pkm2, qkm2 = torch.ones_like(x), x
    pkm1, qkm1 = x + 1.0, z * x
    ans = pkm1 / qkm1
    dpkm2, dqkm2 = torch.zeros_like(x), torch.zeros_like(x)
    dpkm1, dqkm1 = torch.zeros_like(x), -x
    dans_da = (dpkm1 - ans * dqkm1) / qkm1
    c = 0
    while c < _CF_MAX_ROUNDS and bool(enabled.any()):
        for _ in range(min(_ROUNDS_PER_CHECK, _CF_MAX_ROUNDS - c)):
            c += 1
            y1, z1 = y + 1.0, z + 2.0
            yc = y1 * c
            pk = pkm1 * z1 - pkm2 * yc
            qk = qkm1 * z1 - qkm2 * yc
            nonzero = qk != 0
            ans1 = torch.where(nonzero, pk / qk, ans)
            dpk = dpkm1 * z1 - pkm1 - dpkm2 * yc + pkm2 * c
            dqk = dqkm1 * z1 - qkm1 - dqkm2 * yc + qkm2 * c
            dans_da1 = torch.where(nonzero, (dpk - ans1 * dqk) / qk, dans_da)
            moved = torch.where(nonzero, (dans_da1 - dans_da).abs(),
                                torch.ones_like(dans_da))
            rescale = pk.abs() > 1.0 / _EPS
            scale = torch.where(rescale, _EPS, 1.0)
            keep = enabled
            enabled = keep & (moved > _EPS)
            y = torch.where(keep, y1, y)
            z = torch.where(keep, z1, z)
            ans = torch.where(keep, ans1, ans)
            dans_da = torch.where(keep, dans_da1, dans_da)
            pkm2, pkm1, qkm2, qkm1, dpkm2, dqkm2, dpkm1, dqkm1 = (
                torch.where(keep, new * scale, old) for new, old in (
                    (pkm1, pkm2), (pk, pkm1), (qkm1, qkm2), (qk, qkm1),
                    (dpkm1, dpkm2), (dqkm1, dqkm2), (dpk, dpkm1),
                    (dqk, dqkm1)))
    dlogax_da = torch.log(x) - torch.digamma(a)
    return (dans_da + ans * dlogax_da) * x


def random_gamma_grad(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d x / d a for x ~ Gamma(a, 1) at a fixed quantile
    (``jax.lax.random_gamma_grad``), float32, elementwise."""
    is_nan = a.isnan() | x.isnan()
    x_is_zero = x == 0
    domain_error = (x < 0) | (a <= 0)
    use_cf = (x > 1) & (x > a)
    log_ax = a * torch.log(x) - x - torch.lgamma(a)
    enabled = ~(x_is_zero | domain_error | (log_ax < -_LOG_MAX) | is_nan)
    out = torch.where(use_cf,
                      _continued_fraction_grad(x, a, enabled & use_cf),
                      _series_grad(x, a, enabled & ~use_cf))
    out = torch.where(x_is_zero, 0.0, out)
    return torch.where(domain_error | is_nan, math.nan, out)


def first_accept_index(accept: torch.Tensor) -> torch.Tensor:
    """The index of the first accepted proposal along axis 0, or of the
    last proposal where none was accepted."""
    return torch.where(accept.any(0), accept.to(torch.uint8).argmax(0),
                       accept.shape[0] - 1)


def _gamma_fixed(key, alpha: torch.Tensor, shape: Sequence[int],
                 rows: random.Rows = None, axis: int = 0):
    """K-proposal Marsaglia-Tsang; ``alpha`` float32 of ``shape``.
    Returns the draw and the index of the proposal it took.  With ``rows``
    (``random.counters``) ``shape`` holds rows row0.. of ``axis`` of the
    global draw, and every proposal is that of the global draw: the
    proposals' leading axis puts the row axis at ``axis + 1``."""
    shape = tuple(shape)
    dev = alpha.device
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)  # always >= 1
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    kx, ku, kb = random.split_words(key, 3)
    x = random.normal(kx, (_BUDGET,) + shape, dev, rows, axis + 1)
    u = random.uniform(ku, (_BUDGET,) + shape, minval=_TINY, device=dev,
                       rows=rows, axis=axis + 1)
    t = 1.0 + c * x
    v = t * t * t
    v_pos = v > 0.0
    log_v = torch.log(torch.where(v_pos, v, 1.0))
    accept = v_pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    idx = first_accept_index(accept)  # all six miss with p < 2e-8
    v_sel = torch.gather(v, 0, idx[None])[0]
    z = d * torch.clamp(v_sel, min=_TINY)
    u3 = random.uniform(kb, shape, minval=_TINY, device=dev, rows=rows,
                        axis=axis)
    return torch.where(boost, z * u3 ** (1.0 / torch.clamp(alpha, min=_TINY)),
                       z), idx


class _GammaSample(torch.autograd.Function):
    """The draw, with the implicit gradient in alpha."""

    @staticmethod
    def forward(ctx, alpha, key, shape, rows, axis):
        z, _ = _gamma_fixed(key, alpha, shape, rows, axis)
        ctx.save_for_backward(alpha, z)
        return z

    @staticmethod
    def backward(ctx, g):
        alpha, z = ctx.saved_tensors
        return g * random_gamma_grad(alpha, z), None, None, None, None


def gamma_sample(key, alpha, shape: Sequence[int], device=None,
                 rows: random.Rows = None, axis: int = 0) -> torch.Tensor:
    """Gamma(alpha, 1) of ``shape`` (alpha broadcast to it), float32,
    differentiable in alpha; ``device`` is alpha's when alpha is a
    tensor.  With ``rows``, rows row0.. along ``axis`` of the global draw
    (``random.counters``): the draw is elementwise, so they equal those
    rows of it bit for bit."""
    shape = tuple(shape)
    if isinstance(alpha, torch.Tensor):
        device = alpha.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    alpha_b = torch.broadcast_to(alpha, shape)
    return _GammaSample.apply(alpha_b.contiguous(), key, shape, rows, axis)
