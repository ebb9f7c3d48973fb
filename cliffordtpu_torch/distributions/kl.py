"""KL-divergence registry (port of ``cliffordtpu/distributions/kl.py``).

``kl_divergence(q, p)`` dispatches on the (type(q), type(p)) pair; new
pairs register with ``@register_kl``.  The pairs against a uniform prior
have the form ``KL(q || uniform) = -H[q] + H[uniform]``.
"""

from __future__ import annotations

from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.distributions.uniforms import CliffordTorusUniform

_KL_REGISTRY = {}


def register_kl(type_q, type_p):
    def decorator(fn):
        _KL_REGISTRY[(type_q, type_p)] = fn
        return fn

    return decorator


def kl_divergence(q, p):
    fn = _KL_REGISTRY.get((type(q), type(p)))
    if fn is None:
        raise NotImplementedError(
            f"No KL registered for ({type(q).__name__}, {type(p).__name__})")
    return fn(q, p)


@register_kl(CliffordPowerSphericalDistribution, CliffordTorusUniform)
def _neg_entropy_plus_uniform(q, p):
    return -q.entropy() + p.entropy()
