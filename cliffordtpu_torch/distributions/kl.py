"""KL-divergence registry (port of ``cliffordtpu/distributions/kl.py``).

``kl_divergence(q, p)`` dispatches on the (type(q), type(p)) pair; new
pairs register with ``@register_kl``.  The pairs against a uniform prior
have the form ``KL(q || uniform) = -H[q] + H[uniform]``; the Gaussian pair
is the closed form, elementwise.
"""

from __future__ import annotations

from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
    CliffordTorusDistribution,
)
from cliffordtpu_torch.distributions.normal import Normal, kl_normal_normal
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical
from cliffordtpu_torch.distributions.uniforms import (
    CliffordTorusUniform,
    HypersphericalUniform,
    VMFHypersphericalUniform,
)
from cliffordtpu_torch.distributions.von_mises_fisher import VonMisesFisher

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


def _neg_entropy_plus_uniform(q, p):
    return -q.entropy() + p.entropy()


for _pair in ((CliffordPowerSphericalDistribution, CliffordTorusUniform),
              (CliffordTorusDistribution, CliffordTorusUniform),
              (PowerSpherical, HypersphericalUniform),
              (VonMisesFisher, VMFHypersphericalUniform)):
    register_kl(*_pair)(_neg_entropy_plus_uniform)
register_kl(Normal, Normal)(kl_normal_normal)
