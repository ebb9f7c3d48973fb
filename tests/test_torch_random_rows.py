"""Row ranges of every draw of the port: rows r0:r1 of a batch, drawn with
``rows=(r0, n_rows)``, equal the same rows of the global draw bit for bit
(the counters of ``random.counters``), and the threefry ones equal
``jax.random``'s rows; so a rank of a data-parallel step draws its rows
of the global batch without drawing the rest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu_torch import random as trandom
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
    CliffordTorusDistribution,
)
from cliffordtpu_torch.distributions.gamma import gamma_sample
from cliffordtpu_torch.distributions.normal import Normal
from cliffordtpu_torch.distributions.power_spherical import PowerSpherical
from cliffordtpu_torch.distributions.von_mises_fisher import VonMisesFisher
from cliffordtpu_torch.kernels import sampler

torch.set_num_threads(1)

KEY = np.asarray(jax.random.PRNGKey(5))
R0, R1, N = 3, 7, 10  # rows 3..6 of a batch of 10


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape,axis", [((N, 6), 0), ((4, N, 3), 1),
                                        ((2, 3, N), 2)])
def test_counters_and_bits_are_the_global_draws_rows(shape, axis):
    want = np.asarray(jax.random.bits(KEY, shape, jnp.uint32)).astype(
        np.int64)
    local = list(shape)
    local[axis] = R1 - R0
    got = trandom.random_bits(KEY, local, rows=(R0, N), axis=axis).numpy()
    _eq(got, np.take(want, np.arange(R0, R1), axis=axis))
    full = trandom.counters(shape).reshape(shape).numpy()
    _eq(trandom.counters(local, rows=(R0, N), axis=axis).reshape(local),
        np.take(full, np.arange(R0, R1), axis=axis))


def test_uniform_and_normal_rows_match_jax():
    u = np.asarray(jax.random.uniform(KEY, (N, 5), minval=-2.0, maxval=3.0))
    _eq(trandom.uniform(KEY, (R1 - R0, 5), -2.0, 3.0, rows=(R0, N)),
        u[R0:R1])
    n_local = trandom.normal(KEY, (R1 - R0, 5), rows=(R0, N))
    n_global = trandom.normal(KEY, (N, 5))
    _eq(n_local, n_global[R0:R1])
    np.testing.assert_allclose(
        n_local.numpy(), np.asarray(jax.random.normal(KEY, (N, 5)))[R0:R1],
        rtol=2e-5, atol=2e-6)


def test_the_counter_limit_holds_for_the_global_draw():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        trandom.counters((2, 8), rows=(0, 2 ** 31), axis=0)
    with pytest.raises(ValueError, match="outside"):
        trandom.counters((4, 2), rows=(8, 10))


def test_gamma_rows_are_the_global_draws_rows():
    alpha = torch.linspace(0.3, 4.0, N * 3).reshape(N, 3)
    full = gamma_sample(KEY, alpha, (N, 3))
    part = gamma_sample(KEY, alpha[R0:R1], (R1 - R0, 3), rows=(R0, N))
    _eq(part, full[R0:R1])
    # a leading axis before the rows, as the vMF proposals have
    full = gamma_sample(KEY, 1.5, (4, N, 2))
    part = gamma_sample(KEY, 1.5, (4, R1 - R0, 2), rows=(R0, N), axis=1)
    _eq(part, full[:, R0:R1])


@pytest.mark.parametrize("kernel", ["keyed", "rng"])
def test_sampler_plain_versions_draw_their_rows(kernel):
    plain = (sampler.sample_embed_keyed_plain if kernel == "keyed"
             else sampler.sample_embed_rng_plain)
    g = torch.Generator().manual_seed(3)
    loc = torch.rand(N, 16, generator=g) * 6 - 3
    kap = torch.rand(N, 1, generator=g) * 5
    full = plain(KEY, loc, kap)
    part = plain(KEY, loc[R0:R1], kap[R0:R1], rows=(R0, N))
    for a, b in zip(part, full):
        _eq(a, b[R0:R1])
    if kernel == "keyed":  # u, v are jax.random's
        k_u, k_v = jax.random.split(KEY)
        v = np.asarray(jax.random.uniform(k_v, (N, 16)))
        _eq(part[3], v[R0:R1, 1:])


def _families():
    g = torch.Generator().manual_seed(4)
    mu = torch.randn(N, 2, 8, generator=g)
    unit = mu / mu.norm(dim=-1, keepdim=True)
    kap = torch.rand(N, 2, generator=g) * 4 + 0.5
    return {
        "normal": (Normal(mu, kap[..., None]), {}),
        "powerspherical": (PowerSpherical(unit, kap), {}),
        "vmf": (VonMisesFisher(unit, kap), {}),
        "vmf3": (VonMisesFisher(unit[..., :3] / unit[..., :3].norm(
            dim=-1, keepdim=True), kap), {}),
        "torus_vm": (CliffordTorusDistribution(mu, kap[..., None]), {}),
        **{f"clifford_{s}": (CliffordPowerSphericalDistribution(
            mu, kap[..., None]), {"sampler": s})
           for s in ("keyed", "unfused", "rng")},
    }


@pytest.mark.parametrize("family", sorted(_families()))
def test_every_family_draws_its_rows_of_the_global_batch(family):
    """Per-token latents (B, T, d), T = 2 folded into the fused kernels'
    flat rows: every family's draw of rows 3..6 is those rows of the
    global draw, bit for bit; vMF's rejection is elementwise, so it is
    too, with no global draw behind it."""
    dist, kw = _families()[family]
    full = dist.sample(KEY, **kw)
    sliced = type(dist)(*(t[R0:R1] for t in (
        (dist.loc, getattr(dist, "scale", None)) if hasattr(dist, "scale")
        else (dist.loc, dist.concentration))))
    part = sliced.sample(KEY, rows=(R0, N), **kw)
    _eq(part, full[R0:R1])
