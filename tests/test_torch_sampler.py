"""The port's keyed sampler + torus embedding (cliffordtpu_torch/kernels/
sampler.py, plain version) against the JAX sampler and the interpret-mode
Pallas keyed kernel (kernels/sampler_pallas.py)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution as JaxCliffordPS,
)
from cliffordtpu.kernels import sampler_pallas as sp
from cliffordtpu.kernels.torus_pallas import _round_up
from cliffordtpu_torch import random as trandom
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.kernels import sampler, torus
from cliffordtpu_torch.ops.torus import MATMUL_MAX_DIM

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPES = [(9, 7), (9, 64), (16, 7), (16, 64)]  # (d, R)


def _inputs(d, R, seed):
    rng = np.random.default_rng(seed)
    loc = rng.uniform(-np.pi, np.pi, (R, d)).astype(np.float32)
    kap = rng.uniform(0.03, 10.0, (R, d)).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(seed), dtype=np.uint32)
    return loc, kap, key


@pytest.mark.parametrize("d,R", SHAPES)
def test_plain_sampler_matches_jax_sampler(d, R):
    loc, kap, key = _inputs(d, R, 11 + d + R)
    want = np.asarray(JaxCliffordPS(jnp.asarray(loc),
                                    jnp.asarray(kap)).sample(key))
    x, theta, u, v = sampler.sample_embed_keyed(
        key, torch.from_numpy(loc), torch.from_numpy(kap))
    assert x.shape == (R, 2 * d) and theta.shape == u.shape == (R, d - 1)
    np.testing.assert_allclose(x.numpy(), want, atol=1e-5, rtol=0)
    k_u, k_v = jax.random.split(key)
    u_want = np.asarray(jax.random.uniform(k_u, (R, d), jnp.float32,
                                           minval=1e-12))[:, 1:]
    v_want = np.asarray(jax.random.uniform(k_v, (R, d), jnp.float32))[:, 1:]
    np.testing.assert_array_equal(v.numpy(), v_want)
    np.testing.assert_array_max_ulp(u.numpy(), u_want, maxulp=2)


@pytest.mark.parametrize("d,R", [(9, 7), (16, 64)])
def test_plain_sampler_matches_interpret_kernel(d, R):
    """The same (u, v, theta, x) as the Pallas keyed kernel, called as
    tests/test_kernels.py calls it."""
    loc, kap, key = _inputs(d, R, 5 + d * R)
    kp, Rp = _round_up(d - 1, 8), _round_up(R, 8)
    k_u, k_v = jax.random.split(jnp.asarray(key))
    seeds = jnp.concatenate([sp._raw_key_words(k_u), sp._raw_key_words(k_v)])
    loc_pad = jnp.zeros((Rp, kp), jnp.float32).at[:R, : d - 1].set(loc[:, 1:])
    kap_pad = jnp.ones((Rp, kp), jnp.float32).at[:R, : d - 1].set(kap[:, 1:])
    with pltpu.force_tpu_interpret_mode():
        _, th_k, u_k, v_k = sp._keyed_sample_embed_call(
            seeds, loc_pad, kap_pad, d)
        x_k = sp._keyed_sample_torus(jnp.asarray(key), jnp.asarray(loc),
                                     jnp.asarray(kap), d, R)
    x, theta, u, v = sampler.sample_embed_keyed(
        key, torch.from_numpy(loc), torch.from_numpy(kap))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_k)[:R, : d - 1])
    np.testing.assert_array_max_ulp(u.numpy(), np.asarray(u_k)[:R, : d - 1],
                                    maxulp=2)
    np.testing.assert_allclose(theta.numpy(), np.asarray(th_k)[:R, : d - 1],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_k), atol=1e-5, rtol=0)


def test_distribution_sample_paths_agree():
    """sample(key) == sample_from_uniforms(the key's uniforms), and a
    per-token concentration broadcast over the angles (as CliffordARVAE
    passes it) draws the same as the materialised one."""
    d, B, T = 16, 3, 5
    rng = np.random.default_rng(3)
    loc = torch.from_numpy(rng.uniform(-3, 3, (B, T, d)).astype(np.float32))
    kap_tok = torch.from_numpy(rng.uniform(0.03, 10, (B, T, 1))
                               .astype(np.float32))
    key = (0, 42)
    dist = CliffordPowerSphericalDistribution(loc, kap_tok.expand(B, T, d))
    z = dist.sample(key)
    assert z.shape == (B, T, 2 * d)
    k_u, k_v = trandom.split(key)
    u = trandom.uniform(k_u, (B, T, d), minval=1e-12)
    v = trandom.uniform(k_v, (B, T, d))
    np.testing.assert_allclose(z.numpy(), dist.sample_from_uniforms(u, v)
                               .numpy(), atol=1e-6, rtol=0)
    z_full = CliffordPowerSphericalDistribution(
        loc, kap_tok.expand(B, T, d).contiguous()).sample(key)
    np.testing.assert_array_equal(z.numpy(), z_full.numpy())
    np.testing.assert_allclose(torch.linalg.vector_norm(z, dim=-1).numpy(),
                               1.0, atol=1e-5)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = sampler.launches
    loc = torch.zeros(4, 9)
    sampler.sample_embed_keyed((0, 1), loc, torch.ones(4, 9))
    assert sampler.launches == before
    with pytest.raises(ValueError):
        sampler.sample_embed_keyed((0, 1), loc.to("meta"),
                                   torch.ones(4, 9, device="meta"))


def _header_constants():
    """The ``constexpr int`` tiling constants of csrc/torus_basis.cuh."""
    text = (pathlib.Path(torus.__file__).parents[1] / "csrc"
            / "torus_basis.cuh").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        consts[name] = eval(expr, {}, consts)  # integers and earlier names
    return consts


@pytest.mark.parametrize("d", [2, 16, 513, 4096])
def test_rows_per_block_fits_shared_memory(d):
    """With the header's own tiling (64 rows per block whatever d is), the
    basis table (8 bytes per phase, 2d phases) and one staged chunk of
    cos and sin theta
    fit what a block can opt in to, up to the largest d the wrappers pass
    on, which is the header's."""
    k = _header_constants()
    assert k["kTorusRows"] == 64 and k["kTorusPitch"] == k["kTorusRows"] + 1
    assert k["kTorusMaxDim"] == MATMUL_MAX_DIM >= d
    staged = 2 * 4 * k["kTorusChunk"] * k["kTorusPitch"]
    assert 16 * d + staged <= k["kTorusMaxSmem"] <= 227 * 1024


def _keyed_draw_then_fft(key, loc, kappa, row0=0):
    """The FFT form of csrc/sampler_keyed.cu in torch: a row's angle pairs
    (k, d - k), k = 1..d/2, each angle drawn from counter (row0 + r) d + k
    (threefry-2x32 on (0, counter), x0 ^ x1, under each half of the split
    key), sampled and written at column k - 1 (k = d - k once); the pair
    packed as Z_k = A_k + i w_k B_k, Z_{d-k} = conj(A_k - i w_k B_k), A_k =
    X_k + conj X_{d-k}, B_k = X_k - conj X_{d-k}, X_k = e^{i theta_k}, w_k =
    e^{i pi k / d}, Z_0 = 2; z the unnormalised inverse d-point DFT of Z
    (in float64); x_{2m} = Re z_m / n, x_{2m+1} = Im z_m / n, n = 2d.
    Returns (x, theta, u, v) and how often each angle was written."""
    R, d = loc.shape
    kap = torch.broadcast_to(kappa, (R, d))
    keys = trandom.split_words(key)
    k = torch.arange(1, d // 2 + 1)
    outs = [torch.zeros(R, d - 1) for _ in range(3)]  # theta, u, v
    written = torch.zeros(R, d - 1, dtype=torch.int64)
    for cols in (k, (d - k)[d - k != k]):
        q = (row0 + torch.arange(R))[:, None] * d + cols[None, :]
        (a0, a1), (b0, b1) = (trandom.threefry2x32(k0, k1,
                                                   torch.zeros_like(q), q)
                              for k0, k1 in keys)
        u = trandom.uniform_from_bits(a0 ^ a1, minval=sampler.U_MIN)
        v = trandom.uniform_from_bits(b0 ^ b1)
        theta = sampler.circle_angles(loc[:, cols], kap[:, cols], u, v)
        for out, val in zip(outs, (theta, u, v)):
            out[:, cols - 1] = val
        written[:, cols - 1] += 1
    X = torch.polar(torch.ones(R, d - 1, dtype=torch.float64),
                    outs[0].double())
    Xk, Xr = X[:, k - 1], X[:, d - k - 1]
    w = torch.polar(torch.ones(len(k), dtype=torch.float64),
                    (torch.pi / d) * k.double())
    A, Bw = Xk + Xr.conj(), 1j * w * (Xk - Xr.conj())
    Z = torch.zeros(R, d, dtype=torch.complex128)
    Z[:, 0] = 2
    Z[:, d - k] = (A - Bw).conj()
    Z[:, k] = A + Bw  # k = d/2 last: Z_{d/2} = A + i w B
    z = torch.fft.ifft(Z, dim=1) * d / (2 * d)
    x = torch.stack([z.real, z.imag], dim=2).reshape(R, 2 * d).float()
    return (x, *outs), written


@pytest.mark.parametrize("d,row0", [(2, 0), (16, 0), (256, 0), (16, 7),
                                    (256, 3)])
def test_keyed_draw_then_fft_equals_the_plain_version(d, row0):
    """The keyed kernel's FFT form (each angle pair drawn, sampled and
    packed by one thread, then the inverse FFT) draws every angle exactly
    once and gives ``sample_embed_keyed_plain``'s theta, u and v bit for
    bit and its x within 1e-6, also for rows row0.. of a larger draw."""
    R = 3
    rng = np.random.default_rng(800 + d + row0)
    loc = torch.from_numpy(rng.uniform(-np.pi, np.pi, (R, d))
                           .astype(np.float32))
    kappa = torch.from_numpy(rng.uniform(0.03, 10.0, (R, 1))
                             .astype(np.float32))
    key = (0, 31 + d)
    got, written = _keyed_draw_then_fft(key, loc, kappa, row0)
    want = sampler.sample_embed_keyed_plain(
        key, loc, kappa, rows=(row0, row0 + R + 2) if row0 else None)
    assert bool((written == 1).all())
    for name, g, w in zip(("theta", "u", "v"), got[1:], want[1:]):
        assert torch.equal(g, w), name
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-6,
                               rtol=0)


def test_form_is_the_kernels_dispatch():
    """``torus.form`` names the form that the kernels' own dispatch
    (``torus_fft.cuh::fft_is_pow2``) takes, at every d up to the largest."""
    text = (pathlib.Path(torus.__file__).parents[1] / "csrc"
            / "torus_fft.cuh").read_text()
    expr = re.search(r"fft_is_pow2\(int d\) \{\s*return ([^;]+);",
                     text).group(1)
    expr = expr.replace("&&", " and ")
    for d in range(1, 4097):
        want = "fft" if eval(expr, {}, {"d": d}) else "table"
        assert torus.form(d) == want, d
