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
