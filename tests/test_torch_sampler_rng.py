"""The port's Philox sampler + torus embedding (cliffordtpu_torch/kernels/
sampler.py: ``sample_embed_rng_plain``, the plain version of
csrc/sampler_rng.cu) and its generator (cliffordtpu_torch/random.py).

The TPU kernel it replaces (kernels/sampler_pallas.py::sample_torus_fused)
draws from the core's hardware generator, so the streams cannot agree:
the generator is held to an independent numpy Philox and its seed words to
``jax.random.fold_in``; the sampler's formula, embedding and backward to
the interpret-mode kernel on that kernel's own (theta, u, v) residuals;
the stream's moments to the keyed sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import sampler_pallas as sp
from cliffordtpu.kernels.torus_pallas import _round_up
from cliffordtpu_torch import random as trandom
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.kernels import sampler, torus
from cliffordtpu_torch.ops.torus import angles_to_torus

torch.set_num_threads(1)


def _numpy_philox4x32(key, counter, rounds=10):
    """Philox-4x32 written from the paper (Salmon et al., SC'11) with
    numpy's uint64 products; counter (4, N) uint32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    c = [np.asarray(w, dtype=np.uint32) for w in counter]
    for _ in range(rounds):
        p0 = np.uint64(0xD2511F53) * c[0].astype(np.uint64)
        p1 = np.uint64(0xCD9E8D57) * c[2].astype(np.uint64)
        hi0, hi1 = ((p >> np.uint64(32)).astype(np.uint32) for p in (p0, p1))
        lo0, lo1 = p0.astype(np.uint32), p1.astype(np.uint32)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = np.uint32((int(k0) + 0x9E3779B9) & 0xFFFFFFFF)
        k1 = np.uint32((int(k1) + 0xBB67AE85) & 0xFFFFFFFF)
    return c


@pytest.mark.parametrize("key", [(0, 0), (0xA4093822, 0x299F31D0),
                                 (1, 0xFFFFFFFF)])
def test_philox_matches_an_independent_numpy_implementation(key):
    rng = np.random.default_rng(key[0] % 97)
    counter = rng.integers(0, 2 ** 32, (4, 257), dtype=np.uint64)
    counter[:, 0] = 0
    counter[:, 1] = 0xFFFFFFFF  # carries in every product
    want = _numpy_philox4x32(key, counter.astype(np.uint32))
    got = trandom.philox4x32(key, tuple(torch.from_numpy(
        c.astype(np.int64)) for c in counter))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    # on Python ints too (the host path), and a counter of ints broadcasts
    ints = trandom.philox4x32(key, tuple(int(c[5]) for c in counter))
    assert list(ints) == [int(w[5]) for w in want]


def test_philox_known_answers():
    """Random123's known-answer vectors for philox4x32-10, which the
    independent implementation reproduces as well."""
    kat = [((0, 0), (0, 0, 0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xA4093822, 0x299F31D0),
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for key, counter, want in kat:
        ref = _numpy_philox4x32(key, [np.array([c]) for c in counter])
        assert tuple(int(w[0]) for w in ref) == want
        assert tuple(trandom.philox4x32(key, counter)) == want


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 7])
def test_seed_words_equal_jax_fold_in(seed):
    """The kernel's two key words are the TPU kernel's seed words:
    ``fold_in(key, 0x7A11A5)`` (sampler_pallas.py::sample_torus_fused)."""
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.key_data(jax.random.fold_in(
        key, sampler.RNG_FOLD))).astype(np.uint32)
    got = sampler.rng_seed_words(np.asarray(key, dtype=np.uint32))
    assert sampler.RNG_FOLD == 0x7A11A5
    assert [int(w) for w in want] == list(got)
    for data in (0, 1, 0xFFFFFFFF):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(
            key, np.uint32(data))))
        assert [int(w) for w in want] == list(
            trandom.fold_in_words(np.asarray(key), data))


def _interpret_residuals(d, rows, kappa_val=5.0):
    """The TPU kernel in interpret mode, as tests/test_kernels.py calls it,
    on padded operands: (seed, loc_pad, kap_pad, x, theta, u, v)."""
    rng = np.random.default_rng(d * rows)
    loc = rng.uniform(-np.pi, np.pi, (rows, d)).astype(np.float32)
    kp, rp = _round_up(d - 1, 8), _round_up(rows, 8)
    loc_pad = jnp.zeros((rp, kp)).at[:rows, : d - 1].set(loc[:, 1:])
    kap = rng.uniform(0.5, 20.0, (rows, d - 1)).astype(np.float32) \
        if kappa_val is None else np.full((rows, d - 1), kappa_val, np.float32)
    kap_pad = jnp.ones((rp, kp)).at[:rows, : d - 1].set(kap)
    seed = jnp.array((123, 456), jnp.uint32)
    with pltpu.force_tpu_interpret_mode():
        x, th, u, v = sp._sample_embed_call(seed, loc_pad, kap_pad, d)
    cut = lambda a: np.asarray(a)[:rows, : d - 1].copy()  # noqa: E731
    return (seed, loc_pad, kap_pad, np.asarray(x)[:rows, : 2 * d], cut(th),
            cut(u), cut(v), loc, kap)


@pytest.mark.parametrize("d,rows", [(9, 16), (64, 8)])
def test_formula_and_embedding_on_the_interpret_kernels_residuals(d, rows):
    """theta = the closed-form circle sampler on the TPU kernel's own
    (u, v) (<= 1e-6), x = the embedding of its theta (<= 1e-5)."""
    _, _, _, x, th, u, v, loc, kap = _interpret_residuals(d, rows)
    got_th = sampler.circle_angles(
        torch.from_numpy(loc[:, 1:].copy()), torch.from_numpy(kap),
        torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(got_th.numpy(), th, atol=1e-6, rtol=0)
    np.testing.assert_allclose(torus.torus_fwd(got_th).numpy(), x, atol=1e-5,
                               rtol=0)
    assert u.min() >= sampler.U_MIN and u.max() < 1.0 and v.min() >= 0.0


def test_backward_on_the_interpret_kernels_residuals():
    """The port's backward (``sampler_bwd``) on the residuals against the
    TPU kernel's custom VJP, <= 1e-5 for dloc and dkappa."""
    d, rows = 9, 16
    seed, loc_pad, kap_pad, _, th, u, v, _, kap = _interpret_residuals(
        d, rows, kappa_val=None)
    w = np.random.default_rng(3).normal(
        size=(loc_pad.shape[0], 128)).astype(np.float32)

    def loss(lp, kpad):
        return jnp.sum(w * sp._sample_embed(seed, lp, kpad, d))

    with pltpu.force_tpu_interpret_mode():
        want_loc, want_kap = jax.grad(loss, argnums=(0, 1))(loc_pad, kap_pad)
    kappa = torch.cat([torch.ones(rows, 1), torch.from_numpy(kap)], dim=1)
    d_loc, d_kap = torus.sampler_bwd(
        torch.from_numpy(th), torch.from_numpy(u), torch.from_numpy(v),
        kappa, torch.from_numpy(w[:rows, : 2 * d].copy()))
    np.testing.assert_allclose(d_loc[:, 1:].numpy(),
                               np.asarray(want_loc)[:rows, : d - 1],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(d_kap[:, 1:].numpy(),
                               np.asarray(want_kap)[:rows, : d - 1],
                               atol=1e-5, rtol=0)


def _inputs(d, rows, seed, per_row=True):
    rng = np.random.default_rng(seed)
    loc = torch.from_numpy(rng.uniform(-np.pi, np.pi, (rows, d))
                           .astype(np.float32))
    kap = torch.from_numpy(rng.uniform(0.5, 10.0, (rows, 1 if per_row else d))
                           .astype(np.float32))
    return loc, kap


def test_stream_is_deterministic_per_key_and_free_of_tiling():
    """One key, one stream; another key, another stream; and element (r, k)
    depends on the key and r*d + k only: rows drawn alone, or as part of a
    larger call, get the same uniforms."""
    d, rows = 9, 40
    loc, kap = _inputs(d, rows, 1)
    a = sampler.sample_embed_rng((0, 7), loc, kap)
    b = sampler.sample_embed_rng((0, 7), loc, kap)
    c = sampler.sample_embed_rng((0, 8), loc, kap)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2]) and not torch.equal(a[0], c[0])
    x, theta, u, v = a
    assert x.shape == (rows, 2 * d) and theta.shape == u.shape == (rows, d - 1)
    assert u.min() >= sampler.U_MIN and u.max() < 1 and 0 <= v.min() \
        and v.max() < 1
    part = sampler.sample_embed_rng((0, 7), loc[:13], kap[:13])
    assert all(torch.equal(p, q[:13]) for p, q in zip(part, a))
    seed = sampler.rng_seed_words((0, 7))
    u_all, v_all = sampler.rng_uniforms(seed, rows, d)
    w0, w1, _, _ = trandom.philox4x32(seed, (torch.tensor([21 * d + 4]), 0,
                                             0, 0))
    assert trandom.uniform_from_bits(w0).item() == u_all[21, 4].item()
    assert trandom.uniform_from_bits(w1).item() == v_all[21, 4].item()
    assert torch.equal(u, u_all[:, 1:]) and torch.equal(v, v_all[:, 1:])


def test_moments_agree_with_the_keyed_sampler():
    """E[cos(theta - loc)] of the Philox stream against the keyed threefry
    sampler at the same kappa: another stream, the same distribution
    (tests/test_kernels.py::test_fused_sampler_distribution_moments)."""
    d, rows = 9, 512
    loc, _ = _inputs(d, rows, 2)
    kap = torch.full((rows, 1), 6.0)
    _, th_rng, _, _ = sampler.sample_embed_rng((0, 11), loc, kap)
    _, th_key, _, _ = sampler.sample_embed_keyed((0, 11), loc, kap)
    got = torch.cos(th_rng - loc[:, 1:]).mean().item()
    ref = torch.cos(th_key - loc[:, 1:]).mean().item()
    assert abs(got - ref) < 0.02, (got, ref)
    assert 0.8 < got < 1.0  # concentrated around loc at kappa 6


def test_distribution_routes():
    """``sample(key, sampler=...)``: "rng" is the Philox sampler reshaped,
    "keyed" and "unfused" agree with each other, an unknown route raises."""
    d, B, T = 16, 3, 5
    rng = np.random.default_rng(3)
    loc = torch.from_numpy(rng.uniform(-3, 3, (B, T, d)).astype(np.float32))
    kap = torch.from_numpy(rng.uniform(0.03, 10, (B, T, 1)).astype(np.float32))
    dist = CliffordPowerSphericalDistribution(loc, kap.expand(B, T, d))
    z = dist.sample((0, 42), sampler="rng")
    x, theta, _, _ = sampler.sample_embed_rng_plain(
        (0, 42), loc.reshape(-1, d), kap.reshape(-1, 1))
    assert torch.equal(z, x.reshape(B, T, 2 * d))
    full = torch.cat([torch.zeros(B * T, 1), theta], dim=1)
    np.testing.assert_allclose(angles_to_torus(full).numpy(), x.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        dist.sample((0, 42), sampler="unfused").numpy(),
        dist.sample((0, 42)).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="sampler"):
        dist.sample((0, 42), sampler="hardware")


def test_autograd_function_routes_to_the_backward_launch(monkeypatch):
    """The card's path with the launchers replaced by the plain versions:
    ``_SampleEmbedRng`` saves theta, u, v and the strided kappa and calls
    ``sampler_bwd`` once; its gradients are autograd's of the plain
    version."""
    d, rows = 9, 6
    loc, kap = _inputs(d, rows, 19)
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(rows, 2 * d)).astype(np.float32))
    calls = []

    def launch(key, loc_, kap_, row0=0):
        with torch.no_grad():
            return sampler.sample_embed_rng_plain(key, loc_, kap_)

    def bwd(theta, u, v, kappa, g):
        calls.append(kappa.stride())
        return torus.sampler_bwd_plain(theta, u, v, kappa, g)

    monkeypatch.setattr(sampler, "_launch_rng", launch)
    monkeypatch.setattr(torus, "sampler_bwd", bwd)
    tl, tk = loc.clone().requires_grad_(), kap.clone().requires_grad_()
    x, theta, u, v = sampler._SampleEmbedRng.apply(
        (0, 3), tl, torch.broadcast_to(tk, (rows, d)))
    assert not (theta.requires_grad or u.requires_grad or v.requires_grad)
    g_loc, g_kap = torch.autograd.grad(x, (tl, tk), w)
    assert calls == [(1, 0)]
    pl, pk = loc.clone().requires_grad_(), kap.clone().requires_grad_()
    xp, _, _, _ = sampler.sample_embed_rng((0, 3), pl, pk)
    want_loc, want_kap = torch.autograd.grad(xp, (pl, pk), w)
    np.testing.assert_allclose(g_loc.numpy(), want_loc.numpy(), atol=1e-5)
    np.testing.assert_allclose(g_kap.numpy(), want_kap.numpy(), atol=1e-5)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = (sampler.launches, sampler.rng_launches)
    loc = torch.zeros(4, 9)
    sampler.sample_embed_rng((0, 1), loc, torch.ones(4, 9))
    assert (sampler.launches, sampler.rng_launches) == before
    with pytest.raises(ValueError):
        sampler.sample_embed_rng((0, 1), loc.to("meta"),
                                 torch.ones(4, 9, device="meta"))


def _draw_then_fft(key, loc, kappa):
    """The FFT form of csrc/sampler_rng.cu in torch: a row's angle pairs
    (k, d - k), k = 1..d/2, each angle drawn from counter r d + k under
    the seed words, sampled and written at column k - 1 (once: k = d - k
    is drawn once); the pair packed as Z_k = A_k + i w_k B_k, Z_{d-k} =
    conj(A_k - i w_k B_k), A_k = X_k + conj X_{d-k}, B_k = X_k - conj
    X_{d-k}, X_k = e^{i theta_k}, w_k = e^{i pi k / d}, Z_0 = 2; the
    unnormalised inverse d-point DFT z of Z; x_{2m} = Re z_m / n,
    x_{2m+1} = Im z_m / n, n = 2d.  Returns (x, theta, u, v) and how often
    each angle was written."""
    R, d = loc.shape
    kap = torch.broadcast_to(kappa, (R, d))
    seed = sampler.rng_seed_words(key)
    k = torch.arange(1, d // 2 + 1)
    outs = [torch.zeros(R, d - 1) for _ in range(3)]  # theta, u, v
    written = torch.zeros(R, d - 1, dtype=torch.int64)
    for cols in (k, (d - k)[d - k != k]):
        q = torch.arange(R)[:, None] * d + cols[None, :]
        w0, w1, _, _ = trandom.philox4x32(seed, (q, 0, 0, 0))
        u = torch.clamp(trandom.uniform_from_bits(w0), min=sampler.U_MIN)
        v = trandom.uniform_from_bits(w1)
        theta = sampler.circle_angles(loc[:, cols], kap[:, cols], u, v)
        for out, val in zip(outs, (theta, u, v)):
            out[:, cols - 1] = val
        written[:, cols - 1] += 1
    X = torch.polar(torch.ones(R, d - 1), outs[0])
    Xk, Xr = X[:, k - 1], X[:, d - k - 1]
    w = torch.polar(torch.ones(len(k)), (torch.pi / d) * k.float())
    A, Bw = Xk + Xr.conj(), 1j * w * (Xk - Xr.conj())
    Z = torch.zeros(R, d, dtype=torch.complex64)
    Z[:, 0] = 2
    Z[:, d - k] = (A - Bw).conj()
    Z[:, k] = A + Bw  # k = d/2 last: Z_{d/2} = A + i w B
    z = torch.fft.ifft(Z, dim=1) * d / (2 * d)
    x = torch.stack([z.real, z.imag], dim=2).reshape(R, 2 * d)
    return (x, *outs), written


@pytest.mark.parametrize("d", [2, 16, 256, 4096])
def test_draw_then_fft_equals_the_plain_version(d):
    """The FFT form's pipeline (each angle pair drawn, sampled and packed
    by one thread, then the inverse FFT) draws every angle exactly once,
    gives the plain version's theta, u and v bit for bit and its x within
    1e-5; ``torus.form`` sends exactly the powers of two to it."""
    rows = 3
    loc, kap = _inputs(d, rows, 500 + d, per_row=d != 16)
    got, written = _draw_then_fft((0, 9 + d), loc, kap)
    want = sampler.sample_embed_rng_plain((0, 9 + d), loc, kap)
    assert bool((written == 1).all())
    for name, g, w in zip(("theta", "u", "v"), got[1:], want[1:]):
        assert torch.equal(g, w), name
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5,
                               rtol=0)
    assert torus.form(d) == "fft"
    assert [torus.form(n) for n in (3, 513, 2047, 4095)] == \
        ["table"] * 4
