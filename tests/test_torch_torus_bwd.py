"""The port's torus backward and keyed-sampler backward
(cliffordtpu_torch/kernels/torus.py: ``torus_bwd_plain`` and
``sampler_bwd_plain``, the plain versions of csrc/torus_bwd.cu) against
jax.grad of the XLA paths and the VJPs of the interpret-mode Pallas
kernels (kernels/torus_pallas.py, kernels/sampler_pallas.py)."""

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
from cliffordtpu.kernels import torus_pallas as tp
from cliffordtpu.ops.torus import angles_to_torus as jax_angles_to_torus
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.kernels import sampler, torus
from cliffordtpu_torch.ops.torus import MATMUL_MAX_DIM

torch.set_num_threads(1)

DIMS = [2, 16, 513]
R = 8


def _torus_inputs(d, seed):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (R, d)).astype(np.float32)
    g = rng.normal(size=(R, 2 * d)).astype(np.float32)
    return angles, g


@pytest.mark.parametrize("d", DIMS)
def test_plain_torus_backward_matches_jax_grad(d):
    angles, g = _torus_inputs(d, d)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_angles_to_torus(a, method="matmul") * g))(jnp.asarray(angles)))
    got = torus.torus_bwd(torch.from_numpy(angles[:, 1:]),
                          torch.from_numpy(g)).numpy()
    assert got.shape == (R, d - 1)
    np.testing.assert_allclose(got, want[:, 1:], atol=1e-5, rtol=0)
    assert np.abs(want[:, 0]).max() == 0.0  # the pinned angle


@pytest.mark.parametrize("d", DIMS)
def test_plain_torus_backward_matches_interpret_kernel(d):
    """``_torus_fused_bwd`` on padded operands, as the Pallas custom VJP
    calls it."""
    angles, g = _torus_inputs(d, 50 + d)
    kp, np_ = tp._round_up(d - 1, 8), tp._round_up(2 * d, 128)
    th_pad = jnp.zeros((R, kp), jnp.float32).at[:, : d - 1].set(angles[:, 1:])
    g_pad = jnp.zeros((R, np_), jnp.float32).at[:, : 2 * d].set(g)
    with pltpu.force_tpu_interpret_mode():
        (want,) = tp._torus_fused_bwd(d, th_pad, g_pad)
    got = torus.torus_bwd_plain(torch.from_numpy(angles[:, 1:]),
                                torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(want)[:, : d - 1], atol=1e-5,
                               rtol=0)


def _sampler_inputs(d, rows, per_row, seed):
    rng = np.random.default_rng(seed)
    loc = rng.uniform(-np.pi, np.pi, (rows, d)).astype(np.float32)
    kap = rng.uniform(0.5, 10.0, (rows, 1 if per_row else d))
    key = np.asarray(jax.random.PRNGKey(seed), dtype=np.uint32)
    w = rng.normal(size=(rows, 2 * d)).astype(np.float32)
    return loc, kap.astype(np.float32), key, w


def _port_sampler_grads(loc, kap, key, w):
    """(dloc, dkappa) of sum(w * sample) from the plain backward on the
    residuals of the port's own forward draw."""
    d = loc.shape[1]
    tl, tk = torch.from_numpy(loc), torch.from_numpy(kap)
    _, theta, u, v = sampler.sample_embed_keyed(key, tl, tk.expand(-1, d))
    return torus.sampler_bwd(theta, u, v, tk.expand(-1, d),
                             torch.from_numpy(w))


@pytest.mark.parametrize("per_row", [False, True])
def test_plain_sampler_backward_matches_jax_grad_of_xla_sampler(per_row):
    """Same key, so the same u and v: the pathwise gradient in loc and in
    kappa, <= 1e-4.  A per-row kappa expanded over the angles gets the sum
    of its row (autograd's expand backward in the port)."""
    d, rows = 9, 16
    loc, kap, key, w = _sampler_inputs(d, rows, per_row, 13)

    def loss(lc, kp_):
        return jnp.sum(w * JaxCliffordPS(
            lc, jnp.broadcast_to(kp_, lc.shape)).sample(key))

    want_loc, want_kap = jax.grad(loss, argnums=(0, 1))(jnp.asarray(loc),
                                                        jnp.asarray(kap))
    d_loc, d_kap = _port_sampler_grads(loc, kap, key, w)
    assert d_loc.shape == d_kap.shape == (rows, d)
    assert (d_loc[:, 0] == 0).all() and (d_kap[:, 0] == 0).all()
    np.testing.assert_allclose(d_loc.numpy(), np.asarray(want_loc),
                               atol=1e-4, rtol=0)
    got_kap = d_kap.sum(1, keepdim=True) if per_row else d_kap
    np.testing.assert_allclose(got_kap.numpy(), np.asarray(want_kap),
                               atol=1e-4, rtol=0)


def test_plain_sampler_backward_matches_interpret_keyed_vjp():
    """Against the custom VJP of the keyed Pallas kernel, called as
    tests/test_kernels.py calls it."""
    d, rows = 9, 16
    loc, kap, key, w = _sampler_inputs(d, rows, False, 17)

    def loss(lc, kp_):
        return jnp.sum(w * sp._keyed_sample_torus(jnp.asarray(key), lc, kp_,
                                                  d, rows))

    with pltpu.force_tpu_interpret_mode():
        want_loc, want_kap = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(loc), jnp.asarray(kap))
    d_loc, d_kap = _port_sampler_grads(loc, kap, key, w)
    np.testing.assert_allclose(d_loc.numpy(), np.asarray(want_loc),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(d_kap.numpy(), np.asarray(want_kap),
                               atol=1e-4, rtol=0)


def test_cpu_sample_is_differentiable_and_equals_the_plain_backward():
    """On the CPU autograd differentiates the plain forward; it gives what
    ``sampler_bwd_plain`` gives, through the distribution's ``sample`` with
    a per-token kappa, and no kernel is counted."""
    d, B, T = 16, 2, 5
    rng = np.random.default_rng(3)
    loc = torch.from_numpy(rng.uniform(-3, 3, (B, T, d)).astype(np.float32))
    kap = torch.from_numpy(rng.uniform(0.03, 10, (B, T)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(B, T, 2 * d)).astype(np.float32))
    loc.requires_grad_()
    kap.requires_grad_()
    before = (sampler.launches, torus.launches)
    z = CliffordPowerSphericalDistribution(
        loc, kap[..., None].expand(B, T, d)).sample((0, 7))
    g_loc, g_kap = torch.autograd.grad(z, (loc, kap), w)
    assert (sampler.launches, torus.launches) == before
    with torch.no_grad():
        _, theta, u, v = sampler.sample_embed_keyed(
            (0, 7), loc.reshape(-1, d), kap.reshape(-1, 1).expand(-1, d))
        d_loc, d_kap = torus.sampler_bwd_plain(
            theta, u, v, kap.reshape(-1, 1), w.reshape(-1, 2 * d))
    np.testing.assert_allclose(g_loc.reshape(-1, d).numpy(), d_loc.numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_kap.reshape(-1).numpy(),
                               d_kap.sum(1).numpy(), atol=1e-5, rtol=0)


def test_autograd_function_routes_to_the_backward_launch(monkeypatch):
    """The card's path with the launchers replaced by the plain versions:
    the Function saves theta, u, v and the strided kappa, calls
    ``sampler_bwd`` once, and autograd sums an expanded kappa's columns."""
    d, rows = 9, 6
    loc, kap, key, w = _sampler_inputs(d, rows, True, 19)
    calls = []

    def launch(key, loc, kap, row0=0):
        with torch.no_grad():
            return sampler.sample_embed_keyed_plain(key, loc, kap)

    def bwd(theta, u, v, kappa, g):
        calls.append(kappa.stride())
        return torus.sampler_bwd_plain(theta, u, v, kappa, g)

    monkeypatch.setattr(sampler, "_launch", launch)
    monkeypatch.setattr(torus, "sampler_bwd", bwd)
    tl = torch.from_numpy(loc).requires_grad_()
    tk = torch.from_numpy(kap).requires_grad_()
    x, theta, u, v = sampler._SampleEmbedKeyed.apply(
        key, tl, torch.broadcast_to(tk, (rows, d)))
    assert not (theta.requires_grad or u.requires_grad or v.requires_grad)
    g_loc, g_kap = torch.autograd.grad(x, (tl, tk), torch.from_numpy(w))
    assert calls == [(1, 0)]  # kappa reached the backward unexpanded
    d_loc, d_kap = _port_sampler_grads(loc, kap, key, w)
    np.testing.assert_array_equal(g_loc.numpy(), d_loc.numpy())
    np.testing.assert_allclose(g_kap.numpy(),
                               d_kap.sum(1, keepdim=True).numpy(),
                               atol=1e-6, rtol=0)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = torus.launches
    torus.torus_bwd(torch.zeros(4, 8), torch.ones(4, 18))
    torus.sampler_bwd(torch.zeros(4, 8), torch.full((4, 8), 0.5),
                      torch.full((4, 8), 0.25), torch.ones(4, 1),
                      torch.ones(4, 18))
    assert torus.launches == before
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        torus.torus_bwd(meta, torch.ones(4, 18, device="meta"))
    with pytest.raises(ValueError):
        torus.sampler_bwd(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="g must be"):
        torus._check(torch.zeros(4, 8), torch.ones(4, 16))


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
    the output gradient
    fit what a block can opt in to, up to the largest d the wrappers pass
    on, which is the header's."""
    k = _header_constants()
    assert k["kTorusRows"] == 64 and k["kTorusPitch"] == k["kTorusRows"] + 1
    assert k["kTorusMaxDim"] == MATMUL_MAX_DIM >= d
    staged = 1 * 4 * k["kTorusChunk"] * k["kTorusPitch"]
    assert 16 * d + staged <= k["kTorusMaxSmem"] <= 227 * 1024


def _fft_form_bwd(theta, g, u=None, v=None, kappa=None):
    """The FFT form of csrc/torus_bwd.cu in torch, step for step: pack a row
    of g as z_m = g[2m] + i g[2m+1]; y = the unnormalised inverse d-point
    DFT of conj(z), which is conj(Z), Z the forward DFT of z; for the pair
    (k, d - k), k = 1..d/2, E = (Z_k + conj Z_{d-k}) / 2, O = (Z_k -
    conj Z_{d-k}) / 2, P = i conj(w_k) O with w_k = e^{i pi k / d}, G_k =
    E - P and G_{d-k} = conj(E + P) (the real DFT of the row, n = 2d);
    gc = Re G_k / d, gs = Im G_k / d, d theta = -sin(theta) gc +
    cos(theta) gs; with u, v and kappa the epilogue's d kappa, both (R, d)
    with column 0 zero, as ``sampler_bwd``."""
    R, d = g.shape[0], g.shape[1] // 2
    y = torch.fft.ifft(torch.complex(g[:, 0::2], -g[:, 1::2]), dim=1) * d
    k = torch.arange(1, d // 2 + 1)
    zk, zr = y[:, k].conj(), y[:, d - k].conj()
    e, o = (zk + zr.conj()) / 2, (zk - zr.conj()) / 2
    w = torch.polar(torch.ones(len(k), dtype=g.dtype),
                    (torch.pi / d) * k.to(g.dtype))
    p = 1j * w.conj() * o
    G = torch.zeros(R, d, dtype=y.dtype)
    G[:, d - k] = (e + p).conj()
    G[:, k] = e - p  # k = d/2 last: its angle is G_k alone
    dth = (-torch.sin(theta) * G.real[:, 1:]
           + torch.cos(theta) * G.imag[:, 1:]) / d
    if u is None:
        return dth
    kap = torch.broadcast_to(kappa, (R, d))[:, 1:]
    zero = torch.zeros((R, 1), dtype=dth.dtype)
    return (torch.cat([zero, dth], 1),
            torch.cat([zero, dth * torus.dtheta_dkappa(u, v, kap)], 1))


def _exact_dense_bwd(theta, g):
    """d theta from a float64 basis of the exact phases (k col) mod n: the
    plain version's product without its float32 basis."""
    d = g.shape[1] // 2
    n = 2 * d
    phase = (torch.arange(1, d)[:, None] * torch.arange(n)[None, :]) % n
    angle = (2 * np.pi / n) * phase.double()
    gc = g @ ((2 / n) * torch.cos(angle)).T
    gs = g @ (-(2 / n) * torch.sin(angle)).T
    return -torch.sin(theta) * gc + torch.cos(theta) * gs


@pytest.mark.parametrize("d", [2, 4, 16, 256])
def test_fft_form_matches_the_plain_backward(d):
    """In float64 the FFT form's steps give the dense product to 1e-9
    (exact phases), and ``torus_bwd_plain`` / ``sampler_bwd_plain`` to
    1e-7, the error of their float32 basis, with the epilogue and
    column 0 as ``sampler_bwd`` writes them."""
    rng = np.random.default_rng(600 + d)
    R = 5
    theta = torch.from_numpy(rng.uniform(-np.pi, np.pi, (R, d - 1)))
    g = torch.from_numpy(rng.normal(size=(R, 2 * d)))
    u = torch.from_numpy(rng.uniform(1e-6, 1.0, (R, d - 1)))
    v = torch.from_numpy(rng.uniform(0.0, 1.0, (R, d - 1)))
    kappa = torch.from_numpy(rng.uniform(0.03, 10.0, (R, 1)))
    got = _fft_form_bwd(theta, g)
    np.testing.assert_allclose(got.numpy(), _exact_dense_bwd(theta, g)
                               .numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(got.numpy(), torus.torus_bwd_plain(theta, g)
                               .numpy(), atol=1e-7, rtol=0)
    got = _fft_form_bwd(theta, g, u, v, kappa)
    want = torus.sampler_bwd_plain(theta, u, v, kappa, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (R, d) and (a[:, 0] == 0).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=1e-7 * max(1.0, b.abs().max()),
                                   rtol=0)


@pytest.mark.parametrize("d", [16, 256])
def test_fft_form_matches_jax_grad(d):
    """In float32, as the kernel computes, the FFT form's steps give
    jax.grad of the embedding within the plain version's bar (1e-5)."""
    angles, g = _torus_inputs(d, 700 + d)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_angles_to_torus(a, method="matmul") * g))(jnp.asarray(angles)))
    got = _fft_form_bwd(torch.from_numpy(angles[:, 1:]), torch.from_numpy(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:, 1:], atol=1e-5, rtol=0)


def test_bwd_form_takes_fft_at_powers_of_two():
    assert [torus.form(d) for d in (16, 256, 4096)] == ["fft"] * 3
    assert [torus.form(d) for d in (5, 40, 513)] == ["table"] * 3


def _fft_header_constants():
    """The ``constexpr int`` constants of csrc/torus_fft.cuh (the FFT
    forms' threads) beside those of csrc/torus_basis.cuh."""
    text = (pathlib.Path(torus.__file__).parents[1] / "csrc"
            / "torus_fft.cuh").read_text()
    consts = _header_constants()
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", text,
                                 re.M):
        consts[name] = eval(expr, {}, consts)
    return consts


def _wide_threads(R, d, resident, k):
    """torus_fft.cuh::fft_wide_threads: one thread per angle pair, up to
    kFftRowThreads a row, halved (down to no fewer than the passes' d/16)
    where R rows of them are more than the card keeps resident."""
    most = max(1, min(d // 2, k["kFftRowThreads"]))
    if R * most > resident and most // 2 >= max(1, d // 16):
        return most // 2
    return most


@pytest.mark.parametrize("d", [2, 16, 256, 4096])
@pytest.mark.parametrize("R", [1, 1 << 20])
def test_fft_form_rows_fit_shared_memory(d, R):
    """The FFT forms of D, E and F (fft_wide_*), at either thread count a
    row: a block of at least kFftMinBlock threads and whole rows; the
    row's d/16 FFT threads are among them; the block's two padded buffers
    a row (fft_pitch points of 8 bytes) fit what a block can opt in to,
    up to the largest d."""
    k = _fft_header_constants()
    assert k["kFftRowThreads"] == 1024 and k["kFftMinBlock"] == 256
    row = _wide_threads(R, d, 132 * k["kFftSmThreads"], k)
    block = max(row, k["kFftMinBlock"])
    assert block % row == 0 and block <= 1024  # the launch bound
    assert max(1, d // 16) <= row
    pitch = d + (d // 16 if d >= 16 else 1)
    assert 8 * 2 * (block // row) * pitch <= k["kTorusMaxSmem"]
    assert d <= k["kTorusMaxDim"]


@pytest.mark.parametrize("R,d,want", [
    (16384, 256, 64), (256, 4096, 512), (200, 4096, 512), (64, 4096, 1024),
    (4096, 16, 8), (16384, 8, 4), (128, 256, 128), (256, 128, 64)])
def test_fft_form_halves_a_rows_threads_past_the_resident(R, d, want):
    """On an H100 (132 multiprocessors of kFftSmThreads resident threads)
    the shapes of the port's paths take these threads a row: half as many
    where R rows of one thread a pair would not all be resident."""
    k = _fft_header_constants()
    assert k["kFftSmThreads"] == 1024
    assert _wide_threads(R, d, 132 * k["kFftSmThreads"], k) == want
