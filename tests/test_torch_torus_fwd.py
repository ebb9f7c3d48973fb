"""The port's torus embedding forward (cliffordtpu_torch/kernels/torus.py:
``torus_fwd_plain``, the plain version of csrc/torus_fwd.cu, and the
differentiable ``torus_embed``) against cliffordtpu/ops/torus.py, the
interpret-mode Pallas kernel (kernels/torus_pallas.py) and jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import torus_pallas as tp
from cliffordtpu.ops import torus as jax_torus
from cliffordtpu_torch.kernels import torus
from cliffordtpu_torch.ops import torus as ops_torus

torch.set_num_threads(1)

SHAPES = [(8, 16), (64, 32), (129, 8), (600, 4)]  # (d, rows)


def _angles(d, rows, seed):
    return np.random.default_rng(seed).uniform(
        0, 2 * np.pi, (rows, d)).astype(np.float32)


@pytest.mark.parametrize("d,rows", SHAPES)
def test_plain_forward_matches_jax_embedding(d, rows):
    angles = _angles(d, rows, d)
    want = np.asarray(jax_torus.angles_to_torus(jnp.asarray(angles)))
    got = torus.torus_fwd(torch.from_numpy(angles[:, 1:]))
    assert got.shape == (rows, 2 * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        ops_torus.angles_to_torus(torch.from_numpy(angles)).numpy(), want,
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("d,rows", SHAPES[:2])
def test_plain_forward_matches_interpret_kernel(d, rows):
    """``_torus_fused_fwd_impl`` on padded angles, as tests/test_kernels.py
    runs the TPU kernel on the CPU."""
    angles = _angles(d, rows, 100 + d)
    kp, rp = tp._round_up(d - 1, 8), tp._round_up(rows, 8)
    th_pad = jnp.zeros((rp, kp), jnp.float32).at[:rows, : d - 1].set(
        angles[:, 1:])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tp._torus_fused_fwd_impl(th_pad, d))
    got = torus.torus_fwd_plain(torch.from_numpy(angles[:, 1:])).numpy()
    np.testing.assert_allclose(got, want[:rows, : 2 * d], atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,rows", [(8, 16), (129, 8)])
def test_embedding_function_gradient_matches_jax_grad(d, rows):
    """Forward through ``torus_fwd``, backward through ``torus_bwd``, as the
    card differentiates the embedding; <= 1e-4 against jax.grad."""
    angles = _angles(d, rows, 200 + d)
    w = np.random.default_rng(d).normal(size=(rows, 2 * d)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_torus.angles_to_torus(a, method="matmul") * w))(
            jnp.asarray(angles)))
    theta = torch.from_numpy(angles[:, 1:].copy()).requires_grad_()
    x = torus.torus_embed(theta)
    assert x.grad_fn is not None and "TorusEmbed" in type(x.grad_fn).__name__
    (got,) = torch.autograd.grad(x, theta, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want[:, 1:], atol=1e-4, rtol=0)
    with torch.no_grad():
        assert torus.torus_embed(theta).grad_fn is None


def test_large_cuda_latents_route_to_the_kernel(monkeypatch):
    """2048 <= d <= 4096 on CUDA goes through ``torus_embed`` (the JAX
    package's PALLAS_MIN_DIM..MATMUL_MAX_DIM); every other d and the CPU
    keep the matmul form.  With the predicate forced, the route embeds the
    free angles of any leading shape and differentiates through the
    function; the pinned angle gets a zero gradient."""
    assert ops_torus.KERNEL_MIN_DIM == jax_torus.PALLAS_MIN_DIM == 2048
    assert ops_torus.MATMUL_MAX_DIM == jax_torus.MATMUL_MAX_DIM == 4096
    for dev, d, want in (("cuda", 2047, False), ("cuda", 2048, True),
                         ("cuda", 4096, True), ("cuda", 4097, False),
                         ("cpu", 2048, False), ("cpu", 4096, False)):
        assert ops_torus.uses_kernel(dev, d) is want
    d = 12
    angles = torch.from_numpy(_angles(d, 10, 3).reshape(2, 5, d))
    want = ops_torus.angles_to_torus(angles)
    calls = []
    real = torus.torus_embed
    monkeypatch.setattr(torus, "torus_embed",
                        lambda th: calls.append(th.shape) or real(th))
    monkeypatch.setattr(ops_torus, "uses_kernel", lambda dev, d_: True)
    angles.requires_grad_()
    got = ops_torus.angles_to_torus(angles)
    assert calls == [(10, d - 1)] and got.shape == (2, 5, 2 * d)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), angles)
    assert (g[..., 0] == 0).all() and g[..., 1:].abs().max() > 0


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = (torus.fwd_launches, torus.launches)
    theta = torch.zeros(4, 8, requires_grad=True)
    torus.torus_embed(theta).sum().backward()
    assert (torus.fwd_launches, torus.launches) == before
    with pytest.raises(ValueError):
        torus.torus_fwd(torch.zeros(4, 8, device="meta"))
    # above the kernel's range the FFT form runs, with no launch either
    assert ops_torus.angles_to_torus(torch.zeros(2, 4097)).shape == (2, 8194)
    assert (torus.fwd_launches, torus.launches) == before
    with pytest.raises(ValueError):
        ops_torus.angles_to_torus(torch.zeros(2, 8), method="pallas")


def _fft_packing(theta: torch.Tensor) -> torch.Tensor:
    """The FFT form of csrc/torus_fwd.cu written with torch.fft: the
    n = 2d point inverse real DFT of X = (1, e^{i theta}, 1) as one d-point
    complex inverse DFT of Z_k = A_k + i w_k B_k, A_k = X_k + conj X_{d-k},
    B_k = X_k - conj X_{d-k}, w_k = e^{i pi k / d}; x_{2m} = Re z_m / n,
    x_{2m+1} = Im z_m / n (z unnormalised)."""
    R, d = theta.shape[0], theta.shape[1] + 1
    zero = torch.zeros((R, 1), dtype=theta.dtype)
    X = torch.polar(torch.ones(R, d + 1, dtype=theta.dtype),
                    torch.cat([zero, theta, zero], 1))  # X_0 .. X_d
    k = torch.arange(d)
    Xr = X[:, d - k].conj()
    w = torch.polar(torch.ones(d, dtype=theta.dtype),
                    (torch.pi / d) * k.to(theta.dtype))
    Z = (X[:, :d] + Xr) + 1j * w * (X[:, :d] - Xr)
    z = torch.fft.ifft(Z, dim=1) * d / (2 * d)
    return torch.stack([z.real, z.imag], dim=2).reshape(R, 2 * d)


@pytest.mark.parametrize("d", [16, 256])
def test_fft_packing_matches_plain_and_jax_fft(d):
    """The index and scaling conventions of the kernel's FFT form: its
    packing equals ``torus_fwd_plain`` to 1e-6, and ``torus_fwd_plain``
    equals JAX's ``angles_to_torus(method="fft")`` to 1e-5."""
    angles = _angles(d, 6, 400 + d)
    theta = torch.from_numpy(angles[:, 1:])
    plain = torus.torus_fwd_plain(theta).numpy()
    np.testing.assert_allclose(_fft_packing(theta.double()).numpy(), plain,
                               atol=1e-6, rtol=0)
    want = np.asarray(jax_torus.angles_to_torus(jnp.asarray(angles),
                                                method="fft"))
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=0)


def _stockham_inverse(Z: np.ndarray) -> np.ndarray:
    """The pass schedule and index arithmetic of csrc/torus_fft.cuh in
    numpy: radix-16 Stockham passes while 16 divides what is left, then one
    of radix 8, 4 or 2; butterfly j reads src[j + r d/R], twiddles by
    exp(2 pi i (j mod Ns) r / (Ns R)), writes dst[(j - j mod Ns) R +
    j mod Ns + r Ns]."""
    d = Z.shape[-1]
    src, Ns, rem = Z, 1, d
    while rem > 1:
        R = 16 if rem >= 16 else rem
        j = np.arange(d // R)
        jm = j % Ns
        r = np.arange(R)
        v = src[:, j[:, None] + r[None, :] * (d // R)]
        v = v * np.exp(2j * np.pi * np.outer(jm, r) / (Ns * R))
        v = v @ np.exp(2j * np.pi * np.outer(r, r) / R)  # R-point inverse
        dst = np.empty_like(src)
        dst[:, ((j - jm) * R + jm)[:, None] + r[None, :] * Ns] = v
        src, Ns, rem = dst, Ns * R, rem // R
    return src


@pytest.mark.parametrize("d", [2, 8, 16, 32, 2048, 4096])
def test_fft_kernel_pass_schedule_is_the_inverse_dft(d):
    """The kernel's Stockham passes (one, or 16 x 2, or three of 16 ...)
    compute the unnormalised inverse DFT; and ``fwd_form`` routes exactly
    the powers of two to the FFT form."""
    Z = np.random.default_rng(d).normal(size=(2, d, 2)).view(
        np.complex128)[..., 0]
    np.testing.assert_allclose(_stockham_inverse(Z),
                               np.fft.ifft(Z, axis=1) * d, atol=1e-9)
    assert torus.fwd_form(d) == "fft"
    assert [torus.fwd_form(n) for n in (3, 513, 2047, 4095)] == ["table"] * 4
