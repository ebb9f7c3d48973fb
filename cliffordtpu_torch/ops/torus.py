"""Clifford-torus embedding as an exact real DFT (port of
``cliffordtpu/ops/torus.py``).

d phase angles embed in R^{2d} as

    x_j = c_j + sum_{k=1}^{d-1} cos(th_k) C[k, j] + sin(th_k) S[k, j]

with n = 2d, C[k, j] = (2/n) cos(2 pi k j / n), S[k, j] = -(2/n)
sin(2 pi k j / n) and c_j = (1 + (-1)^j) / n.  Angle index 0 is pinned to
phase 0: only the d-1 angles 1..d-1 enter.

``angles_to_torus`` (``method="auto"``) is two matrix products against the
materialised bases (``angles_to_torus_matmul``) up to ``MATMUL_MAX_DIM``,
except for CUDA tensors with ``KERNEL_MIN_DIM <= d <= MATMUL_MAX_DIM``,
where the bases would be 2 x 134 MB at d = 4096: those go through the
hand-written embedding kernel and its backward kernel
(``kernels/torus.py::torus_embed``), as the JAX package routes the same
range to its fused TPU kernel.  Above ``MATMUL_MAX_DIM`` both directions
are a ``torch.fft`` transform of the Hermitian spectrum, as the JAX
package computes them with ``jnp.fft`` in XLA; ``method="matmul"`` or
``"fft"`` takes one form at any d.  The fused sampler kernels
(``kernels/sampler.py``) build the same basis in their own bodies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# above this latent dim "auto" takes the FFT form (the basis pair passes
# 268 MB at d = 4096)
MATMUL_MAX_DIM = 4096
# from this latent dim up to MATMUL_MAX_DIM a CUDA tensor is embedded by
# the hand-written kernel (the JAX package's PALLAS_MIN_DIM)
KERNEL_MIN_DIM = 2048
# up to this dim the bases are host float64 -> float32 constants; above
# it they are made on the device from int32 (k*j) mod n phases
HOST_CONST_MAX_DIM = 512


@functools.lru_cache(maxsize=32)
def _torus_bases_host(d: int):
    n = 2 * d
    k = np.arange(1, d, dtype=np.float64)
    j = np.arange(n, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(k, j) / n
    cos_b = (2.0 / n) * np.cos(phase)
    sin_b = -(2.0 / n) * np.sin(phase)
    const = (1.0 + np.cos(np.pi * j)) / n
    return (cos_b.astype(np.float32), sin_b.astype(np.float32),
            const.astype(np.float32))


def _torus_bases_device(d: int, device):
    """The bases from int32 phases: (k*j) reaches 33.5M at d = 4096,
    beyond float32's exact integers, while (k*j) mod n is always exact."""
    n = 2 * d
    k = torch.arange(1, d, dtype=torch.int32, device=device)
    j = torch.arange(n, dtype=torch.int32, device=device)
    kj = (k[:, None] * j[None, :]) % n
    phase = kj.to(torch.float32) * torch.tensor(
        2.0 * np.pi / n, dtype=torch.float32)
    cos_b = (2.0 / n) * torch.cos(phase)
    sin_b = -(2.0 / n) * torch.sin(phase)
    const = (1.0 + torch.cos(np.pi * j.to(torch.float32))) / n
    return cos_b, sin_b, const


def torus_bases(d: int, device=None):
    """(C, S, c): (d-1, 2d), (d-1, 2d), (2d,) float32 on ``device``."""
    if d > HOST_CONST_MAX_DIM:
        return _torus_bases_device(d, device)
    return tuple(torch.from_numpy(b).to(device) for b in _torus_bases_host(d))


@functools.lru_cache(maxsize=32)
def _fft_bases_host(d: int):
    n = 2 * d
    j = np.arange(n, dtype=np.float64)
    k = np.arange(d, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(j, k) / n
    return np.cos(phase).astype(np.float32), -np.sin(phase).astype(np.float32)


def _fft_bases(d: int, device):
    if d > HOST_CONST_MAX_DIM:
        n = 2 * d
        j = torch.arange(n, dtype=torch.int32, device=device)
        k = torch.arange(d, dtype=torch.int32, device=device)
        phase = ((j[:, None] * k[None, :]) % n).to(torch.float32) * \
            torch.tensor(2.0 * np.pi / n, dtype=torch.float32)
        return torch.cos(phase), -torch.sin(phase)
    return tuple(torch.from_numpy(b).to(device) for b in _fft_bases_host(d))


METHODS = ("auto", "matmul", "fft")


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def angles_to_torus_matmul(angles: torch.Tensor) -> torch.Tensor:
    """Embed d angles (..., d) onto the Clifford torus in R^{2d} as two
    matrix products against the bases, on any device."""
    d = angles.shape[-1]
    cos_b, sin_b, const = (b.to(angles.dtype)
                           for b in torus_bases(d, angles.device))
    th = angles[..., 1:]
    return torch.cos(th) @ cos_b + torch.sin(th) @ sin_b + const


def uses_kernel(device_type: str, d: int) -> bool:
    """Whether ``angles_to_torus`` embeds d angles on this device through
    the hand-written kernel."""
    return device_type == "cuda" and KERNEL_MIN_DIM <= d <= MATMUL_MAX_DIM


def angles_to_torus_fft(angles: torch.Tensor) -> torch.Tensor:
    """Embed d angles (..., d) as the real part of the inverse FFT of the
    Hermitian spectrum [0, th_1..th_{d-1}, 0, -th_{d-1}..-th_1] of phases,
    in complex64."""
    th = angles[..., 1:]
    zero = torch.zeros_like(angles[..., :1])
    theta_s = torch.cat([zero, th, zero, -torch.flip(th, (-1,))], -1)
    spectrum = torch.polar(torch.ones_like(theta_s, dtype=torch.float32),
                           theta_s.float())
    return torch.fft.ifft(spectrum, dim=-1).real.to(angles.dtype)


def angles_to_torus(angles: torch.Tensor, method: str = "auto"
                    ) -> torch.Tensor:
    """Embed d angles (..., d) onto the Clifford torus in R^{2d}.
    ``"auto"``: through the embedding kernel for a CUDA tensor of a large
    latent, as matrix products up to ``MATMUL_MAX_DIM``, as an FFT above
    (see the module docstring)."""
    _check_method(method)
    d = angles.shape[-1]
    if method == "auto" and not uses_kernel(angles.device.type, d):
        method = "matmul" if d <= MATMUL_MAX_DIM else "fft"
    if method == "matmul":
        return angles_to_torus_matmul(angles)
    if method == "fft":
        return angles_to_torus_fft(angles)
    from cliffordtpu_torch.kernels import torus as torus_kernel

    theta = angles.reshape(-1, d)[:, 1:].float()
    x = torus_kernel.torus_embed(theta)
    return x.reshape(*angles.shape[:-1], 2 * d).to(angles.dtype)


def torus_to_angles(x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Recover d angles from a torus point (..., 2d): ``angle(fft(x)[:d])``,
    as matrix products up to ``MATMUL_MAX_DIM`` (``"auto"``), as an FFT
    above."""
    _check_method(method)
    d = x.shape[-1] // 2
    if method == "fft" or (method == "auto" and d > MATMUL_MAX_DIM):
        freq = torch.fft.fft(x.to(torch.complex64), dim=-1)[..., :d]
        return torch.angle(freq).to(x.dtype)
    cos_b, sin_b = (b.to(x.dtype) for b in _fft_bases(d, x.device))
    return torch.atan2(x @ sin_b, x @ cos_b)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))
