"""HRR binding and bundling (port of ``cliffordtpu/vsa/ops.py``) on
``torch.fft``.

The JAX package also computes the transforms as real-DFT products
(``vsa/rdft.py``), because its TPU backend rejects complex dtypes; the
card has complex FFTs, so the port keeps the complex ``rfft`` form only.
Vectors lie along the last axis; keys are two uint32 words
(``random.key_words``).
"""

from __future__ import annotations

import math

import torch

from cliffordtpu_torch import random


def hrr_init(key, n: int, d: int, device=None) -> torch.Tensor:
    """n random item vectors, N(0, 1) / sqrt(d), from ``key``."""
    return random.normal(key, (n, d), device) / math.sqrt(d)


def unitary_init(key, n: int, d: int, eps: float = 1e-3,
                 device=None) -> torch.Tensor:
    """n vectors with unit Fourier magnitude: phases phi in +-pi(eps,
    1 - eps) at bins 1 .. (d-1)//2, 1 at bin 0 and (even d) at the
    Nyquist bin, then the inverse real FFT."""
    k_a, k_s = random.split_words(key)
    n_phases = (d - 1) // 2
    a = random.uniform(k_a, (n, n_phases), device=device)
    sign = torch.sign(random.uniform(k_s, (n, n_phases), device=device)
                      - 0.5)
    phi = sign * math.pi * (eps + a * (1 - 2 * eps))
    spec = torch.ones((n, d // 2 + 1), dtype=torch.complex64, device=device)
    spec[:, 1:n_phases + 1] = torch.complex(torch.cos(phi), torch.sin(phi))
    return torch.fft.irfft(spec, n=d, dim=-1)


def normalize_vectors(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def bind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution through the real FFT."""
    n = a.shape[-1]
    return torch.fft.irfft(torch.fft.rfft(a, dim=-1)
                           * torch.fft.rfft(b, dim=-1), n=n, dim=-1)


def invert(a: torch.Tensor) -> torch.Tensor:
    """The involution [a0, a_{n-1}, ..., a1]."""
    return torch.cat([a[..., :1], torch.flip(a[..., 1:], (-1,))], -1)


def unbind(ab: torch.Tensor, b: torch.Tensor,
           method: str = "inv") -> torch.Tensor:
    """"inv" / "*": bind(ab, invert(b)); "deconv" / "†" / "dagger":
    irfft(rfft(ab) / (rfft(b) + 1e-12)), the 1e-12 added to the real
    part as JAX adds it."""
    if method in ("inv", "*"):
        return bind(ab, invert(b))
    if method in ("†", "deconv", "dagger"):
        n = ab.shape[-1]
        return torch.fft.irfft(torch.fft.rfft(ab, dim=-1)
                               / (torch.fft.rfft(b, dim=-1) + 1e-12),
                               n=n, dim=-1)
    raise ValueError(f"unsupported unbind method: {method}")


def bundle(vectors: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Superposition: the sum over axis 0, / sqrt(k) with ``normalize``."""
    s = vectors.sum(0)
    return s / math.sqrt(vectors.shape[0]) if normalize else s


def permute_vector(v: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Braiding: v[..., perm]."""
    return v[..., perm]


def unpermute_vector(v: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse braiding, v[..., argsort(perm)]."""
    return v[..., torch.argsort(perm)]


def similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity along the last axis (norms clipped at 1e-8)."""
    a_n = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                          min=1e-8)
    b_n = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True),
                          min=1e-8)
    return (a_n * b_n).sum(-1)
