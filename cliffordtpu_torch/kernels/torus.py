"""Clifford-torus embedding, forward and backward: the port of
``cliffordtpu/kernels/torus_pallas.py`` (``angles_to_torus_fused`` with its
custom VJP ``_torus_fused_bwd``, which is also the d theta of the fused
samplers' custom VJP, ``cliffordtpu/kernels/sampler_pallas.py::
_sample_embed_bwd``).

``torus_fwd`` launches ``csrc/torus_fwd.cu`` for CUDA tensors and runs
``torus_fwd_plain`` for CPU tensors; ``torus_bwd`` does the same with
``csrc/torus_bwd.cu`` and ``torus_bwd_plain``; any other device raises.
``sampler_bwd`` is the backward launch with the samplers' concentration
gradient as its epilogue (plain version: ``sampler_bwd_plain``).
``torus_embed`` is the differentiable embedding (forward kernel, backward
kernel) that ``ops/torus.py::angles_to_torus`` routes large latents to.
The forward kernel computes a power-of-two d as an inverse real FFT in
shared memory and any other d as the dense product on a shared-memory
basis table (``fwd_form``).
Forward launches count in ``fwd_launches``, backward launches (with or
without the epilogue) in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cliffordtpu_torch.kernels import build
from cliffordtpu_torch.ops.torus import MATMUL_MAX_DIM, torus_bases

# kernel launches since the counts were last set to 0
fwd_launches = 0  # csrc/torus_fwd.cu
launches = 0  # csrc/torus_bwd.cu

PS_EPS = 1e-7  # power_spherical.py _EPS


def fwd_form(d: int) -> str:
    """Which form ``csrc/torus_fwd.cu`` takes for latent dim d: ``"fft"``
    for a power of two, else ``"table"`` (the kernel's own dispatch)."""
    return "fft" if d >= 2 and d & (d - 1) == 0 else "table"


def torus_fwd_plain(theta: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x = cos(theta) C + sin(theta) S + c for
    the free angles theta (R, d-1); x (R, 2d)."""
    d = theta.shape[-1] + 1
    cos_b, sin_b, const = (b.to(theta.dtype)
                           for b in torus_bases(d, theta.device))
    return torch.cos(theta) @ cos_b + torch.sin(theta) @ sin_b + const


def torus_bwd_plain(theta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: d theta = -sin(theta) (g C^T)
    + cos(theta) (g S^T) for theta (R, d-1), g (R, 2d)."""
    d = g.shape[-1] // 2
    cos_b, sin_b, _ = (b.to(g.dtype) for b in torus_bases(d, g.device))
    return (-torch.sin(theta) * (g @ cos_b.T)
            + torch.cos(theta) * (g @ sin_b.T))


def dtheta_dkappa(u, v, kappa) -> torch.Tensor:
    """d theta / d kappa of the closed-form circle sampler
    theta = loc + 2 atan(cos(2 pi v) sqrt(expm1(-(2/nu) ln u))),
    nu = 2 (kappa + eps) + 1, written as the TPU package's VJP writes it."""
    nu = 2.0 * (kappa + PS_EPS) + 1.0
    lnu = torch.log(u)
    w = torch.expm1((-2.0 / nu) * lnu)
    c = torch.cos((2.0 * math.pi) * v)
    sqw = torch.sqrt(torch.clamp(w, min=1e-30))
    dth_dnu = (2.0 * c / (1.0 + c * c * w)) * (1.0 / (2.0 * sqw)) * (
        (2.0 * lnu / (nu * nu)) * (1.0 + w))
    return dth_dnu * 2.0  # d nu / d kappa = 2


def sampler_bwd_plain(theta, u, v, kappa, g):
    """The plain PyTorch version of the keyed sampler's backward: theta, u,
    v (R, d-1) are the forward's residuals, kappa broadcasts to (R, d), g
    is the gradient of the embedding (R, 2d).  Returns (dloc, dkappa),
    both (R, d) with column 0 zero (angle 0 is pinned)."""
    R, m = theta.shape
    dth = torus_bwd_plain(theta, g)
    kap = torch.broadcast_to(kappa, (R, m + 1))[:, 1:]
    zero = torch.zeros((R, 1), dtype=dth.dtype, device=dth.device)
    return (torch.cat([zero, dth], dim=1),
            torch.cat([zero, dth * dtheta_dkappa(u, v, kap)], dim=1))


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    fn = build.library("torus_fwd").torus_fwd
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("torus_bwd").torus_bwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(theta, g):
    if theta.dim() != 2 or g.dim() != 2:
        raise ValueError(f"theta (R, d-1) and g (R, 2d) expected, got "
                         f"{tuple(theta.shape)}, {tuple(g.shape)}")
    R, m = theta.shape
    d = m + 1
    if g.shape != (R, 2 * d):
        raise ValueError(f"g must be ({R}, {2 * d}), got {tuple(g.shape)}")
    if not 2 <= d <= MATMUL_MAX_DIM:
        raise ValueError(f"d={d} outside [2, {MATMUL_MAX_DIM}]")
    for name, t in (("theta", theta), ("g", g)):
        if t.dtype != torch.float32 or t.device != theta.device:
            raise ValueError(f"{name} must be float32 on {theta.device}, "
                             f"got {t.dtype} on {t.device}")
    return R, d


def _launch(theta, g, d_theta, ld, off, u, v, kap, d_kappa):
    global launches
    R, d = theta.shape[0], theta.shape[1] + 1
    ks = (0, 0) if kap is None else kap.stride()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(theta.device):
        rc = _kernel()(theta.data_ptr(), g.data_ptr(), d_theta.data_ptr(),
                       ld, off, ptr(u), ptr(v), ptr(kap), *ks, ptr(d_kappa),
                       R, d,
                       torch.cuda.current_stream(theta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"torus_bwd kernel failed: CUDA error {rc}")
    launches += 1


def torus_fwd(theta: torch.Tensor) -> torch.Tensor:
    """The torus embedding x (R, 2d) of the free angles ``theta`` (R, d-1),
    float32 (angle 0 is pinned to phase 0 and is not passed)."""
    global fwd_launches
    if theta.device.type == "cpu":
        return torus_fwd_plain(theta)
    if theta.device.type != "cuda":
        raise ValueError(f"torus_fwd runs on cuda or cpu, not "
                         f"{theta.device}")
    if theta.dim() != 2 or theta.dtype != torch.float32:
        raise ValueError(f"theta must be float32 (R, d-1), got "
                         f"{tuple(theta.shape)} {theta.dtype}")
    R, d = theta.shape[0], theta.shape[1] + 1
    if not 2 <= d <= MATMUL_MAX_DIM:
        raise ValueError(f"d={d} outside [2, {MATMUL_MAX_DIM}]")
    theta = theta.contiguous()
    x = torch.empty((R, 2 * d), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        rc = _fwd_kernel()(
            theta.data_ptr(), x.data_ptr(), R, d,
            torch.cuda.current_stream(theta.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"torus_fwd kernel failed: CUDA error {rc}")
    fwd_launches += 1
    return x


def torus_bwd(theta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d theta (R, d-1) of the torus embedding of the free angles
    ``theta`` (R, d-1) for the output gradient ``g`` (R, 2d), float32."""
    if theta.device.type == "cpu":
        return torus_bwd_plain(theta, g)
    if theta.device.type != "cuda":
        raise ValueError(f"torus_bwd runs on cuda or cpu, not "
                         f"{theta.device}")
    R, d = _check(theta, g)
    d_theta = torch.empty(theta.shape, dtype=torch.float32,
                          device=theta.device)
    _launch(theta.contiguous(), g.contiguous(), d_theta, d - 1, 0,
            None, None, None, None)
    return d_theta


def sampler_bwd(theta, u, v, kappa, g):
    """(dloc, dkappa), both (R, d) with column 0 zero, of the keyed
    sampler + embedding: one launch of the torus backward kernel with the
    concentration epilogue.  ``kappa`` is float32 and broadcasts to (R, d);
    it is read at its strides."""
    if theta.device.type == "cpu":
        return sampler_bwd_plain(theta, u, v, kappa, g)
    if theta.device.type != "cuda":
        raise ValueError(f"sampler_bwd runs on cuda or cpu, not "
                         f"{theta.device}")
    R, d = _check(theta, g)
    for name, t in (("u", u), ("v", v)):
        if (t.shape != theta.shape or t.dtype != torch.float32
                or t.device != theta.device):
            raise ValueError(f"{name} must match theta in shape, dtype and "
                             f"device")
    if kappa.dtype != torch.float32 or kappa.device != theta.device:
        raise ValueError(f"kappa must be float32 on {theta.device}")
    kap = torch.broadcast_to(kappa, (R, d))
    d_loc = torch.empty((R, d), dtype=torch.float32, device=theta.device)
    d_kappa = torch.empty_like(d_loc)
    _launch(theta.contiguous(), g.contiguous(), d_loc, d, 1, u.contiguous(),
            v.contiguous(), kap, d_kappa)
    return d_loc, d_kappa


class _TorusEmbed(torch.autograd.Function):
    """Forward kernel on the free angles; the backward is the torus
    backward kernel without the epilogue."""

    @staticmethod
    def forward(ctx, theta):
        ctx.save_for_backward(theta)
        return torus_fwd(theta)

    @staticmethod
    def backward(ctx, g):
        (theta,) = ctx.saved_tensors
        return torus_bwd(theta, g)


def torus_embed(theta: torch.Tensor) -> torch.Tensor:
    """``torus_fwd``, differentiable in ``theta`` through ``torus_bwd``."""
    if torch.is_grad_enabled() and theta.requires_grad:
        return _TorusEmbed.apply(theta)
    return torus_fwd(theta)
