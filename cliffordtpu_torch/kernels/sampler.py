"""Keyed fused Clifford-torus sampler + embedding: the port of
``cliffordtpu/kernels/sampler_pallas.py::sample_torus_fused_keyed`` and of
its custom VJP.

``sample_embed_keyed`` launches ``csrc/sampler_keyed.cu`` for CUDA tensors
and runs ``sample_embed_keyed_plain`` for CPU tensors; any other device
raises.  Both draw the same threefry stream as ``jax.random`` (see
``cliffordtpu_torch/random.py``), so u and v agree bit for bit.  When
``loc`` or ``kappa`` needs a gradient, the CUDA path is a
``torch.autograd.Function`` whose backward is one launch of
``csrc/torus_bwd.cu`` with the concentration epilogue
(``kernels/torus.py::sampler_bwd``); on the CPU autograd differentiates
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.kernels import build, torus
from cliffordtpu_torch.ops.torus import MATMUL_MAX_DIM, angles_to_torus

# kernel launches since the count was last set to 0
launches = 0

U_MIN = 1e-12  # the sampler's minval for u (clifford_torus.py:172)
PS_EPS = torus.PS_EPS  # power_spherical.py _EPS
_SMEM_FLOATS = 12288  # 48 KB: cos and sin theta of one block's rows


def circle_angles(loc, kappa, u, v) -> torch.Tensor:
    """The closed-form PowerSpherical circle sampler (Bailey's polar
    Student-t form): theta = loc + 2 atan(cos(2 pi v) sqrt(expm1(-(2/nu)
    ln u))), nu = 2 (kappa + eps) + 1."""
    nu = 2.0 * (kappa + PS_EPS) + 1.0
    w = torch.expm1(torch.tensor(-2.0, dtype=nu.dtype, device=nu.device)
                    / nu * torch.log(u))
    return loc + 2.0 * torch.atan(
        torch.cos((2.0 * math.pi) * v) * torch.sqrt(w)).to(loc.dtype)


def sample_embed_keyed_plain(key, loc: torch.Tensor, kappa: torch.Tensor):
    """The plain PyTorch version: ``random.uniform`` draws on the split key,
    ``circle_angles``, then ``ops.torus.angles_to_torus``.  Returns
    (x (R, 2d), theta, u, v (R, d-1))."""
    R, d = loc.shape
    k_u, k_v = random.split(key)
    u = random.uniform(k_u, (R, d), minval=U_MIN, device=loc.device)
    v = random.uniform(k_v, (R, d), device=loc.device)
    theta = circle_angles(loc, kappa, u, v)
    return angles_to_torus(theta), theta[:, 1:], u[:, 1:], v[:, 1:]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("sampler_keyed").keyed_sample_embed
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_uint32] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rows_per_block(d: int) -> int:
    """Rows one block samples: about 1024 outputs (4 per thread) and at
    most 32 rows, so that large d still spreads over many blocks; cos and
    sin theta of the rows stay within 48 KB of shared memory."""
    return max(1, min(32, 1024 // (2 * d), _SMEM_FLOATS // (2 * (d - 1))))


def _launch(key, loc, kap):
    global launches
    R, d = loc.shape
    ku, kv = random.split_words(key)
    x = torch.empty((R, 2 * d), dtype=torch.float32, device=loc.device)
    theta, u, v = (torch.empty((R, d - 1), dtype=torch.float32,
                               device=loc.device) for _ in range(3))
    with torch.cuda.device(loc.device):
        rc = _kernel()(loc.data_ptr(), kap.data_ptr(), *kap.stride(),
                       x.data_ptr(), theta.data_ptr(), u.data_ptr(),
                       v.data_ptr(), R, d, rows_per_block(d), *ku, *kv,
                       torch.cuda.current_stream(loc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"keyed_sample_embed kernel failed: CUDA error {rc}")
    launches += 1
    return x, theta, u, v


class _SampleEmbedKeyed(torch.autograd.Function):
    """Forward kernel, saving theta, u, v and kappa; the backward is the
    torus backward kernel with the concentration epilogue."""

    @staticmethod
    def forward(ctx, key, loc, kap):
        x, theta, u, v = _launch(key, loc, kap)
        ctx.save_for_backward(theta, u, v, kap)
        ctx.mark_non_differentiable(theta, u, v)
        return x, theta, u, v

    @staticmethod
    def backward(ctx, g, *_):
        theta, u, v, kap = ctx.saved_tensors
        d_loc, d_kappa = torus.sampler_bwd(theta, u, v, kap, g)
        return None, d_loc, d_kappa


def sample_embed_keyed(key, loc: torch.Tensor, kappa: torch.Tensor):
    """Sample theta ~ CliffordPowerSpherical(loc, kappa) with the keyed
    threefry stream and embed it on the torus.

    ``key``: two uint32 words (see ``random.key_words``); ``loc`` (R, d)
    float32; ``kappa`` float32 broadcastable to (R, d).  Returns
    (x (R, 2d), theta, u, v (R, d-1)), angles 1..d-1 (angle 0 is pinned).
    x is differentiable in ``loc`` and ``kappa``.
    """
    if loc.device.type == "cpu":
        return sample_embed_keyed_plain(key, loc, kappa)
    if loc.device.type != "cuda":
        raise ValueError(f"sample_embed_keyed runs on cuda or cpu, not "
                         f"{loc.device}")
    if loc.dim() != 2 or loc.dtype != torch.float32:
        raise ValueError(f"loc must be float32 (R, d), got "
                         f"{tuple(loc.shape)} {loc.dtype}")
    R, d = loc.shape
    if not 2 <= d <= MATMUL_MAX_DIM:
        raise ValueError(f"d={d} outside [2, {MATMUL_MAX_DIM}]")
    if R * d >= 2 ** 32:
        raise ValueError("R*d must stay below 2**32 (one counter word)")
    if kappa.dtype != torch.float32 or kappa.device != loc.device:
        raise ValueError(f"kappa must be float32 on {loc.device}")
    # read in place at its strides: a per-token kappa expanded over the
    # angles (stride 0) costs no copy
    kap = torch.broadcast_to(kappa, (R, d))
    loc = loc.contiguous()
    if torch.is_grad_enabled() and (loc.requires_grad or kap.requires_grad):
        return _SampleEmbedKeyed.apply(key, loc, kap)
    return _launch(key, loc, kap)
