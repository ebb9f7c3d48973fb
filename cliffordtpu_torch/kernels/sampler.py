"""Fused Clifford-torus sampler + embedding: the port of
``cliffordtpu/kernels/sampler_pallas.py::sample_torus_fused_keyed`` and
``sample_torus_fused``, and of their custom VJP.

``sample_embed_keyed`` launches ``csrc/sampler_keyed.cu`` for CUDA tensors
and runs ``sample_embed_keyed_plain`` for CPU tensors; any other device
raises.  Both draw the same threefry stream as ``jax.random`` (see
``cliffordtpu_torch/random.py``), so u and v agree bit for bit.  Its kernel
draws in front of the torus forward's FFT form for a power-of-two d and
keeps the table form otherwise (``torus.form``).

``sample_embed_rng`` launches ``csrc/sampler_rng.cu`` and runs
``sample_embed_rng_plain`` alike.  Where the TPU kernel draws from its
core's hardware generator, these draw Philox-4x32-10 words keyed by the
caller's key folded with ``RNG_FOLD`` (the TPU package's seed words) and
counted by the flat element index: a different stream from ``jax.random``
by design, the same in the kernel and in the plain version bit for bit,
and independent of how the launch is tiled.  Its kernel takes the same
forms.

When ``loc`` or ``kappa`` needs a gradient, either CUDA path is a
``torch.autograd.Function`` whose backward is one launch of
``csrc/torus_bwd.cu`` with the concentration epilogue
(``kernels/torus.py::sampler_bwd``); on the CPU autograd differentiates
the plain versions.  Launches count in ``launches`` (keyed) and
``rng_launches``.

Both take ``rows=(row0, n_rows)``: ``loc``'s R rows are rows row0.. of a
global draw of n_rows rows, and the kernels count (row0 + r) * d + k, so
a rank of a data-parallel step draws exactly its rows of the global draw,
bit for bit, as the plain versions do (``random.counters``).  The 2**32
limit of the counter word holds for the global R * d.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.kernels import build, torus
from cliffordtpu_torch.ops.torus import (
    MATMUL_MAX_DIM,
    angles_to_torus_matmul,
)

# kernel launches since the counts were last set to 0
launches = 0  # csrc/sampler_keyed.cu
rng_launches = 0  # csrc/sampler_rng.cu

U_MIN = 1e-12  # the sampler's minval for u (clifford_torus.py:172)
PS_EPS = torus.PS_EPS  # power_spherical.py _EPS
RNG_FOLD = 0x7A11A5  # sampler_pallas.py::sample_torus_fused's fold_in data


def circle_angles(loc, kappa, u, v) -> torch.Tensor:
    """The closed-form PowerSpherical circle sampler (Bailey's polar
    Student-t form): theta = loc + 2 atan(cos(2 pi v) sqrt(expm1(-(2/nu)
    ln u))), nu = 2 (kappa + eps) + 1."""
    nu = 2.0 * (kappa + PS_EPS) + 1.0
    w = torch.expm1(torch.tensor(-2.0, dtype=nu.dtype, device=nu.device)
                    / nu * torch.log(u))
    return loc + 2.0 * torch.atan(
        torch.cos((2.0 * math.pi) * v) * torch.sqrt(w)).to(loc.dtype)


def sample_embed_keyed_plain(key, loc: torch.Tensor, kappa: torch.Tensor,
                             rows: random.Rows = None):
    """The plain PyTorch version: ``random.uniform`` draws on the split key,
    ``circle_angles``, then ``ops.torus.angles_to_torus_matmul``.  Returns
    (x (R, 2d), theta, u, v (R, d-1))."""
    R, d = loc.shape
    k_u, k_v = random.split(key)
    u = random.uniform(k_u, (R, d), minval=U_MIN, device=loc.device,
                       rows=rows)
    v = random.uniform(k_v, (R, d), device=loc.device, rows=rows)
    theta = circle_angles(loc, kappa, u, v)
    return angles_to_torus_matmul(theta), theta[:, 1:], u[:, 1:], v[:, 1:]


def rng_seed_words(key):
    """The two Philox key words of a caller's key: ``jax.random.fold_in(key,
    RNG_FOLD)``, the words the TPU package seeds its generator with."""
    return random.fold_in_words(key, RNG_FOLD)


def rng_uniforms(seed, R: int, d: int, device=None, rows: random.Rows = None):
    """(u, v), both (R, d): the uniforms of ``csrc/sampler_rng.cu`` from
    integer tensor operations.  Element (r, k) takes words 0 and 1 of
    ``philox4x32(counter=((row0 + r)*d + k, 0, 0, 0), key=seed)``, row0 0
    without ``rows``; u = max(f(word 0), U_MIN) and v = f(word 1), f the
    mantissa float."""
    q = random.counters((R, d), device, rows)
    w0, w1, _, _ = random.philox4x32(seed, (q, 0, 0, 0))
    u = torch.clamp(random.uniform_from_bits(w0), min=U_MIN)
    return u.reshape(R, d), random.uniform_from_bits(w1).reshape(R, d)


def sample_embed_rng_plain(key, loc: torch.Tensor, kappa: torch.Tensor,
                           rows: random.Rows = None):
    """The plain PyTorch version of the Philox sampler + embedding: the same
    words as the kernel draws, ``circle_angles``, then
    ``ops.torus.angles_to_torus_matmul``.  Returns (x (R, 2d), theta, u, v
    (R, d-1))."""
    R, d = loc.shape
    u, v = rng_uniforms(rng_seed_words(key), R, d, loc.device, rows)
    theta = circle_angles(loc, kappa, u, v)
    return angles_to_torus_matmul(theta), theta[:, 1:], u[:, 1:], v[:, 1:]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("sampler_keyed").keyed_sample_embed
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_uint32] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rng_kernel():
    fn = build.library("sampler_rng").rng_sample_embed
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_uint32] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _outputs(loc):
    """x, theta, u, v for a launch; the FFT form stores x as float4."""
    R, d = loc.shape
    x = torch.empty((R, 2 * d), dtype=torch.float32, device=loc.device)
    if x.data_ptr() % 16:
        raise ValueError("the sampler kernels store x 16-byte aligned")
    theta, u, v = (torch.empty((R, d - 1), dtype=torch.float32,
                               device=loc.device) for _ in range(3))
    return x, theta, u, v


def _launch(key, loc, kap, row0=0):
    global launches
    R, d = loc.shape
    ku, kv = random.split_words(key)
    x, theta, u, v = _outputs(loc)
    with torch.cuda.device(loc.device):
        rc = _kernel()(loc.data_ptr(), kap.data_ptr(), *kap.stride(),
                       x.data_ptr(), theta.data_ptr(), u.data_ptr(),
                       v.data_ptr(), R, d, row0, *ku, *kv,
                       torch.cuda.current_stream(loc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"keyed_sample_embed kernel failed: CUDA error {rc}")
    launches += 1
    return x, theta, u, v


def _launch_rng(key, loc, kap, row0=0):
    global rng_launches
    R, d = loc.shape
    x, theta, u, v = _outputs(loc)
    with torch.cuda.device(loc.device):
        rc = _rng_kernel()(loc.data_ptr(), kap.data_ptr(), *kap.stride(),
                           x.data_ptr(), theta.data_ptr(), u.data_ptr(),
                           v.data_ptr(), R, d, row0, *rng_seed_words(key),
                           torch.cuda.current_stream(loc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rng_sample_embed kernel failed: CUDA error {rc}")
    rng_launches += 1
    return x, theta, u, v


def _forward(ctx, launch, key, loc, kap, row0):
    """A forward kernel, saving theta, u, v and kappa for the backward."""
    x, theta, u, v = launch(key, loc, kap, row0)
    ctx.save_for_backward(theta, u, v, kap)
    ctx.mark_non_differentiable(theta, u, v)
    return x, theta, u, v


def _backward(ctx, g):
    """The torus backward kernel with the concentration epilogue."""
    theta, u, v, kap = ctx.saved_tensors
    d_loc, d_kappa = torus.sampler_bwd(theta, u, v, kap, g)
    return None, d_loc, d_kappa, None


class _SampleEmbedKeyed(torch.autograd.Function):
    """The keyed kernel and its backward."""

    @staticmethod
    def forward(ctx, key, loc, kap, row0=0):
        return _forward(ctx, _launch, key, loc, kap, row0)

    @staticmethod
    def backward(ctx, g, *_):
        return _backward(ctx, g)


class _SampleEmbedRng(torch.autograd.Function):
    """The Philox kernel and its backward (the keyed kernel's)."""

    @staticmethod
    def forward(ctx, key, loc, kap, row0=0):
        return _forward(ctx, _launch_rng, key, loc, kap, row0)

    @staticmethod
    def backward(ctx, g, *_):
        return _backward(ctx, g)


def _on_card(name, function, launch, key, loc, kappa, rows):
    """Check the arguments of a CUDA call and launch, through the autograd
    function when a gradient is needed."""
    if loc.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {loc.device}")
    if loc.dim() != 2 or loc.dtype != torch.float32:
        raise ValueError(f"loc must be float32 (R, d), got "
                         f"{tuple(loc.shape)} {loc.dtype}")
    R, d = loc.shape
    if not 2 <= d <= MATMUL_MAX_DIM:
        raise ValueError(f"d={d} outside [2, {MATMUL_MAX_DIM}]")
    row0, total = (0, R) if rows is None else (int(rows[0]), int(rows[1]))
    if row0 < 0 or row0 + R > total:
        raise ValueError(f"rows {row0}..{row0 + R} outside a draw of "
                         f"{total} rows")
    if total * d >= 2 ** 32:
        raise ValueError("the global R*d must stay below 2**32 (one counter "
                         "word)")
    if kappa.dtype != torch.float32 or kappa.device != loc.device:
        raise ValueError(f"kappa must be float32 on {loc.device}")
    # read in place at its strides: a per-row kappa expanded over the
    # angles (stride 0) costs no copy
    kap = torch.broadcast_to(kappa, (R, d))
    loc = loc.contiguous()
    if torch.is_grad_enabled() and (loc.requires_grad or kap.requires_grad):
        return function.apply(key, loc, kap, row0)
    return launch(key, loc, kap, row0)


def sample_embed_keyed(key, loc: torch.Tensor, kappa: torch.Tensor,
                       rows: random.Rows = None):
    """Sample theta ~ CliffordPowerSpherical(loc, kappa) with the keyed
    threefry stream and embed it on the torus.

    ``key``: two uint32 words (see ``random.key_words``); ``loc`` (R, d)
    float32; ``kappa`` float32 broadcastable to (R, d).  Returns
    (x (R, 2d), theta, u, v (R, d-1)), angles 1..d-1 (angle 0 is pinned).
    x is differentiable in ``loc`` and ``kappa``.  ``rows=(row0, n_rows)``:
    the R rows are rows row0.. of a global draw of n_rows (the module
    docstring).
    """
    if loc.device.type == "cpu":
        return sample_embed_keyed_plain(key, loc, kappa, rows)
    return _on_card("sample_embed_keyed", _SampleEmbedKeyed, _launch, key,
                    loc, kappa, rows)


def sample_embed_rng(key, loc: torch.Tensor, kappa: torch.Tensor,
                     rows: random.Rows = None):
    """As ``sample_embed_keyed`` on the Philox stream of ``key`` (see the
    module docstring): one launch draws, samples and embeds."""
    if loc.device.type == "cpu":
        return sample_embed_rng_plain(key, loc, kappa, rows)
    return _on_card("sample_embed_rng", _SampleEmbedRng, _launch_rng, key,
                    loc, kappa, rows)
