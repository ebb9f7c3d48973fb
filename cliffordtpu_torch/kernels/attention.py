"""Fused RoPE + attention, forward and backward: the port of
``cliffordtpu/kernels/attention_pallas.py::fused_attention`` and of its
custom VJP (``_attn_bwd``).

``fused_attention`` runs ``attention_plain`` for CPU tensors; any device
other than CUDA or the CPU raises.  For CUDA tensors it takes one of two
routes, chosen before anything runs from the shape, the dtype and whether
a gradient is needed (``kernel_fits``):

* the kernels: ``csrc/attention_fwd.cu``, and under autograd a
  ``torch.autograd.Function`` whose backward launches
  ``csrc/attention_bwd.cu``;
* the dense route, ``attention_dense``, for the shapes no kernel form can
  hold (a head_dim outside the forms, or a sequence whose blocks exceed
  the shared memory, such as S 260 at ``default_config(256)``): the
  rotation, then ``scaled_dot_product_attention``, differentiated by
  autograd.  It is the counterpart of the JAX package's XLA branch
  (``cliffordtpu/nn/vit_vae.py::Attention``), which takes every shape
  outside ``attention_supported``; it is not a port of either kernel.

The route is a property of the shape, not a fallback: a kernel that fails
on a shape ``kernel_fits`` accepts raises, and under autograd one route
serves both directions.  ``dense_calls`` counts the dense route.

Each kernel has one form per dtype (``fwd_form``, ``bwd_form``): bfloat16
runs on the tensor cores (``mma.sync``, head_dim 16, 32, 64 or 128),
float32 on the CUDA cores with register tiles (head_dim a multiple of 8).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cliffordtpu_torch.kernels import build
from cliffordtpu_torch.nn.rope import apply_rotary_half

# kernel launches since the counts were last set to 0
launches = 0  # forward kernel
bwd_launches = 0  # backward kernel
dense_calls = 0  # fused_attention calls on CUDA that took attention_dense

_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_SYMBOLS = {torch.float32: "attention_fwd_f32",
            torch.bfloat16: "attention_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "attention_bwd_f32",
                torch.bfloat16: "attention_bwd_bf16"}


def attention_plain(q, k, v, cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: rotate, then softmax(q k^T / sqrt(hd)) v,
    all in float32; returns q's dtype."""
    hd = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    if cos is not None:
        qf = apply_rotary_half(qf, cos.float(), sin.float())
        kf = apply_rotary_half(kf, cos.float(), sin.float())
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / math.sqrt(hd))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def attention_bwd_plain(q, k, v, cos: Optional[torch.Tensor],
                        sin: Optional[torch.Tensor], d_out):
    """The plain PyTorch version of the backward kernel, written out step
    by step in float32 as ``attention_pallas.py::_bwd_kernel`` does:
    recompute P, dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)) scale,
    dQr = dS Kr, dKr = dS^T Qr, then the inverse rotation of dQr and dKr.
    Returns (dq, dk, dv) in q's dtype."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qr, kr, vf, do = q.float(), k.float(), v.float(), d_out.float()
    if cos is not None:
        qr = apply_rotary_half(qr, cos.float(), sin.float())
        kr = apply_rotary_half(kr, cos.float(), sin.float())
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qr)
    if cos is not None:  # rot^T = rot(-angle)
        dq = apply_rotary_half(dq, cos.float(), -sin.float())
        dk = apply_rotary_half(dk, cos.float(), -sin.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def smem_bytes(S: int, hd: int, dtype=torch.float32) -> int:
    """Shared memory of one forward block.  float32: q and k (rows of
    hd + 4), v, and the probabilities (rows of Sp + 4), Sp = S rounded up
    to 4; bfloat16: q, k and v in rows of hd + 8, S rounded up to 16."""
    if dtype == torch.bfloat16:
        return 2 * 3 * _round_up(S, 16) * (hd + 8)
    Sp = _round_up(S, 4)
    return 4 * Sp * (2 * (hd + 4) + hd + Sp + 4)


def fwd_form(dtype) -> str:
    """Which form of the forward kernel a dtype takes: ``"mma"`` (tensor
    cores) for bfloat16, ``"simt"`` (CUDA cores) for float32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def bwd_form(dtype) -> str:
    """Which form of the backward kernel a dtype takes, as ``fwd_form``."""
    return fwd_form(dtype)


def bwd_smem_bytes(S: int, hd: int, dtype=torch.float32) -> int:
    """Shared memory of one backward block: rotated q and k, v, dO, the
    probabilities P and dS.  float32: q, k, v, dO in rows of hd + 4, P and
    dS in rows of Sp + 4, Sp = S rounded up to 4; bfloat16: q, k, v, dO in
    rows of hd + 8 and P, dS in rows of Sk + 8, Sk = S rounded up to 16."""
    if dtype == torch.bfloat16:
        Sk = _round_up(S, 16)
        return 2 * (4 * Sk * (hd + 8) + 2 * Sk * (Sk + 8))
    Sp = _round_up(S, 4)
    return 4 * Sp * (4 * (hd + 4) + 2 * (Sp + 4))


@functools.lru_cache(maxsize=None)
def _bwd_kernel(dtype):
    fn = getattr(build.library("attention_bwd"), _BWD_SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    fn = getattr(build.library("attention_fwd"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_problem(S: int, hd: int, dtype, fwd: bool, bwd: bool
                    ) -> Optional[str]:
    """Why no kernel form holds this shape, or None when they do."""
    if dtype == torch.bfloat16 and hd not in (16, 32, 64, 128):
        return (f"the bfloat16 (mma) kernels take head_dim 16, 32, 64 or "
                f"128, got {hd}")
    if dtype == torch.float32 and hd % 8:
        return (f"the float32 (simt) kernels take head_dim a multiple of 8, "
                f"got {hd}")
    if fwd and smem_bytes(S, hd, dtype) > _SMEM_MAX:
        return (f"S={S}, hd={hd} needs {smem_bytes(S, hd, dtype)} bytes of "
                f"shared memory, above {_SMEM_MAX}")
    if bwd and bwd_smem_bytes(S, hd, dtype) > _SMEM_MAX:
        return (f"S={S}, hd={hd} needs {bwd_smem_bytes(S, hd, dtype)} bytes "
                f"of shared memory for the {bwd_form(dtype)} backward, above "
                f"{_SMEM_MAX}")
    return None


def kernel_fits(S: int, hd: int, dtype, backward: bool) -> bool:
    """Whether the forward kernel, and with ``backward`` also the backward
    kernel, hold a sequence of S tokens with heads of hd in ``dtype``."""
    return _kernel_problem(S, hd, dtype, True, backward) is None


def _check_inputs(q, k, v, cos, sin):
    """The input errors, whatever the route."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one (B, S, H, hd) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOLS:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    S, hd = q.shape[1], q.shape[3]
    if hd % 2 or hd < 2:
        raise ValueError(f"head_dim must be even, got {hd}")
    if (cos is None) != (sin is None):
        raise ValueError("pass both cos and sin, or neither")
    if cos is not None:
        for t in (cos, sin):
            if (t.dim() != 2 or t.shape[0] < S or t.shape[1] != hd // 2
                    or t.dtype != torch.float32 or t.device != q.device):
                raise ValueError(
                    f"cos/sin must be float32 (S' >= {S}, {hd // 2}) on "
                    f"{q.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def _check(q, k, v, cos, sin, fwd: bool = True, bwd: bool = False):
    """The input errors, then the kernels' own rules: a shape the kernels
    cannot hold raises here."""
    _check_inputs(q, k, v, cos, sin)
    problem = _kernel_problem(q.shape[1], q.shape[3], q.dtype, fwd, bwd)
    if problem:
        raise ValueError(problem)


def _check_aligned(*tensors):
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("the attention kernels move q, k, v, cos, sin and "
                         "the gradients 16 bytes at a time: they must be "
                         "16-byte aligned")


def _launch_fwd(q, k, v, cos, sin) -> torch.Tensor:
    global launches
    B, S, H, hd = q.shape
    _check_aligned(q, k, v, cos, sin)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(),
            out.data_ptr(), B, S, H, hd,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel failed: CUDA error {rc}")
    launches += 1
    return out


def _launch_bwd(q, k, v, cos, sin, d_out):
    global bwd_launches
    B, S, H, hd = q.shape
    _check_aligned(q, k, v, cos, sin, d_out)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        rc = _bwd_kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(),
            d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, hd, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_bwd kernel failed: CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward kernel, saving the unrotated q, k, v and the tables;
    backward kernel.  cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin):
        ctx.save_for_backward(q, k, v, cos, sin)
        return _launch_fwd(q, k, v, cos, sin)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, cos, sin = ctx.saved_tensors
        if d_out.dtype != q.dtype:
            raise ValueError(f"gradient is {d_out.dtype}, q is {q.dtype}")
        dq, dk, dv = _launch_bwd(q, k, v, cos, sin, d_out.contiguous())
        return dq, dk, dv, None, None


def fused_attention_bwd(q, k, v, cos: Optional[torch.Tensor],
                        sin: Optional[torch.Tensor], d_out):
    """(dq, dk, dv) of ``fused_attention`` for the output gradient
    ``d_out`` (B, S, H, hd): the backward kernel for CUDA tensors, its
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, cos, sin, d_out)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, cos, sin, fwd=False, bwd=True)
    if d_out.shape != q.shape or d_out.dtype != q.dtype \
            or d_out.device != q.device:
        raise ValueError("d_out must match q in shape, dtype and device")
    S = q.shape[1]
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    return _launch_bwd(q, k, v, cos, sin, d_out.contiguous())


def attention_dense(q, k, v, cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense route: ``apply_rotary_half`` on q and k, then
    ``scaled_dot_product_attention`` in (B, H, S, hd) layout, in q's dtype,
    as the JAX package's XLA branch rotates and then calls
    ``jax.nn.dot_product_attention``.  Differentiable by autograd."""
    if cos is not None:
        q = apply_rotary_half(q, cos, sin)
        k = apply_rotary_half(k, cos, sin)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)


def fused_attention(q, k, v, cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(rot(q) rot(k)^T / sqrt(hd)) v for q, k, v (B, S, H, hd) in
    float32 or bfloat16 and cos, sin (S' >= S, hd/2) float32, or None for
    no rotation.  Returns (B, S, H, hd) in q's dtype.  Differentiable in
    q, k and v.  On CUDA, the kernels where ``kernel_fits``, else
    ``attention_dense`` (see the module docstring)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _routed(q, k, v, cos, sin)


def _routed(q, k, v, cos, sin) -> torch.Tensor:
    """``fused_attention`` for CUDA tensors: the route is chosen from the
    shape, the dtype and whether a gradient is needed, before anything
    runs; under autograd it serves both directions."""
    global dense_calls
    _check_inputs(q, k, v, cos, sin)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    S = q.shape[1]
    if not kernel_fits(S, q.shape[3], q.dtype, backward=needs_grad):
        dense_calls += 1
        return attention_dense(q, k, v, cos, sin)
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    if needs_grad:
        return _FusedAttention.apply(q, k, v, cos, sin)
    return _launch_fwd(q, k, v, cos, sin)
