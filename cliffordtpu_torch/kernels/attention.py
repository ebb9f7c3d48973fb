"""Fused RoPE + attention, forward: the port of
``cliffordtpu/kernels/attention_pallas.py::fused_attention``.

``fused_attention`` launches ``csrc/attention_fwd.cu`` for CUDA tensors and
runs ``attention_plain`` for CPU tensors; any other device raises.  There
is no fallback from the kernel to the plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from cliffordtpu_torch.kernels import build
from cliffordtpu_torch.nn.rope import apply_rotary_half

# kernel launches since the count was last set to 0
launches = 0

_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_SYMBOLS = {torch.float32: "attention_fwd_f32",
            torch.bfloat16: "attention_fwd_bf16"}


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


def smem_bytes(S: int, hd: int) -> int:
    """Shared memory of one block: q, k (rows padded by one), v, scores."""
    return 4 * (2 * S * hd + S * (hd + 1) + S * S)


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    fn = getattr(build.library("attention_fwd"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, cos, sin):
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
    B, S, H, hd = q.shape
    if hd % 2 or hd < 2:
        raise ValueError(f"head_dim must be even, got {hd}")
    if smem_bytes(S, hd) > _SMEM_MAX:
        raise ValueError(f"S={S}, hd={hd} needs {smem_bytes(S, hd)} bytes of "
                         f"shared memory, above {_SMEM_MAX}")
    if (cos is None) != (sin is None):
        raise ValueError("pass both cos and sin, or neither")
    if cos is not None:
        for t in (cos, sin):
            if (t.dim() != 2 or t.shape[0] < S or t.shape[1] != hd // 2
                    or t.dtype != torch.float32 or t.device != q.device):
                raise ValueError(
                    f"cos/sin must be float32 (S' >= {S}, {hd // 2}) on "
                    f"{q.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def fused_attention(q, k, v, cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(rot(q) rot(k)^T / sqrt(hd)) v for q, k, v (B, S, H, hd) in
    float32 or bfloat16 and cos, sin (S' >= S, hd/2) float32, or None for
    no rotation.  Returns (B, S, H, hd) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return attention_plain(q, k, v, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, cos, sin)
    B, S, H, hd = q.shape
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    out = torch.empty_like(q)
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if cos is None else cos.data_ptr(),
                None if sin is None else sin.data_ptr(),
                out.data_ptr(), B, S, H, hd,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel failed: CUDA error {rc}")
    launches += 1
    return out
