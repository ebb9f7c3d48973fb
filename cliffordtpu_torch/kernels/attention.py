"""Fused RoPE + attention, forward and backward: the port of
``cliffordtpu/kernels/attention_pallas.py::fused_attention`` and of its
custom VJP (``_attn_bwd``).

``fused_attention`` runs ``attention_plain`` for CPU tensors; any device
other than CUDA or the CPU raises.  Without a gradient it reaches both
through the registered operator ``attention_fwd`` (``kernels/ops.py``),
which ``torch.export`` records in a serving program.  For CUDA tensors
it takes one of two routes, chosen before anything runs from the shape,
the dtype and whether a gradient is needed (``route``):

* the kernels, for every shape that the JAX package's own gate
  (``attention_pallas.py::attention_supported``, copied here as
  ``jax_supported``: the backward working set under 6 MiB) admits and
  whose head_dim a form takes: ``csrc/attention_fwd.cu``, and under
  autograd a ``torch.autograd.Function`` whose backward launches
  ``csrc/attention_bwd.cu``;
* the dense route, ``attention_dense``, for the shapes that gate refuses
  (S 400 at 8 heads of 64), and for a head_dim no form takes: the
  rotation, then ``scaled_dot_product_attention``, differentiated by
  autograd.  It is the counterpart of the JAX package's XLA branch
  (``cliffordtpu/nn/vit_vae.py::Attention``), which takes every shape
  outside ``attention_supported``; it is not a port of either kernel.

The route is a property of the shape, not a fallback: a kernel that fails
on a shape the route gave it raises, and under autograd one route serves
both directions.  ``dense_calls`` counts the dense route.

Each kernel has two forms per dtype (``fwd_form``, ``bwd_form``, chosen
from the shape in the same way):

* whole-sequence ("mma", "simt"): one block per (batch, head) holds the
  whole sequence in shared memory, where it fits (``smem_bytes``,
  ``bwd_smem_bytes``): flagship32 and vit128 (S 68), and the bfloat16
  forward without a gradient at S 260;
* key-tiled ("mma_tiled", "simt_tiled"): one block per (query tile,
  batch x head) walks the key tiles with an online softmax, and the
  forward writes each row's log-sum-exp; the backward recomputes P from it
  in one launch whose blocks own either a query tile (dq) or a key tile
  (dk, dv), so it needs no atomics and gives the same bits on every run.
  Shared memory does not depend on S (``tiled_smem_bytes``).  Under
  autograd the tiled forms serve both directions wherever the
  whole-sequence backward does not fit (image 256's S 260).

bfloat16 runs on the tensor cores (``mma.sync``, head_dim 16, 32, 64 or
128), float32 on the CUDA cores (head_dim a multiple of 8; the tiled form
up to the head_dim its tiles fit, 280 with a gradient, 440 without).

``fused_attention_qkv`` takes the packed (B, S, H, 3, hd) product of a
``fused_proj`` projection (``nn/vit_vae.py::Attention``): every form
reads q, k and v at their strides in it (token stride 3 H hd, head stride
3 hd), and the backward writes one packed gradient, so the projection's
backward is one product, with no copy or gather on either side.  The
contiguous layout is unchanged, and the route is the same for both.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from cliffordtpu_torch.kernels import build
from cliffordtpu_torch.ops.rope import apply_rotary_half

# kernel launches since the counts were last set to 0
launches = 0  # forward kernel, either form
bwd_launches = 0  # backward kernel, either form
tiled_launches = 0  # the forward launches that took the tiled form
tiled_bwd_launches = 0  # the backward launches that took the tiled form
dense_calls = 0  # fused_attention calls on CUDA that took attention_dense

_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_SYMBOLS = {torch.float32: "attention_fwd_f32",
            torch.bfloat16: "attention_fwd_bf16"}
_BWD_SYMBOLS = {torch.float32: "attention_bwd_f32",
                torch.bfloat16: "attention_bwd_bf16"}
_TILED_SYMBOLS = {torch.float32: "attention_fwd_tiled_f32",
                  torch.bfloat16: "attention_fwd_tiled_bf16"}
_TILED_BWD_SYMBOLS = {torch.float32: "attention_bwd_tiled_f32",
                      torch.bfloat16: "attention_bwd_tiled_bf16"}
# rows of a query tile and of a key tile of the tiled forms
TILE = {torch.float32: 32, torch.bfloat16: 64}
_BASE = {torch.float32: "simt", torch.bfloat16: "mma"}  # forms by dtype
_JAX_WORKING_MAX = 6 * 1024 * 1024  # attention_pallas.py::attention_supported


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


def attention_lse_plain(q, k, v, cos: Optional[torch.Tensor] = None,
                        sin: Optional[torch.Tensor] = None):
    """The plain PyTorch version of the tiled forward with its second
    output: (``attention_plain``'s output, each row's float32 log-sum-exp
    of the scaled scores, (B, H, S))."""
    hd = q.shape[-1]
    qf, kf = q.float(), k.float()
    if cos is not None:
        qf = apply_rotary_half(qf, cos.float(), sin.float())
        kf = apply_rotary_half(kf, cos.float(), sin.float())
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / math.sqrt(hd))
    return attention_plain(q, k, v, cos, sin), torch.logsumexp(s, dim=-1)


def attention_bwd_tiled_plain(q, k, v, cos: Optional[torch.Tensor],
                              sin: Optional[torch.Tensor], out, lse, d_out):
    """The plain PyTorch version of the tiled backward: ``attention_bwd_
    plain`` with P = exp(scale Qr Kr^T - lse) from the forward's
    log-sum-exp and the row term delta = rowsum(dO o O) from its output,
    in float32.  Returns (dq, dk, dv) in q's dtype."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qr, kr, vf, do = q.float(), k.float(), v.float(), d_out.float()
    if cos is not None:
        qr = apply_rotary_half(qr, cos.float(), sin.float())
        kr = apply_rotary_half(kr, cos.float(), sin.float())
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * scale
    p = torch.exp(s - lse.float()[..., None])
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # (B, H, S)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qr)
    if cos is not None:
        dq = apply_rotary_half(dq, cos.float(), -sin.float())
        dk = apply_rotary_half(dk, cos.float(), -sin.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def jax_supported(S: int, H: int, hd: int) -> bool:
    """The JAX package's gate for its fused kernels
    (``attention_pallas.py::attention_supported``), written out here: the
    backward's working set of seven (1, H, Sp, hd) float32 blocks, the two
    (Sp, hd) tables and three (Sp, Sp) score temporaries, Sp = S rounded
    up to 8, under 6 MiB."""
    Sp = _round_up(S, 8)
    working = (7 * H * Sp * hd + 2 * Sp * hd + 3 * Sp * Sp) * 4
    return hd % 2 == 0 and hd >= 8 and S >= 2 and working < _JAX_WORKING_MAX


def smem_bytes(S: int, hd: int, dtype=torch.float32) -> int:
    """Shared memory of one whole-sequence forward block.  float32: q and
    k (rows of hd + 4), v, and the probabilities (rows of Sp + 4), Sp = S
    rounded up to 4; bfloat16: q, k and v in rows of hd + 8, S rounded up
    to 16."""
    if dtype == torch.bfloat16:
        return 2 * 3 * _round_up(S, 16) * (hd + 8)
    Sp = _round_up(S, 4)
    return 4 * Sp * (2 * (hd + 4) + hd + Sp + 4)


def bwd_smem_bytes(S: int, hd: int, dtype=torch.float32) -> int:
    """Shared memory of one whole-sequence backward block: rotated q and
    k, v, dO, the probabilities P and dS.  float32: q, k, v, dO in rows of
    hd + 4, P and dS in rows of Sp + 4, Sp = S rounded up to 4; bfloat16:
    q, k, v, dO in rows of hd + 8 and P, dS in rows of Sk + 8, Sk = S
    rounded up to 16."""
    if dtype == torch.bfloat16:
        Sk = _round_up(S, 16)
        return 2 * (4 * Sk * (hd + 8) + 2 * Sk * (Sk + 8))
    Sp = _round_up(S, 4)
    return 4 * Sp * (4 * (hd + 4) + 2 * (Sp + 4))


def tiled_smem_bytes(hd: int, dtype=torch.float32,
                     backward: bool = False) -> int:
    """Shared memory of one tiled block, whatever S.  float32 (tiles of
    32): the forward's q, k, v and partial output in rows of hd + 4, the
    32 x 36 probabilities and three row vectors; the backward's six row
    tiles, P and dS, lse and delta.  bfloat16 (tiles of 64, rows of
    hd + 8): the forward's q, k and v; the backward's four tiles, lse and
    delta."""
    T = TILE[dtype]
    if dtype == torch.bfloat16:
        if backward:
            return 2 * 4 * T * (hd + 8) + 4 * 2 * T
        return 2 * 3 * T * (hd + 8)
    if backward:
        return 4 * (6 * T * (hd + 4) + 2 * T * (T + 4) + 2 * T)
    return 4 * (4 * T * (hd + 4) + T * (T + 4) + 3 * T)


def _head_dim_problem(hd: int, dtype) -> Optional[str]:
    if dtype == torch.bfloat16 and hd not in (16, 32, 64, 128):
        return (f"the bfloat16 (mma) kernels take head_dim 16, 32, 64 or "
                f"128, got {hd}")
    if dtype == torch.float32 and hd % 8:
        return (f"the float32 (simt) kernels take head_dim a multiple of 8, "
                f"got {hd}")
    return None


def _route_problem(S: int, H: int, hd: int, dtype, backward: bool):
    """(the kernel form, "whole" or "tiled", or None; why no form holds
    the shape, or None)."""
    problem = _head_dim_problem(hd, dtype)
    if problem:
        return None, problem
    if not jax_supported(S, H, hd):
        return None, (f"S={S}, H={H}, hd={hd} lies beyond the JAX package's "
                      f"attention_supported (its XLA branch's shapes)")
    if smem_bytes(S, hd, dtype) <= _SMEM_MAX and (
            not backward or bwd_smem_bytes(S, hd, dtype) <= _SMEM_MAX):
        return "whole", None
    if tiled_smem_bytes(hd, dtype) <= _SMEM_MAX and (
            not backward or tiled_smem_bytes(hd, dtype, True) <= _SMEM_MAX):
        return "tiled", None
    return None, (f"hd={hd} needs {tiled_smem_bytes(hd, dtype, backward)} "
                  f"bytes of shared memory in the tiled {_BASE[dtype]} form "
                  f"and S={S} does not fit the whole-sequence one, above "
                  f"{_SMEM_MAX}")


def route(S: int, H: int, hd: int, dtype, backward: bool) -> str:
    """The route of ``fused_attention`` on CUDA for a sequence of S tokens
    with H heads of hd in ``dtype``, with or without a gradient: "whole"
    or "tiled" (the kernels in that form, both directions alike), or
    "dense" (see the module docstring)."""
    form, _ = _route_problem(S, H, hd, dtype, backward)
    return form or "dense"


def kernel_fits(S: int, H: int, hd: int, dtype, backward: bool) -> bool:
    """Whether the kernels take this shape (``route`` is not "dense")."""
    return route(S, H, hd, dtype, backward) != "dense"


def fwd_form(dtype, S: Optional[int] = None, H: Optional[int] = None,
             hd: Optional[int] = None, backward: bool = False) -> str:
    """The forward kernel's form: "mma" (tensor cores) for bfloat16,
    "simt" (CUDA cores) for float32, with "_tiled" where the shape (when
    given) takes the key-tiled form."""
    tiled = S is not None and route(S, H, hd, dtype, backward) == "tiled"
    return _BASE[dtype] + ("_tiled" if tiled else "")


def bwd_form(dtype, S: Optional[int] = None, H: Optional[int] = None,
             hd: Optional[int] = None) -> str:
    """The backward kernel's form, as ``fwd_form`` under autograd."""
    return fwd_form(dtype, S, H, hd, backward=True)


@functools.lru_cache(maxsize=None)
def _bwd_kernel(dtype):
    fn = getattr(build.library("attention_bwd"), _BWD_SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    fn = getattr(build.library("attention_fwd"), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tiled_kernel(dtype):
    fn = getattr(build.library("attention_fwd"), _TILED_SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tiled_bwd_kernel(dtype):
    fn = getattr(build.library("attention_bwd"), _TILED_BWD_SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def input_strides(q, k, v):
    """(token stride, head stride) of q, k, v, in elements, for the layouts
    the kernels read: contiguous (B, S, H, hd) tensors (H hd, hd), or the
    q, k, v views of one packed (B, S, H, 3, hd) tensor (3 H hd, 3 hd).
    Raises for any other layout."""
    B, S, H, hd = q.shape
    if all(t.is_contiguous() for t in (q, k, v)):
        return H * hd, hd
    step = q.element_size() * hd
    packed = (3 * H * hd * S, 3 * H * hd, 3 * hd, 1)
    if (all(t.stride() == packed or B == 1 and t.stride()[1:] == packed[1:]
            for t in (q, k, v))
            and k.data_ptr() == q.data_ptr() + step
            and v.data_ptr() == q.data_ptr() + 2 * step):
        return 3 * H * hd, 3 * hd
    raise ValueError("q, k, v must be contiguous, or the q, k, v views of "
                     "one packed (B, S, H, 3, hd) tensor")


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
    input_strides(q, k, v)
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


def _check(q, k, v, cos, sin, bwd: bool = False) -> str:
    """The input errors, then the kernels' own rules: a shape no kernel
    form holds (with ``bwd``: in both directions) raises here.  Returns the
    form, "whole" or "tiled"."""
    _check_inputs(q, k, v, cos, sin)
    _, S, H, hd = q.shape
    form, problem = _route_problem(S, H, hd, q.dtype, bwd)
    if problem:
        raise ValueError(problem)
    return form


def _check_aligned(*tensors):
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("the attention kernels move q, k, v, cos, sin and "
                         "the gradients 16 bytes at a time: they must be "
                         "16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, cos, sin) -> torch.Tensor:
    """Kernel A in the form the shape takes without a gradient: the
    whole-sequence form where it fits, else the tiled one (no lse)."""
    global launches
    B, S, H, hd = q.shape
    form, problem = _route_problem(S, H, hd, q.dtype, False)
    if problem:
        raise ValueError(problem)
    if form == "tiled":
        return _launch_fwd_tiled(q, k, v, cos, sin, with_lse=False)[0]
    _check_aligned(q, k, v, cos, sin)
    ld_tok, ld_head = input_strides(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin),
            out.data_ptr(), B, S, H, hd, ld_tok, ld_head, _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel failed: CUDA error {rc}")
    launches += 1
    return out


def _launch_fwd_tiled(q, k, v, cos, sin, with_lse: bool = True):
    """Kernel A's tiled form: (out, lse) with lse float32 (B, H, S), or
    (out, None) without ``with_lse``."""
    global launches, tiled_launches
    B, S, H, hd = q.shape
    _check_aligned(q, k, v, cos, sin)
    ld_tok, ld_head = input_strides(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = _tiled_kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin),
            out.data_ptr(), _ptr(lse), B, S, H, hd, ld_tok, ld_head,
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_fwd (tiled) kernel failed: CUDA "
                           f"error {rc}")
    launches += 1
    tiled_launches += 1
    return out, lse


def _grad_buffers(q, dqkv, ld_head):
    """dq, dk, dv in the inputs' layout (head stride ``ld_head``): the
    views of ``dqkv`` (B, S, H, 3, hd), made here for packed inputs when
    not given, else three contiguous tensors."""
    B, S, H, hd = q.shape
    if dqkv is None and ld_head != hd:
        dqkv = torch.empty((B, S, H, 3, hd), dtype=q.dtype, device=q.device)
    if dqkv is not None:
        return dqkv.unbind(3)
    return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                 for _ in range(3))


def _launch_bwd(q, k, v, cos, sin, d_out, dqkv=None):
    """The whole-sequence backward kernel; the gradients take the inputs'
    layout: for packed q, k, v they are written into ``dqkv`` (B, S, H, 3,
    hd), made here when not given, and returned as its three views."""
    global bwd_launches
    B, S, H, hd = q.shape
    _check_aligned(q, k, v, cos, sin, d_out)
    ld_tok, ld_head = input_strides(q, k, v)
    dq, dk, dv = _grad_buffers(q, dqkv, ld_head)
    if input_strides(dq, dk, dv) != (ld_tok, ld_head):
        raise ValueError("the gradients must take the inputs' layout")
    with torch.cuda.device(q.device):
        rc = _bwd_kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin),
            d_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, hd, ld_tok, ld_head, _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_bwd kernel failed: CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dv


def _launch_bwd_tiled(q, k, v, cos, sin, out, lse, d_out, dqkv=None):
    """The tiled backward kernel, from the tiled forward's ``out`` and
    ``lse``; the gradients' layout as ``_launch_bwd``'s."""
    global bwd_launches, tiled_bwd_launches
    B, S, H, hd = q.shape
    _check_aligned(q, k, v, cos, sin, d_out, out)
    ld_tok, ld_head = input_strides(q, k, v)
    if (not out.is_contiguous() or out.shape != q.shape
            or lse.shape != (B, H, S) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("out must be contiguous (B, S, H, hd) and lse "
                         "float32 (B, H, S)")
    dq, dk, dv = _grad_buffers(q, dqkv, ld_head)
    if input_strides(dq, dk, dv) != (ld_tok, ld_head):
        raise ValueError("the gradients must take the inputs' layout")
    with torch.cuda.device(q.device):
        rc = _tiled_bwd_kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin),
            out.data_ptr(), lse.data_ptr(), d_out.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, hd, ld_tok, ld_head,
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"attention_bwd (tiled) kernel failed: CUDA "
                           f"error {rc}")
    bwd_launches += 1
    tiled_bwd_launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward kernel, saving the unrotated q, k, v and the tables (and,
    in the tiled form, the output and its log-sum-exp); backward kernel in
    the same form.  cos and sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, tiled=False):
        ctx.tiled = tiled
        if tiled:
            out, lse = _launch_fwd_tiled(q, k, v, cos, sin)
            ctx.save_for_backward(q, k, v, cos, sin, out, lse)
            return out
        ctx.save_for_backward(q, k, v, cos, sin)
        return _fwd_op(q, k, v, cos, sin)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, cos, sin, *saved = ctx.saved_tensors
        if d_out.dtype != q.dtype:
            raise ValueError(f"gradient is {d_out.dtype}, q is {q.dtype}")
        if ctx.tiled:
            dq, dk, dv = _launch_bwd_tiled(q, k, v, cos, sin, *saved,
                                           d_out.contiguous())
        else:
            dq, dk, dv = _launch_bwd(q, k, v, cos, sin, d_out.contiguous())
        return dq, dk, dv, None, None, None


class _FusedAttentionQKV(torch.autograd.Function):
    """``_FusedAttention`` on the packed (B, S, H, 3, hd) q/k/v: both
    kernels read it in place, and the backward writes one packed dqkv."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, tiled=False):
        ctx.tiled = tiled
        if tiled:
            out, lse = _launch_fwd_tiled(*qkv.unbind(3), cos, sin)
            ctx.save_for_backward(qkv, cos, sin, out, lse)
            return out
        ctx.save_for_backward(qkv, cos, sin)
        return _fwd_op(*qkv.unbind(3), cos, sin)

    @staticmethod
    def backward(ctx, d_out):
        qkv, cos, sin, *saved = ctx.saved_tensors
        if d_out.dtype != qkv.dtype:
            raise ValueError(f"gradient is {d_out.dtype}, q is {qkv.dtype}")
        dqkv = torch.empty_like(qkv)
        if ctx.tiled:
            _launch_bwd_tiled(*qkv.unbind(3), cos, sin, *saved,
                              d_out.contiguous(), dqkv)
        else:
            _launch_bwd(*qkv.unbind(3), cos, sin, d_out.contiguous(), dqkv)
        return dqkv, None, None, None


def fused_attention_bwd(q, k, v, cos: Optional[torch.Tensor],
                        sin: Optional[torch.Tensor], d_out, out=None,
                        lse=None):
    """(dq, dk, dv) of ``fused_attention`` for the output gradient
    ``d_out`` (B, S, H, hd): the backward kernel, in the form the shape
    takes under autograd, for CUDA tensors; its plain version for CPU
    tensors.  The tiled form reads the tiled forward's ``out`` and
    ``lse``, which it computes first (one launch of A) when not given.
    For the views of a packed (B, S, H, 3, hd) q/k/v the gradients are
    the views of one packed tensor."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, cos, sin, d_out)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    form = _check(q, k, v, cos, sin, bwd=True)
    if d_out.shape != q.shape or d_out.dtype != q.dtype \
            or d_out.device != q.device:
        raise ValueError("d_out must match q in shape, dtype and device")
    S = q.shape[1]
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    if form == "whole":
        return _launch_bwd(q, k, v, cos, sin, d_out.contiguous())
    if out is None or lse is None:
        out, lse = _launch_fwd_tiled(q, k, v, cos, sin)
    return _launch_bwd_tiled(q, k, v, cos, sin, out, lse, d_out.contiguous())


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
    q, k and v.  On CUDA, the kernels where ``route`` gives a form, else
    ``attention_dense`` (see the module docstring)."""
    if q.device.type == "cpu":
        if _needs_grad(q, k, v):
            return attention_plain(q, k, v, cos, sin)
        return _fwd_op(q, k, v, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _routed(q, k, v, cos, sin)


def fused_attention_qkv(qkv, cos: Optional[torch.Tensor] = None,
                        sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fused_attention`` on q, k, v packed in one contiguous (B, S, H, 3,
    hd) tensor (the ``fused_proj`` projection's product), differentiable
    in it: the kernels read the views in place and the backward writes one
    packed gradient; the CPU and the dense route take the views."""
    if qkv.dim() != 5 or qkv.shape[3] != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (B, S, H, 3, hd) tensor, "
                         f"got {tuple(qkv.shape)}")
    q, k, v = qkv.unbind(3)
    if qkv.device.type == "cpu":
        return fused_attention(q, k, v, cos, sin)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention_qkv runs on cuda or cpu, not "
                         f"{qkv.device}")
    global dense_calls
    _check_inputs(q, k, v, cos, sin)
    needs_grad = torch.is_grad_enabled() and qkv.requires_grad
    _, S, H, _, hd = qkv.shape
    form = route(S, H, hd, qkv.dtype, needs_grad)
    if form == "dense":
        dense_calls += 1
        return attention_dense(q, k, v, cos, sin)
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    if needs_grad:
        return _FusedAttentionQKV.apply(qkv, cos, sin, form == "tiled")
    return _fwd_op(q, k, v, cos, sin)


def _needs_grad(q, k, v) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))


def _fwd_op(q, k, v, cos, sin) -> torch.Tensor:
    """The registered forward operator (``kernels/ops.py``), which a traced
    program records: kernel A on CUDA, ``attention_plain`` on the CPU; its
    C++ counterpart while a native export traces (``kernels/native.py``)."""
    from cliffordtpu_torch.kernels import native

    if native.active():
        return torch.ops.cliffordtpu_native.attention_fwd(q, k, v, cos, sin)
    return torch.ops.cliffordtpu_torch.attention_fwd(q, k, v, cos, sin)


def _routed(q, k, v, cos, sin) -> torch.Tensor:
    """``fused_attention`` for CUDA tensors: the route is chosen from the
    shape, the dtype and whether a gradient is needed, before anything
    runs; under autograd it serves both directions."""
    global dense_calls
    _check_inputs(q, k, v, cos, sin)
    needs_grad = _needs_grad(q, k, v)
    _, S, H, hd = q.shape
    form = route(S, H, hd, q.dtype, needs_grad)
    if form == "dense":
        dense_calls += 1
        return attention_dense(q, k, v, cos, sin)
    if cos is not None:
        cos, sin = cos[:S].contiguous(), sin[:S].contiguous()
    if needs_grad:
        return _FusedAttention.apply(q, k, v, cos, sin, form == "tiled")
    return _fwd_op(q, k, v, cos, sin)
