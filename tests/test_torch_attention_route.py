"""How the port's attention (cliffordtpu_torch/kernels/attention.py) picks
its route on the card: the kernels for every shape that the JAX package's
``attention_supported`` admits and whose head_dim a form takes (the
whole-sequence form where the sequence fits one block, else the key-tiled
one), else ``attention_dense`` (RoPE, then
``scaled_dot_product_attention``), the counterpart of the XLA branch of
cliffordtpu/nn/vit_vae.py::Attention.

The route test drives ``_routed`` (the CUDA side of ``fused_attention``) on
CPU tensors with the launch functions stubbed to record the route and run
the plain versions.  The tiled algorithm itself (online softmax over key
tiles; the backward from the log-sum-exp and rowsum(dO o O) in a pass over
query tiles and a pass over key tiles) is emulated in PyTorch at the
kernels' tile sizes and held against the JAX package's kernel in interpret
mode.  Bars: 1e-5 for float32 outputs and gradients against the plain
versions and against JAX; bfloat16 outputs within 2e-2 of the output's
magnitude, and bfloat16 gradients within 2e-2 of max(1, their magnitude)
(the kernels' bars on the card)."""

import inspect

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import attention_pallas as ap
from cliffordtpu.nn.vit_vae import apply_rotary_half as jax_rotary_half
from cliffordtpu_torch.kernels import attention
from cliffordtpu_torch.ops.rope import apply_rotary_half, rope_2d_cos_sin

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("S,hd,dtype,backward,route", [
    (68, 64, F32, False, "whole"), (68, 64, F32, True, "whole"),
    (68, 64, BF16, False, "whole"), (68, 64, BF16, True, "whole"),
    (260, 64, F32, False, "tiled"), (260, 64, F32, True, "tiled"),
    (260, 64, BF16, False, "whole"), (260, 64, BF16, True, "tiled"),
    (68, 96, BF16, False, "dense"), (68, 96, F32, True, "whole"),
    (68, 12, F32, False, "dense"),
], ids=lambda p: str(p).replace("torch.", ""))
def test_kernel_fits(S, hd, dtype, backward, route):
    """At 8 heads: the flagship shape fits every whole-sequence form; S 260
    (``default_config(256)``) takes the kernels in every case, the
    bfloat16 forward without a gradient whole, the rest tiled; head_dim 96
    fits no bfloat16 form, 12 no float32 one."""
    assert attention.route(S, 8, hd, dtype, backward) == route
    assert attention.kernel_fits(S, 8, hd, dtype, backward) is (
        route != "dense")


def test_shared_memory_at_s260():
    """The whole-sequence forms at S 260 (only the bfloat16 forward fits),
    and the tiled forms at head_dim 64, which do not depend on S."""
    assert attention.smem_bytes(260, 64, F32) == 482560
    assert attention.smem_bytes(260, 64, BF16) == 117504
    assert attention.bwd_smem_bytes(260, 64, F32) == 832000
    assert attention.bwd_smem_bytes(260, 64, BF16) == 461312
    assert attention._SMEM_MAX == 232448
    assert attention.tiled_smem_bytes(64, F32) == 4 * (
        4 * 32 * 68 + 32 * 36 + 3 * 32) == 39808
    assert attention.tiled_smem_bytes(64, F32, True) == 4 * (
        6 * 32 * 68 + 2 * 32 * 36 + 2 * 32) == 61696
    assert attention.tiled_smem_bytes(64, BF16) == 2 * 3 * 64 * 72 == 27648
    assert attention.tiled_smem_bytes(64, BF16, True) == (
        2 * 4 * 64 * 72 + 4 * 2 * 64) == 37376


_GRID = [(S, H, hd) for S in (2, 17, 68, 140, 260, 330, 331, 400, 520)
         for H in (1, 2, 8, 16) for hd in (8, 16, 24, 32, 64, 96, 128)]


def test_route_equals_jax_attention_supported():
    """On a grid of (S, H, hd): the port takes the kernels exactly where
    the JAX package's gate admits the shape and a form takes the head_dim
    (bfloat16: 16, 32, 64, 128; float32: a multiple of 8), with and
    without a gradient.  The gate is the port's own copy."""
    assert sum(ap.attention_supported((1, *g)) for g in _GRID) not in (
        0, len(_GRID))
    for S, H, hd in _GRID:
        jax_gate = ap.attention_supported((1, S, H, hd))
        assert attention.jax_supported(S, H, hd) is jax_gate
        for dtype, takes in ((F32, hd % 8 == 0),
                             (BF16, hd in (16, 32, 64, 128))):
            for backward in (False, True):
                assert attention.kernel_fits(S, H, hd, dtype, backward) is (
                    jax_gate and takes), (S, H, hd, dtype, backward)


def _qkv(B, S, H, hd, seed, dtype=F32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(
        np.float32)).to(dtype) for _ in range(3)]


def _tables(S, hd):
    """RoPE tables of a square patch grid and 4 registers, at least S
    rows."""
    grid = math.ceil(math.sqrt(S - 4))
    cos, sin = rope_2d_cos_sin(32, grid, hd, cls_token_num=4)
    return torch.from_numpy(cos), torch.from_numpy(sin)


@pytest.fixture
def stubbed(monkeypatch):
    """Launch functions that record the form and run the plain versions
    (the forward stands in for the registered operator too, which reaches
    the plain version for CPU tensors); the counts start at 0."""
    seen = []

    def fwd(q, k, v, cos, sin):
        seen.append("fwd")
        return attention.attention_plain(q, k, v, cos, sin)

    def bwd(q, k, v, cos, sin, d_out):
        seen.append("bwd")
        return attention.attention_bwd_plain(q, k, v, cos, sin, d_out)

    def fwd_tiled(q, k, v, cos, sin, with_lse=True):
        seen.append("fwd_tiled")
        out, lse = attention.attention_lse_plain(q, k, v, cos, sin)
        return out, lse if with_lse else None

    def bwd_tiled(q, k, v, cos, sin, out, lse, d_out):
        seen.append("bwd_tiled")
        return attention.attention_bwd_tiled_plain(q, k, v, cos, sin, out,
                                                   lse, d_out)

    monkeypatch.setattr(attention, "_launch_fwd", fwd)
    monkeypatch.setattr(attention, "_fwd_op", fwd)
    monkeypatch.setattr(attention, "_launch_bwd", bwd)
    monkeypatch.setattr(attention, "_launch_fwd_tiled", fwd_tiled)
    monkeypatch.setattr(attention, "_launch_bwd_tiled", bwd_tiled)
    monkeypatch.setattr(attention, "dense_calls", 0)
    return seen


@pytest.mark.parametrize("S,H,dtype,grad,route", [
    (260, 2, BF16, False, ["fwd"]), (260, 2, BF16, True,
                                     ["fwd_tiled", "bwd_tiled"]),
    (260, 2, F32, False, ["fwd"]), (260, 2, F32, True,
                                    ["fwd_tiled", "bwd_tiled"]),
    (68, 2, F32, True, ["fwd", "bwd"]), (68, 2, BF16, False, ["fwd"]),
    (400, 8, F32, True, "dense"),
], ids=lambda p: str(p).replace("torch.", ""))
def test_route_is_chosen_by_shape_before_any_launch(stubbed, S, H, dtype,
                                                    grad, route):
    """At S 260 every case takes the kernels: without a gradient the
    registered forward (whole or tiled by shape), with one the tiled
    forms in both directions; the flagship shape takes the whole-sequence
    kernels; S 400 at 8 heads, beyond the JAX package's gate, the dense
    route for both directions at once.  The output, and the gradients
    where taken, equal the plain versions'."""
    q, k, v = _qkv(1, S, H, 64, S + grad, dtype)
    cos, sin = _tables(S, 64)
    if grad:
        for t in (q, k, v):
            t.requires_grad_()
    out = attention._routed(q, k, v, cos, sin)
    want = attention.attention_plain(q.detach(), k.detach(), v.detach(),
                                     cos, sin)
    assert out.dtype == dtype and out.shape == q.shape
    bar = 1e-5 if dtype == F32 else 2e-2 * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= bar
    if grad:
        d_out = torch.from_numpy(np.random.default_rng(1).normal(
            size=q.shape).astype(np.float32)).to(dtype)
        got = torch.autograd.grad(out, (q, k, v), d_out)
        ref = attention.attention_bwd_plain(q.detach(), k.detach(),
                                            v.detach(), cos, sin, d_out)
        for g, r in zip(got, ref):
            assert (g.float() - r.float()).abs().max().item() <= (
                1e-5 if dtype == F32 else 2e-2) * max(
                    1.0, r.float().abs().max().item())
    if route == "dense":
        assert stubbed == [] and attention.dense_calls == 1
    else:
        assert stubbed == route and attention.dense_calls == 0


def test_kernel_errors_still_raise_and_inputs_are_checked(stubbed,
                                                           monkeypatch):
    """A kernel that fails on a shape it accepts raises through: there is
    no switch to the dense route; the input errors raise on either route,
    and the choice reads no environment and catches nothing."""
    def broken(*args):
        raise RuntimeError("attention_fwd kernel failed: CUDA error 1")

    monkeypatch.setattr(attention, "_launch_fwd", broken)
    monkeypatch.setattr(attention, "_fwd_op", broken)
    q, k, v = _qkv(1, 68, 2, 64, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        attention._routed(q, k, v, None, None)
    assert attention.dense_calls == 0
    cos, sin = _tables(260, 64)
    q, k, v = _qkv(1, 260, 2, 64, 0)
    with pytest.raises(ValueError, match="both cos and sin"):
        attention._routed(q, k, v, cos, None)
    with pytest.raises(ValueError, match="contiguous"):
        attention._routed(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), None, None)
    with pytest.raises(ValueError, match="share one"):
        attention._routed(q, k[:, :10], v, None, None)
    source = inspect.getsource(attention._routed)
    assert "try" not in source and "environ" not in inspect.getsource(
        attention)


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "norope"])
def test_attention_dense_matches_jax_xla_branch(use_rope):
    """``attention_dense`` against ``apply_rotary_half`` then
    ``jax.nn.dot_product_attention``, and its gradient against
    ``jax.grad`` of the same, <= 1e-5."""
    B, S, H, hd = 2, 20, 2, 16
    q, k, v = _qkv(B, S, H, hd, 3)
    cos, sin = _tables(S, hd) if use_rope else (None, None)

    def jax_branch(q, k, v):
        if use_rope:
            q = jax_rotary_half(q, jnp.asarray(cos.numpy()),
                                jnp.asarray(sin.numpy()))
            k = jax_rotary_half(k, jnp.asarray(cos.numpy()),
                                jnp.asarray(sin.numpy()))
        return jax.nn.dot_product_attention(q, k, v)

    w = np.random.default_rng(4).normal(size=(B, S, H, hd)).astype(
        np.float32)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want, vjp = jax.vjp(jax_branch, jq, jk, jv)
    want, jgrads = np.asarray(want), vjp(jnp.asarray(w))
    for t in (q, k, v):
        t.requires_grad_()
    out = attention.attention_dense(q, k, v, cos, sin)
    assert out.shape == (B, S, H, hd)
    assert np.abs(out.detach().numpy() - want).max() <= 1e-5
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(w))
    for g, jg in zip(got, jgrads):
        assert np.abs(g.numpy() - np.asarray(jg)).max() <= 1e-5


_NEG = -1e30  # attention_pallas.py::_NEG, the kernels' kNeg


def _tiled_forward(qr, kr, v, T):
    """The tiled forward kernels' algorithm on rotated q, k (B, S, H, hd)
    float32: query tiles of T rows; keys padded to tiles of T and walked a
    tile at a time with a running maximum and sum (online softmax), keys
    past S masked to -1e30.  Returns (out (B, S, H, hd), lse (B, H, S))."""
    B, S, H, hd = qr.shape
    scale = 1.0 / math.sqrt(hd)
    Sp = -(-S // T) * T
    pad = (0, 0, 0, 0, 0, Sp - S)
    qp, kp, vp = (torch.nn.functional.pad(t, pad).transpose(1, 2)
                  for t in (qr, kr, v))
    out = torch.zeros(B, H, Sp, hd)
    lse = torch.zeros(B, H, Sp)
    for q0 in range(0, Sp, T):
        q = qp[:, :, q0:q0 + T]
        m = torch.full((B, H, T), -math.inf)
        l = torch.zeros(B, H, T)
        o = torch.zeros(B, H, T, hd)
        for k0 in range(0, Sp, T):
            s = q @ kp[:, :, k0:k0 + T].transpose(-1, -2) * scale
            real = torch.arange(k0, k0 + T) < S
            s = torch.where(real, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ vp[:, :, k0:k0 + T]
            m = m_new
        out[:, :, q0:q0 + T] = o / l[..., None]
        lse[:, :, q0:q0 + T] = m + torch.log(l)
    return out[:, :, :S].transpose(1, 2), lse[:, :, :S]


def _tiled_backward(qr, kr, v, out, lse, d_out, T):
    """The tiled backward kernels' algorithm: P = exp(scale Qr Kr^T - lse)
    recomputed a (query tile, key tile) at a time, delta = rowsum(dO o O);
    a pass over query tiles sums dQr = dS Kr over the key tiles, a pass
    over key tiles sums dV = P^T dO and dKr = dS^T Qr over the query
    tiles; queries and keys past S get P = dS = 0.  Returns the rotated
    (dQr, dKr, dV), (B, S, H, hd)."""
    B, S, H, hd = qr.shape
    scale = 1.0 / math.sqrt(hd)
    Sp = -(-S // T) * T
    pad = (0, 0, 0, 0, 0, Sp - S)
    qp, kp, vp, op, dop = (torch.nn.functional.pad(t, pad).transpose(1, 2)
                           for t in (qr, kr, v, out, d_out))
    lp = torch.nn.functional.pad(lse, (0, Sp - S))
    delta = (dop * op).sum(-1)
    real = torch.arange(Sp) < S

    def tile(q0, k0):
        s = qp[:, :, q0:q0 + T] @ kp[:, :, k0:k0 + T].transpose(-1, -2)
        keep = real[q0:q0 + T, None] & real[None, k0:k0 + T]
        p = torch.where(keep, torch.exp(scale * s - lp[:, :, q0:q0 + T,
                                                         None]), 0.0)
        dp = dop[:, :, q0:q0 + T] @ vp[:, :, k0:k0 + T].transpose(-1, -2)
        return p, p * (dp - delta[:, :, q0:q0 + T, None]) * scale

    dq, dk, dv = (torch.zeros(B, H, Sp, hd) for _ in range(3))
    for q0 in range(0, Sp, T):  # the query-tile blocks
        for k0 in range(0, Sp, T):
            _, ds = tile(q0, k0)
            dq[:, :, q0:q0 + T] += ds @ kp[:, :, k0:k0 + T]
    for k0 in range(0, Sp, T):  # the key-tile blocks
        for q0 in range(0, Sp, T):
            p, ds = tile(q0, k0)
            dv[:, :, k0:k0 + T] += p.transpose(-1, -2) @ dop[:, :, q0:q0 + T]
            dk[:, :, k0:k0 + T] += ds.transpose(-1, -2) @ qp[:, :, q0:q0 + T]
    return tuple(t[:, :, :S].transpose(1, 2) for t in (dq, dk, dv))


@pytest.mark.parametrize("T,H", [(32, 2), (64, 1)],
                         ids=["simt_tiles32", "mma_tiles64"])
def test_tiled_algorithm_matches_jax_kernel_interpret(T, H):
    """At image 256's sequence (S 260, RoPE of a 16 x 16 grid and 4
    registers, heads of 64), the tiled algorithm at the float32 form's
    tiles (32) and the bfloat16 form's (64), in float32: its output
    against JAX's ``fused_attention`` run in interpret mode, its lse
    against torch's logsumexp, and its two-pass backward against the VJP
    of the interpret-mode kernel (``_attn_bwd``), all within 1e-5."""
    S, hd = 260, 64
    q, k, v = _qkv(1, S, H, hd, 7)
    d_out = _qkv(1, S, H, hd, 8)[0]
    c, s_ = rope_2d_cos_sin(256, 16, hd, cls_token_num=4)
    cos, sin = torch.from_numpy(c), torch.from_numpy(s_)
    qr, kr = apply_rotary_half(q, cos, sin), apply_rotary_half(k, cos, sin)
    out, lse = _tiled_forward(qr, kr, v, T)
    dqr, dkr, dv = _tiled_backward(qr, kr, v, out, lse, d_out, T)
    dq = apply_rotary_half(dqr, cos, -sin)
    dk = apply_rotary_half(dkr, cos, -sin)

    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, w: ap.fused_attention(
            a, b, w, jnp.asarray(c), jnp.asarray(s_)), jq, jk, jv)
        jgrads = vjp(jnp.asarray(d_out.numpy()))
    assert np.abs(out.numpy() - np.asarray(want)).max() <= 1e-5
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kr) / math.sqrt(hd)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() <= 1e-5
    for g, jg in zip((dq, dk, dv), jgrads):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= 1e-5 * max(
            1.0, np.abs(jg).max())
    # the plain version of the tiled backward, from the same out and lse
    plain = attention.attention_bwd_tiled_plain(q, k, v, cos, sin, out, lse,
                                                d_out)
    for g, p in zip((dq, dk, dv), plain):
        assert (g - p).abs().max().item() <= 1e-5
