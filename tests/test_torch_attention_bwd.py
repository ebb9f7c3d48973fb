"""The port's attention backward (cliffordtpu_torch/kernels/attention.py:
``attention_bwd_plain``, the plain version of csrc/attention_bwd.cu)
against torch.autograd of ``attention_plain``, jax.grad of
apply_rotary_half + jax.nn.dot_product_attention, and the VJP of the
interpret-mode Pallas kernel (kernels/attention_pallas.py).  Float32,
<= 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import attention_pallas as ap
from cliffordtpu.nn.vit_vae import apply_rotary_half as jax_rotary_half
from cliffordtpu_torch.kernels import attention
from cliffordtpu_torch.ops.rope import apply_rotary_half

torch.set_num_threads(1)

# (B, S, H, hd, rope): the flagship sequence (64 patch tokens + 4
# registers) and head width, and a ragged sequence, each with and without
# RoPE
CASES = [(2, 68, 2, 64, True), (2, 68, 2, 64, False), (2, 17, 3, 16, True),
         (2, 17, 3, 16, False)]


def _inputs(B, S, H, hd, rope, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
                  for _ in range(4))
    if not rope:
        return q, k, v, w, None, None
    ang = rng.uniform(0, 2 * np.pi, (S + 3, hd // 2)).astype(np.float32)
    return q, k, v, w, np.cos(ang), np.sin(ang)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _plain(q, k, v, w, cos, sin):
    return [g.numpy() for g in attention.attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(cos), _t(sin), _t(w))]


def _xla(q, k, v, cos, sin):
    if cos is not None:
        q = jax_rotary_half(q, jnp.asarray(cos), jnp.asarray(sin))
        k = jax_rotary_half(k, jnp.asarray(cos), jnp.asarray(sin))
    return jax.nn.dot_product_attention(q, k, v)


@pytest.mark.parametrize("B,S,H,hd,rope", CASES)
def test_plain_backward_matches_torch_autograd(B, S, H, hd, rope):
    q, k, v, w, cos, sin = _inputs(B, S, H, hd, rope)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = attention.attention_plain(tq, tk, tv, _t(cos), _t(sin))
    want = torch.autograd.grad(out, (tq, tk, tv), _t(w))
    for g, r in zip(_plain(q, k, v, w, cos, sin), want):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,H,hd,rope", CASES)
def test_plain_backward_matches_jax_grad_of_xla(B, S, H, hd, rope):
    q, k, v, w, cos, sin = _inputs(B, S, H, hd, rope, seed=1)
    want = jax.grad(lambda *a: jnp.sum(_xla(*a, cos, sin) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r in zip(_plain(q, k, v, w, cos, sin), want):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,H,hd,rope", CASES)
def test_plain_backward_matches_interpret_kernel_vjp(B, S, H, hd, rope):
    q, k, v, w, cos, sin = _inputs(B, S, H, hd, rope, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(
            lambda *a: jnp.sum(ap.fused_attention(*a, cos, sin) * w),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r in zip(_plain(q, k, v, w, cos, sin), want):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=0)


def test_bf16_plain_backward_computes_in_f32_and_returns_bf16():
    q, k, v, w, cos, sin = _inputs(1, 20, 2, 16, True, seed=3)
    b = [_t(a).bfloat16() for a in (q, k, v, w)]
    got = attention.attention_bwd_plain(b[0], b[1], b[2], _t(cos), _t(sin),
                                        b[3])
    want = attention.attention_bwd_plain(*(t.float() for t in b[:3]),
                                         _t(cos), _t(sin), b[3].float())
    for g, r in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, r.bfloat16(), atol=0, rtol=0)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    q, k, v, w, cos, sin = _inputs(1, 9, 2, 8, True, seed=4)
    before = (attention.launches, attention.bwd_launches)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = attention.fused_attention(tq, tk, tv, _t(cos), _t(sin))
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(w))
    got = attention.fused_attention_bwd(_t(q), _t(k), _t(v), _t(cos),
                                        _t(sin), _t(w))
    for a, g in zip(auto, got):
        np.testing.assert_allclose(a.numpy(), g.numpy(), atol=1e-5, rtol=0)
    assert (attention.launches, attention.bwd_launches) == before
    meta = torch.zeros(1, 5, 1, 8, device="meta")
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(meta, meta, meta, None, None, meta)


@pytest.mark.parametrize("rope", [True, False])
def test_autograd_function_routes_to_the_backward_launcher(monkeypatch,
                                                           rope):
    """The card's path with the two launchers replaced by the plain
    versions: the Function saves q, k, v and the tables, hands a contiguous
    gradient to the backward launcher once, and gives cos and sin none."""
    q, k, v, w, cos, sin = _inputs(2, 9, 2, 8, rope, seed=5)
    calls = []

    def fwd(q, k, v, cos, sin):
        return attention.attention_plain(q, k, v, cos, sin)

    def bwd(q, k, v, cos, sin, d_out):
        assert d_out.is_contiguous()
        calls.append(d_out.shape)
        return attention.attention_bwd_plain(q, k, v, cos, sin, d_out)

    monkeypatch.setattr(attention, "_launch_fwd", fwd)
    monkeypatch.setattr(attention, "_launch_bwd", bwd)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tc, ts = _t(cos), _t(sin)
    out = attention._FusedAttention.apply(tq, tk, tv, tc, ts)
    # a non-contiguous incoming gradient, as a transpose upstream gives
    wt = _t(w).transpose(1, 2).contiguous().transpose(1, 2)
    assert not wt.is_contiguous()
    got = torch.autograd.grad(out, (tq, tk, tv), wt)
    assert len(calls) == 1
    for g, r in zip(got, _plain(q, k, v, w, cos, sin)):
        np.testing.assert_array_equal(g.numpy(), r)


def test_backward_shared_memory_fits_the_flagship_and_is_refused_above():
    """S = 68, hd = 64 in float32 (the simt form: q, k, v, dO in rows of
    68, P and dS in rows of 72): 113,152 bytes, above the 48 KB default and
    within the 227 KB opt-in limit; a sequence of 140 fits the
    whole-sequence forward only, so under autograd it takes the key-tiled
    forms in both directions; a shape beyond the JAX package's
    ``attention_supported`` (S 400, 8 heads of 64) is refused."""
    assert attention.bwd_smem_bytes(68, 64) == 113152
    assert 48 * 1024 < attention.bwd_smem_bytes(68, 64) <= attention._SMEM_MAX
    assert attention.bwd_smem_bytes(140, 64) > attention._SMEM_MAX
    assert attention.smem_bytes(140, 64) <= attention._SMEM_MAX
    q = torch.zeros(1, 140, 1, 64)
    assert attention._check(q, q, q, None, None) == "whole"
    assert attention._check(q, q, q, None, None, bwd=True) == "tiled"
    q = torch.zeros(1, 400, 8, 64)
    with pytest.raises(ValueError, match="attention_supported"):
        attention._check(q, q, q, None, None, bwd=True)


def test_backward_forms_and_their_shared_memory():
    """``bwd_form``: the tensor-core form for bfloat16, register tiles for
    float32.  The mma form keeps q, k, v, dO in rows of hd + 8 bfloat16 and
    P, dS in rows of Sk + 8 (S padded to 16): 74,240 bytes at the flagship
    shape, three blocks per SM.  Each whole-sequence form is bounded by
    its own size: S 136 fits the mma form and not the simt one, S 200
    neither; a shape beyond them takes the key-tiled form of its dtype."""
    assert attention.bwd_form(torch.bfloat16) == "mma"
    assert attention.bwd_form(torch.float32) == "simt"
    mma = attention.bwd_smem_bytes(68, 64, torch.bfloat16)
    assert mma == 2 * (4 * 80 * 72 + 2 * 80 * 88) == 74240
    assert 3 * mma <= 228 * 1024 < 4 * mma
    assert attention.bwd_smem_bytes(17, 64, torch.bfloat16) == \
        2 * (4 * 32 * 72 + 2 * 32 * 40)
    assert attention.bwd_smem_bytes(17, 64) == 4 * 20 * (4 * 68 + 2 * 24)
    for S, fits in ((136, {torch.bfloat16}), (200, set())):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, S, 1, 64, dtype=dtype)
            form = attention._check(q, q, q, None, None, bwd=True)
            base = attention.bwd_form(dtype)
            if dtype in fits:
                assert form == "whole"
                assert attention.bwd_form(dtype, S, 1, 64) == base
                continue
            assert form == "tiled"
            assert attention.bwd_form(dtype, S, 1, 64) == f"{base}_tiled"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _mma_bwd_model(q, k, v, cos, sin, d_out, mask_rows=True, pad=None):
    """The bfloat16 backward kernel's arithmetic, in torch on float32: q and
    k rotated in float32 and rounded to bfloat16 (Qr, Kr); the rows padded
    to a multiple of 16 (with zeros, or with ``pad``'s rows, to stand for
    what a staging that skipped them would leave); scores, softmax, dP,
    delta and dS in float32 with the padded keys at -inf and, with
    ``mask_rows``, the padded query rows' P set to 0; P and dS rounded to
    bfloat16 as the operands of dV = P^T dO, dQr = dS Kr, dKr = dS^T Qr;
    sums in float32; the inverse rotation; outputs rounded to bfloat16."""
    B, S, H, hd = q.shape
    Sk = -(-S // 16) * 16
    if cos is not None:
        q = apply_rotary_half(q, cos[:S], sin[:S])
        k = apply_rotary_half(k, cos[:S], sin[:S])
    tiles = []
    for i, t in enumerate((_bf16(q), _bf16(k), v, d_out)):
        fill = torch.zeros(B, Sk - S, H, hd) if pad is None else pad[i]
        tiles.append(torch.cat([t, fill], 1))
    qr, kr, vp, dop = tiles
    scale = hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kr) * scale
    s[..., S:] = -torch.inf
    p = torch.softmax(s, -1)
    if mask_rows:
        p[:, :, S:, :] = 0
    dp = torch.einsum("bqhd,bkhd->bhqk", dop, vp)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dop)[:, :S]
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kr)[:, :S]
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qr)[:, :S]
    if cos is not None:
        dq = apply_rotary_half(dq, cos[:S], -sin[:S])
        dk = apply_rotary_half(dk, cos[:S], -sin[:S])
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _bf16_inputs(B, S, H, hd, rope, seed):
    q, k, v, w, cos, sin = _inputs(B, S, H, hd, rope, seed)
    return [_bf16(_t(a)).numpy() for a in (q, k, v, w)] + [cos, sin]


@pytest.mark.parametrize("reference", ["plain", "xla"])
@pytest.mark.parametrize("B,S,H,hd,rope", [(2, 68, 2, 64, True),
                                           (2, 17, 2, 64, False)])
def test_bf16_rounding_points_stay_within_the_bar(B, S, H, hd, rope,
                                                 reference):
    """chip_smoke holds the bfloat16 backward to 2e-2 x max(1, |ref|) of
    the float32 plain version: the mma form's rounding points (Qr, Kr, P
    and dS in bfloat16, everything else float32) keep within that bar of
    ``attention_bwd_plain`` and of jax.grad of XLA attention, on the same
    bfloat16 inputs, at the flagship sequence with RoPE and at S 17 (16-row
    padding to 32) without it."""
    q, k, v, w, cos, sin = _bf16_inputs(B, S, H, hd, rope, seed=6)
    got = _mma_bwd_model(*map(_t, (q, k, v, cos, sin, w)))
    if reference == "plain":
        want = _plain(q, k, v, w, cos, sin)
    else:
        want = [np.asarray(g) for g in jax.grad(
            lambda *a: jnp.sum(_xla(*a, cos, sin) * w),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]
    errs = []
    for g, r in zip(got, want):
        err = np.abs(g.numpy() - r).max()
        assert err <= 2e-2 * max(1.0, np.abs(r).max())
        errs.append(err)
    assert max(errs) > 0  # the model does round


def test_padded_query_rows_must_not_leak_into_dv_and_dk():
    """S 17 pads to 32 rows.  A padded query row has Qr = 0, so its scores
    are 0 and its softmax is uniform over the real keys, not zero.  With
    zeros in the padded rows of dO its dP, delta and dS are 0 and nothing
    leaks; but where the padded rows hold anything else (what a staging
    loop that skipped them would leave in shared memory), an unmasked P
    leaks into dV and dK by far more than the bar, and the mask on P keeps
    both exact.  The kernel zero-fills and masks."""
    B, S, H, hd = 2, 17, 2, 64
    q, k, v, w, _, _ = map(_t, _bf16_inputs(B, S, H, hd, False, seed=7))
    stale = [torch.from_numpy(np.random.default_rng(8 + i).normal(
        size=(B, 32 - S, H, hd)).astype(np.float32)) for i in range(4)]
    clean = _mma_bwd_model(q, k, v, None, None, w)
    for pad, masked, leaks in ((None, False, False), (stale, True, False),
                               (stale, False, True)):
        got = _mma_bwd_model(q, k, v, None, None, w, mask_rows=masked,
                             pad=pad)
        torch.testing.assert_close(got[0], clean[0], atol=0, rtol=0)  # dq
        for g, c in zip(got[1:], clean[1:]):  # dk, dv
            err = (g - c).abs().max().item()
            bar = 2e-2 * max(1.0, c.abs().max().item())
            assert (err > 10 * bar) if leaks else err == 0


def _accumulator_map(hd):
    """Where an m16n8k16 accumulator tile of 16 rows x hd columns (hd / 8
    n-tiles) lives: lane (g, t) holds, in n-tile n and element e, row
    g + 8 (e // 2), column 8 n + 2 t + e % 2."""
    return {(8 * n + 2 * t + e % 2, g + 8 * (e // 2)): (4 * g + t, n, e)
            for g in range(8) for t in range(4) for n in range(hd // 8)
            for e in range(4)}


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_fragment_map_pairs_rotation_columns_in_one_thread(hd):
    """The inverse rotation pairs column i with column i + hd/2.  In the
    accumulator layout both lie in one lane, in n-tiles n and n + hd/16 at
    the same element, so the kernel rotates dQr and dKr in registers."""
    where = _accumulator_map(hd)
    assert len(where) == 16 * hd  # every element of the tile, once
    for (col, row), (lane, n, e) in where.items():
        if col < hd // 2:
            assert where[col + hd // 2, row] == (lane, n + hd // 16, e)
