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
    """S = 68, hd = 64: 107,168 bytes, above the 48 KB default and within
    the 227 KB opt-in limit; a sequence of 140 fits the forward only."""
    assert attention.bwd_smem_bytes(68, 64) == 107168
    assert 48 * 1024 < attention.bwd_smem_bytes(68, 64) <= attention._SMEM_MAX
    assert attention.bwd_smem_bytes(140, 64) > attention._SMEM_MAX
    assert attention.smem_bytes(140, 64) <= attention._SMEM_MAX
    q = torch.zeros(1, 140, 1, 64)
    attention._check(q, q, q, None, None)  # the forward alone fits
    with pytest.raises(ValueError, match="for the backward"):
        attention._check(q, q, q, None, None, bwd=True)
