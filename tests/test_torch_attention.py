"""The port's fused RoPE + attention (cliffordtpu_torch/kernels/attention.py,
plain version) against apply_rotary_half + jax.nn.dot_product_attention
and the interpret-mode Pallas kernel (kernels/attention_pallas.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import attention_pallas as ap
from cliffordtpu.nn.vit_vae import apply_rotary_half as jax_rotary_half
from cliffordtpu.nn.vit_vae import rope_2d_cos_sin as jax_rope
from cliffordtpu_torch.kernels import attention
from cliffordtpu_torch.nn.rope import apply_rotary_half, rope_2d_cos_sin

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (B, S, H, hd, rope): the flagship head layout (8 heads of 64, 64 patch
# tokens + 4 registers), a ragged sequence, and the no-RoPE path
CASES = [(2, 68, 8, 64, True), (2, 13, 3, 16, True), (2, 17, 8, 64, False)]


def _inputs(B, S, H, hd, rope, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    if not rope:
        return q, k, v, None, None
    ang = rng.uniform(0, 2 * np.pi, (S + 3, hd // 2)).astype(np.float32)
    return q, k, v, np.cos(ang), np.sin(ang)


def _port(q, k, v, cos, sin):
    t = [None if a is None else torch.from_numpy(a) for a in (cos, sin)]
    return attention.fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), *t).numpy()


@pytest.mark.parametrize("B,S,H,hd,rope", CASES)
def test_plain_attention_matches_xla(B, S, H, hd, rope):
    q, k, v, cos, sin = _inputs(B, S, H, hd, rope)
    qj, kj = jnp.asarray(q), jnp.asarray(k)
    if rope:
        qj = jax_rotary_half(qj, jnp.asarray(cos), jnp.asarray(sin))
        kj = jax_rotary_half(kj, jnp.asarray(cos), jnp.asarray(sin))
    want = np.asarray(jax.nn.dot_product_attention(qj, kj, jnp.asarray(v)))
    got = _port(q, k, v, cos, sin)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,H,hd,rope", CASES)
def test_plain_attention_matches_interpret_kernel(B, S, H, hd, rope):
    q, k, v, cos, sin = _inputs(B, S, H, hd, rope, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ap.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), cos, sin))
    np.testing.assert_allclose(_port(q, k, v, cos, sin), want, atol=1e-5,
                               rtol=0)


def test_rope_tables_and_rotation_match_jax():
    cos, sin = rope_2d_cos_sin(32, 8, 64, cls_token_num=4)
    jcos, jsin = jax_rope(32, 8, 64, cls_token_num=4)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    assert cos.shape == (68, 32)
    np.testing.assert_array_equal(cos[:4], 1.0)  # registers: angle 0
    x = np.random.default_rng(2).normal(size=(2, 68, 8, 64)).astype(
        np.float32)
    want = np.asarray(jax_rotary_half(jnp.asarray(x), jnp.asarray(cos),
                                      jnp.asarray(sin)))
    got = apply_rotary_half(torch.from_numpy(x), torch.from_numpy(cos),
                            torch.from_numpy(sin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_bf16_plain_attention_computes_in_f32_and_returns_bf16():
    q, k, v, cos, sin = _inputs(1, 20, 2, 16, True, seed=3)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = attention.fused_attention(tq, tk, tv, tc, ts)
    assert got.dtype == torch.bfloat16
    want = attention.attention_plain(tq.float(), tk.float(), tv.float(),
                                     tc, ts)
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    before = attention.launches
    q, k, v, cos, sin = _inputs(1, 5, 1, 8, True)
    _port(q, k, v, cos, sin)
    assert attention.launches == before
    meta = torch.zeros(1, 5, 1, 8, device="meta")
    with pytest.raises(ValueError):
        attention.fused_attention(meta, meta, meta)


def test_flagship_shared_memory_needs_the_raised_limit():
    """S = 68, hd = 64 takes 73,984 bytes in float32 (q, k, v and the
    probabilities): above the 48 KB default, within the 227 KB a Hopper
    block may opt into.  bfloat16 keeps q, k, v only, in rows padded to 80,
    and fits the default."""
    assert attention.smem_bytes(68, 64) == 73984
    assert 48 * 1024 < attention.smem_bytes(68, 64) <= attention._SMEM_MAX
    assert attention.smem_bytes(68, 64, torch.bfloat16) == 34560 < 48 * 1024
    assert attention.fwd_form(torch.bfloat16) == "mma"
    assert attention.fwd_form(torch.float32) == "simt"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _mma_rounding_model(q, k, v, cos, sin):
    """The bfloat16 forward kernel's rounding points, in torch on float32:
    q and k rotated in float32 then rounded to bfloat16; scores, softmax and
    the row sums in float32; P rounded to bfloat16 before P v; P v summed
    in float32, divided by the float32 row sum, rounded to bfloat16."""
    qr = _bf16(apply_rotary_half(q, cos, sin))
    kr = _bf16(apply_rotary_half(k, cos, sin))
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kr) / q.shape[-1] ** 0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", _bf16(p), v) \
        / p.sum(-1).transpose(1, 2)[..., None]
    return _bf16(out)


def test_bf16_rounding_points_stay_within_the_bar_of_xla():
    """chip_smoke holds the bfloat16 kernel to 2e-2 x max|out| of the
    float32 plain version: the kernel's rounding points keep well inside
    that bar against JAX's XLA attention on the same bfloat16 inputs, at
    the flagship head layout (S 68, 8 heads of 64)."""
    q, k, v, cos, sin = _inputs(2, 68, 8, 64, True, seed=5)
    tq, tk, tv = (_bf16(torch.from_numpy(a)) for a in (q, k, v))
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = _mma_rounding_model(tq, tk, tv, tc, ts).numpy()
    qj, kj = (jax_rotary_half(jnp.asarray(t.numpy()), jnp.asarray(cos),
                              jnp.asarray(sin)) for t in (tq, tk))
    want = np.asarray(jax.nn.dot_product_attention(qj, kj,
                                                   jnp.asarray(tv.numpy())))
    err = np.abs(got - want).max()
    assert err <= 2e-2 * np.abs(want).max()
    assert err > 0  # the model does round


def test_forward_kernel_head_dims_are_checked_before_launch():
    """The tensor-core forms take head_dim 16 / 32 / 64 / 128, the float32
    forms a multiple of 8, in the forward and the backward alike."""
    def qkv(hd, dtype):
        return [torch.zeros(1, 5, 1, hd, dtype=dtype) for _ in range(3)]

    attention._check(*qkv(64, torch.bfloat16), None, None)
    attention._check(*qkv(24, torch.float32), None, None)
    for hd, dtype in ((24, torch.bfloat16), (256, torch.bfloat16),
                      (12, torch.float32)):
        with pytest.raises(ValueError, match="kernels take head_dim"):
            attention._check(*qkv(hd, dtype), None, None)
        with pytest.raises(ValueError, match="kernels take head_dim"):
            attention._check(*qkv(hd, dtype), None, None, fwd=False,
                             bwd=True)
