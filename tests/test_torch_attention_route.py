"""How the port's attention (cliffordtpu_torch/kernels/attention.py) picks
its route on the card: the kernels where ``kernel_fits``, else
``attention_dense`` (RoPE, then ``scaled_dot_product_attention``), the
counterpart of the XLA branch of cliffordtpu/nn/vit_vae.py::Attention.

The route test drives ``_routed`` (the CUDA side of ``fused_attention``) on
CPU tensors with the launch functions stubbed to record the route and run
the plain versions.  Bars: 1e-5 for float32 outputs and gradients against
the plain versions and against JAX; bfloat16 outputs within 2e-2 of the
output's magnitude, and bfloat16 gradients within 2e-2 of max(1, their
magnitude) (the kernels' bars on the card)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn.vit_vae import apply_rotary_half as jax_rotary_half
from cliffordtpu_torch.kernels import attention
from cliffordtpu_torch.nn.rope import rope_2d_cos_sin

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("S,hd,dtype,backward,fits", [
    (68, 64, F32, False, True), (68, 64, F32, True, True),
    (68, 64, BF16, False, True), (68, 64, BF16, True, True),
    (260, 64, F32, False, False), (260, 64, F32, True, False),
    (260, 64, BF16, False, True), (260, 64, BF16, True, False),
    (68, 96, BF16, False, False), (68, 96, F32, True, True),
    (68, 12, F32, False, False),
], ids=lambda p: str(p).replace("torch.", ""))
def test_kernel_fits(S, hd, dtype, backward, fits):
    """The flagship shape fits every form; S 260 (``default_config(256)``)
    fits the bfloat16 forward only; head_dim 96 fits no bfloat16 form."""
    assert attention.kernel_fits(S, hd, dtype, backward) is fits


def test_shared_memory_at_s260():
    assert attention.smem_bytes(260, 64, F32) == 482560
    assert attention.smem_bytes(260, 64, BF16) == 117504
    assert attention.bwd_smem_bytes(260, 64, F32) == 832000
    assert attention.bwd_smem_bytes(260, 64, BF16) == 461312
    assert attention._SMEM_MAX == 232448


def _qkv(B, S, H, hd, seed, dtype=F32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(
        np.float32)).to(dtype) for _ in range(3)]


def _tables(S, hd):
    cos, sin = rope_2d_cos_sin(32, int(np.sqrt(S - 4)), hd, cls_token_num=4)
    return torch.from_numpy(cos), torch.from_numpy(sin)


@pytest.fixture
def stubbed(monkeypatch):
    """Launch functions that record the route and run the plain versions;
    the counts start at 0."""
    seen = []

    def fwd(q, k, v, cos, sin):
        seen.append("fwd")
        return attention.attention_plain(q, k, v, cos, sin)

    def bwd(q, k, v, cos, sin, d_out):
        seen.append("bwd")
        return attention.attention_bwd_plain(q, k, v, cos, sin, d_out)

    monkeypatch.setattr(attention, "_launch_fwd", fwd)
    monkeypatch.setattr(attention, "_launch_bwd", bwd)
    monkeypatch.setattr(attention, "dense_calls", 0)
    return seen


@pytest.mark.parametrize("S,dtype,grad,route", [
    (260, BF16, False, ["fwd"]), (260, BF16, True, "dense"),
    (260, F32, False, "dense"), (260, F32, True, "dense"),
    (68, F32, True, ["fwd", "bwd"]), (68, BF16, False, ["fwd"]),
], ids=lambda p: str(p).replace("torch.", ""))
def test_route_is_chosen_by_shape_before_any_launch(stubbed, S, dtype, grad,
                                                    route):
    """At S 260 the bfloat16 forward without a gradient takes the kernel
    and every other case the dense route, for both directions at once;
    the flagship shape takes the kernels.  The output, and the gradients
    where taken, equal the plain versions'."""
    q, k, v = _qkv(1, S, 2, 64, S + grad, dtype)
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
