"""The C++ operators of the Python-free serving path
(cliffordtpu_torch/csrc/native_ops.cpp, the CPU build) against the port's
Python versions, the JAX package's XLA attention, ``jax.random`` and the
interpret-mode Pallas keyed sampler; the build's loud failures."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cliffordtpu.kernels import sampler_pallas as sp
from cliffordtpu.kernels.torus_pallas import _round_up
from cliffordtpu.nn.vit_vae import apply_rotary_half as jax_rotary_half
from cliffordtpu_torch import random as trandom
from cliffordtpu_torch.distributions.reparam import draw_flat
from cliffordtpu_torch.kernels import attention, build, native, sampler
from cliffordtpu_torch.native import build as nbuild

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = (7, 123456789)  # an apply rng; the draws use random.sample_key(RNG)


@pytest.fixture(scope="module")
def ops():
    """The CPU operator library and the CPU host, built at once (hash-keyed
    files under build/, reused by every test file and worker), then the
    library loaded into this process."""
    host = subprocess.Popen([sys.executable, "-m",
                             "cliffordtpu_torch.native.build", "--host",
                             "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lib = build.build_native_ops(False)
    out, err = host.communicate()
    assert host.returncode == 0, err
    native.load(False)
    return {"lib": lib, "host": out.strip().splitlines()[-1]}


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,S,H,hd,rope,dtype", [
    (2, 68, 8, 64, True, torch.float32), (2, 13, 3, 16, True, torch.float32),
    (2, 17, 8, 64, False, torch.float32), (2, 20, 2, 32, True,
                                           torch.bfloat16)])
def test_attention_matches_plain_and_xla(ops, B, S, H, hd, rope, dtype):
    g = np.random.default_rng(S + hd)
    q, k, v = (_t(g, B, S, H, hd).to(dtype) for _ in range(3))
    cos = sin = None
    if rope:
        ang = torch.from_numpy(g.uniform(0, 2 * np.pi, (S + 3, hd // 2))
                               .astype(np.float32))
        cos, sin = torch.cos(ang), torch.sin(ang)
    got = torch.ops.cliffordtpu_native.attention_fwd(q, k, v, cos, sin)
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    assert torch.equal(got, attention.attention_plain(q, k, v, cos, sin))
    if dtype != torch.float32:
        return
    qj, kj = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    if rope:
        qj = jax_rotary_half(qj, jnp.asarray(cos.numpy()),
                             jnp.asarray(sin.numpy()))
        kj = jax_rotary_half(kj, jnp.asarray(cos.numpy()),
                             jnp.asarray(sin.numpy()))
    want = np.asarray(jax.nn.dot_product_attention(qj, kj,
                                                   jnp.asarray(v.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_attention_takes_image256_sequence(ops):
    """S 260 with 8 heads of 64 (``default_config(256)``), float32, whose
    whole sequence fits no block: the operator's meta path gives the
    shape and its CPU path answers as ``attention_plain`` (on the card the
    shape takes the key-tiled form of kernel A)."""
    from cliffordtpu_torch.ops.rope import rope_2d_cos_sin

    g = np.random.default_rng(260)
    q, k, v = (_t(g, 1, 260, 8, 64) for _ in range(3))
    c, s = rope_2d_cos_sin(256, 16, 64, cls_token_num=4)
    cos, sin = torch.from_numpy(c), torch.from_numpy(s)
    assert attention.route(260, 8, 64, torch.float32, False) == "tiled"
    meta = torch.ops.cliffordtpu_native.attention_fwd(
        *(t.to("meta") for t in (q, k, v, cos, sin)))
    assert meta.shape == q.shape and meta.dtype == torch.float32
    got = torch.ops.cliffordtpu_native.attention_fwd(q, k, v, cos, sin)
    assert torch.equal(got, attention.attention_plain(q, k, v, cos, sin))


@pytest.mark.parametrize("route", ["keyed", "rng", "unfused"])
@pytest.mark.parametrize("R,d,per_row", [(7, 9, False), (12, 16, True),
                                         (3, 600, True)])
def test_sample_embed_matches_python(ops, route, R, d, per_row):
    """u and v bit for bit with the port's plain draws, theta and x with
    its plain versions (the unfused route: the circle formula and
    ``angles_to_torus``), at the host bases' d and the device form's."""
    g = np.random.default_rng(R * d)
    loc = torch.from_numpy(g.uniform(-np.pi, np.pi, (R, d))
                           .astype(np.float32))
    kap = torch.from_numpy(g.uniform(0.03, 10, (R, 1 if per_row else d))
                           .astype(np.float32))
    key = trandom.sample_key(RNG)
    got = torch.ops.cliffordtpu_native.sample_embed(
        torch.tensor(key), loc, kap, native.ROUTES[route])
    if route == "rng":
        want = sampler.sample_embed_rng_plain(key, loc, kap)
    else:
        want = sampler.sample_embed_keyed_plain(key, loc, kap)
    assert [t.shape for t in got] == [(R, 2 * d)] + [(R, d - 1)] * 3
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert _rel(got[1], want[1]) <= 1e-6 and _rel(got[0], want[0]) <= 1e-6


def _families():
    g = np.random.default_rng(3)
    unit = lambda *s: torch.nn.functional.normalize(_t(g, *s), dim=-1)  # noqa
    pos = lambda lo, hi, *s: torch.from_numpy(  # noqa: E731
        g.uniform(lo, hi, s).astype(np.float32))
    return {
        "gaussian": (_t(g, 5, 7), _t(g, 5, 7) * 0.3, False, None, 1.0),
        "gaussian_l2": (_t(g, 5, 7), _t(g, 5, 7) * 0.3, True, None, 1.0),
        "powerspherical": (unit(5, 9), pos(0.1, 30, 5, 1), False, None, 1.0),
        "powerspherical_tokens": (unit(4, 3, 16), pos(0.1, 30, 4, 3), False,
                                  None, 4.0),
        "vmf3": (unit(6, 3), pos(0.8, 10, 6, 1), False, None, 1.0),
        "vmf41": (unit(6, 41), pos(0.8, 10, 6, 1), False, None, 1.0),
        "clifford_keyed": (_t(g, 4, 3, 8), pos(0.03, 10, 4, 3), False,
                           "keyed", 1.0),
        "clifford_unfused": (_t(g, 4, 3, 8), pos(0.03, 10, 4, 3), False,
                             "unfused", 1.0),
        "clifford_rng": (_t(g, 4, 3, 8), pos(0.03, 10, 4, 3), False, "rng",
                         1.0),
        "clifford_rows": (_t(g, 6, 16), pos(0.03, 10, 6, 1), False, None,
                          1.0),
    }


FAMILIES = _families()


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_draw_latent_matches_draw_flat(ops, case):
    """Every family and clifford route against the port's Python draw on
    the sampling key of the same rng, within 1e-6 relative (the draws are
    the same ATen operations, so they agree bit for bit here)."""
    mu, p2, l2, route, scale = FAMILIES[case]
    fam = case.split("_")[0].rstrip("0123456789")
    rng = torch.tensor(RNG, dtype=torch.int64)
    got = native.draw_latent(rng, mu, p2, fam, l2, route, scale)
    want = draw_flat(trandom.sample_key(RNG), mu, p2, fam, mu.shape[-1], l2,
                     route, scale)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("d,R", [(9, 7), (16, 64)])
def test_clifford_draw_matches_jax(ops, d, R):
    """The keyed and unfused draws against JAX's interpret-mode keyed
    sampler and ``jax.random`` on the split sampling key: v bit for bit,
    u within 2 ulp (as tests/test_torch_sampler.py holds the port's),
    theta and x within 1e-5."""
    g = np.random.default_rng(5 + d * R)
    loc = g.uniform(-np.pi, np.pi, (R, d)).astype(np.float32)
    kap = g.uniform(0.03, 10.0, (R, d)).astype(np.float32)
    key = np.asarray(trandom.sample_key(RNG), np.uint32)
    kp, Rp = _round_up(d - 1, 8), _round_up(R, 8)
    k_u, k_v = jax.random.split(jnp.asarray(key))
    seeds = jnp.concatenate([sp._raw_key_words(k_u), sp._raw_key_words(k_v)])
    loc_pad = jnp.zeros((Rp, kp), jnp.float32).at[:R, : d - 1].set(loc[:, 1:])
    kap_pad = jnp.ones((Rp, kp), jnp.float32).at[:R, : d - 1].set(kap[:, 1:])
    with pltpu.force_tpu_interpret_mode():
        _, th_k, u_k, v_k = sp._keyed_sample_embed_call(
            seeds, loc_pad, kap_pad, d)
        x_k = sp._keyed_sample_torus(jnp.asarray(key), jnp.asarray(loc),
                                     jnp.asarray(kap), d, R)
    u_j = np.asarray(jax.random.uniform(k_u, (R, d), jnp.float32,
                                        minval=1e-12))[:, 1:]
    v_j = np.asarray(jax.random.uniform(k_v, (R, d), jnp.float32))[:, 1:]
    for route in ("keyed", "unfused"):
        x, theta, u, v = torch.ops.cliffordtpu_native.sample_embed(
            torch.tensor(key.astype(np.int64)), torch.from_numpy(loc),
            torch.from_numpy(kap), native.ROUTES[route])
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_k)[:R, : d - 1])
        np.testing.assert_array_equal(v.numpy(), v_j)
        np.testing.assert_array_max_ulp(u.numpy(), u_j, maxulp=2)
        np.testing.assert_allclose(theta.numpy(),
                                   np.asarray(th_k)[:R, : d - 1], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(x.numpy(), np.asarray(x_k), atol=1e-5,
                                   rtol=0)


def test_meta_shapes(ops):
    """The Meta implementations that ``torch.export`` traces with give the
    CPU outputs' shapes and dtypes."""
    mu, p2 = torch.empty(4, 3, 8, device="meta"), torch.empty(4, 3,
                                                              device="meta")
    rng = torch.empty(2, dtype=torch.int64, device="meta")
    z = torch.ops.cliffordtpu_native.draw_latent(rng, mu, p2, 3, 0, 0, 1.0)
    assert z.shape == (4, 48) and z.device.type == "meta"
    z = torch.ops.cliffordtpu_native.draw_latent(rng, mu, p2, 1, 0, -1, 2.0)
    assert z.shape == (4, 24)
    q = torch.empty(2, 9, 2, 8, dtype=torch.bfloat16, device="meta")
    a = torch.ops.cliffordtpu_native.attention_fwd(q, q, q, None, None)
    assert a.shape == q.shape and a.dtype == torch.bfloat16
    outs = torch.ops.cliffordtpu_native.sample_embed(
        rng, torch.empty(5, 7, device="meta"),
        torch.empty(5, 1, device="meta"), 0)
    assert [o.shape for o in outs] == [(5, 14), (5, 6), (5, 6), (5, 6)]


@pytest.mark.parametrize("call,match", [
    (lambda r, m, k: native.draw_latent(r, m, k, "gaussian", False, "keyed",
                                        1.0), "names a route"),
    (lambda r, m, k: torch.ops.cliffordtpu_native.draw_latent(
        r, m, k, 3, 0, 7, 1.0), "unknown route"),
    (lambda r, m, k: torch.ops.cliffordtpu_native.draw_latent(
        r, m, k, 9, 0, -1, 1.0), "unknown family"),
    (lambda r, m, k: torch.ops.cliffordtpu_native.draw_latent(
        torch.tensor([1, 2, 3]), m, k, 0, 0, -1, 1.0), "two uint32 words"),
    (lambda r, m, k: torch.ops.cliffordtpu_native.draw_latent(
        torch.tensor([1, -2]), m, k, 0, 0, -1, 1.0), "2\\*\\*32"),
    (lambda r, m, k: torch.ops.cliffordtpu_native.attention_fwd(
        m[None], m[None, :, :2], m[None], None, None), "one \\(B, S, H, hd\\)"),
])
def test_operator_errors(ops, call, match):
    mu, kap = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    with pytest.raises((RuntimeError, ValueError), match=match):
        call(torch.tensor(RNG), mu, kap)


def test_no_fallback_in_the_build(ops, monkeypatch, tmp_path):
    """The CUDA variant needs nvcc, every variant a C++ compiler; the CPU
    variant has no CUDA implementation, and a process holds one variant."""
    assert native._lib().cliffordtpu_native_has_cuda() == 0
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_native_ops(True)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        build.build_native_ops(False)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path)
        nbuild.build_host(False)
    with pytest.raises(RuntimeError, match="one variant"):
        native.load(True)


def test_launch_counts_and_no_libpython(ops):
    """The CPU variant launches nothing; neither the library nor the host
    links libpython."""
    native.reset_launches()
    native.draw_latent(torch.tensor(RNG), torch.zeros(2, 8),
                       torch.ones(2, 1), "clifford", False, "keyed", 1.0)
    assert native.launch_counts() == {"attention_fwd": 0, "sampler_keyed": 0,
                                      "sampler_rng": 0, "torus_fwd": 0}
    for path in (ops["lib"], ops["host"]):
        text = subprocess.run(["ldd", path], capture_output=True,
                              text=True).stdout
        assert "libtorch_cpu" in text and "libpython" not in text
