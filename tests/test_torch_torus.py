"""The port's torus embedding (cliffordtpu_torch/ops/torus.py) against
cliffordtpu/ops/torus.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.ops import torus as jtorus
from cliffordtpu_torch.ops import torus as ttorus

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _wrapped_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


@pytest.mark.parametrize("d", [2, 16, 513])
def test_angles_to_torus_matches_jax(d):
    """d = 513 takes the device-made int32-phase bases on both sides."""
    th = np.random.default_rng(d).uniform(-np.pi, np.pi, (5, d))
    th = th.astype(np.float32)
    want = np.asarray(jtorus.angles_to_torus(jnp.asarray(th),
                                             method="matmul"))
    got = ttorus.angles_to_torus(torch.from_numpy(th)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # Parseval: every torus point has unit norm
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("d", [2, 16, 513])
def test_torus_to_angles_matches_jax(d):
    """On generic points (angles compared modulo 2 pi) and on the round
    trip, where angles 1..d-1 come back wrapped and angle 0 is pinned."""
    rng = np.random.default_rng(100 + d)
    x = rng.normal(size=(5, 2 * d)).astype(np.float32)
    want = np.asarray(jtorus.torus_to_angles(jnp.asarray(x), method="matmul"))
    got = ttorus.torus_to_angles(torch.from_numpy(x)).numpy()
    assert _wrapped_diff(got, want).max() < 1e-5

    th = rng.uniform(-3.0, 3.0, (5, d)).astype(np.float32)
    back = ttorus.torus_to_angles(
        ttorus.angles_to_torus(torch.from_numpy(th))).numpy()
    assert _wrapped_diff(back[:, 1:], th[:, 1:]).max() < 1e-4
    assert np.abs(back[:, 0]).max() < 1e-4


def test_wrap_angle_matches_jax():
    th = np.linspace(-20, 20, 101).astype(np.float32)
    want = np.asarray(jtorus.wrap_angle(jnp.asarray(th)))
    got = ttorus.wrap_angle(torch.from_numpy(th)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dims_outside_the_matmul_range_raise():
    """Above the matmul range ``"auto"`` takes the FFT form, as the JAX
    package does (it raised before the FFT form was ported); an unknown
    method raises."""
    th = torch.zeros(1, ttorus.MATMUL_MAX_DIM + 1)
    np.testing.assert_allclose(
        ttorus.angles_to_torus(th).numpy(),
        ttorus.angles_to_torus(th, method="fft").numpy(), atol=0)
    with pytest.raises(ValueError, match="method"):
        ttorus.angles_to_torus(th, method="pallas")
    with pytest.raises(ValueError, match="method"):
        ttorus.torus_to_angles(torch.zeros(1, 8), method="dft")


@pytest.mark.parametrize("method", ["fft", "auto"])
def test_fft_form_at_d8192_matches_jax(method):
    """d 8192, R 2: both directions against the JAX package's ``jnp.fft``
    form (its "auto" above 4096), <= 1e-5, the angles (modulo 2 pi) read
    back from torus points, where every frequency has modulus 1; the round
    trip returns angles 1..d-1."""
    d = 8192
    rng = np.random.default_rng(8192)
    th = rng.uniform(-np.pi, np.pi, (2, d)).astype(np.float32)
    want = np.asarray(jtorus.angles_to_torus(jnp.asarray(th), method="fft"))
    got = ttorus.angles_to_torus(torch.from_numpy(th), method=method).numpy()
    assert got.shape == want.shape == (2, 2 * d)
    assert np.abs(got - want).max() <= 1e-5
    x = np.array(want)
    want = np.asarray(jtorus.torus_to_angles(jnp.asarray(x), method="fft"))
    back = ttorus.torus_to_angles(torch.from_numpy(x), method=method).numpy()
    assert back.shape == want.shape == (2, d)
    assert _wrapped_diff(back, want).max() <= 1e-5
    assert _wrapped_diff(back[:, 1:], th[:, 1:]).max() < 1e-4


def test_fft_form_matches_the_matmul_form_and_differentiates():
    """At d 64 the two forms agree, and so do their gradients."""
    th = torch.from_numpy(np.random.default_rng(3).uniform(
        -np.pi, np.pi, (3, 64)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 128)).astype(np.float32))
    outs = [ttorus.angles_to_torus(th, method=m) for m in ("matmul", "fft")]
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    grads = [torch.autograd.grad(o, th, g)[0] for o in outs]
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-5
