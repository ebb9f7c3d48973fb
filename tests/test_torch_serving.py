"""The slice as a whole: the port's serving entry points
(cliffordtpu_torch/serving.py) on the tiny flagship model, with the JAX
model's own initial params carried across, against cliffordtpu/serving.py's
``serving_fns`` (jitted, as the JAX package serves them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.serving import (
    _dequantize_flat,
    _flatten_params,
    _quantize_flat,
    serving_fns,
)
from cliffordtpu_torch import serving
from cliffordtpu_torch.kernels import attention, sampler
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMG = (32, 32, 1)


def _tiny_port():
    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4)


@pytest.fixture(scope="module")
def jax_model():
    model = graft._flagship(tiny=True)
    x = jnp.zeros((2, *IMG))
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                     "sample": jax.random.PRNGKey(1)}, x)
    return model, variables["params"]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (3, *IMG)).astype(np.float32)


@pytest.fixture(scope="module")
def port(jax_model):
    _, params = jax_model
    flat = _flatten_params(jax.device_get(params))
    return serving.CliffordARServing(_tiny_port(), params=flat, device="cpu")


def test_encode_mu_matches_jax(jax_model, port, images):
    model, params = jax_model
    want = np.asarray(jax.jit(serving_fns(model, IMG)["encode_mu"])(
        params, images))
    got = port.encode_mu(images).numpy()
    assert got.shape == want.shape == (3, 64 * 8)
    assert np.abs(got - want).max() < 5e-4


def test_decode_matches_jax(jax_model, port):
    model, params = jax_model
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, 64 * 16)).astype(np.float32)
    want = np.asarray(jax.jit(serving_fns(model, IMG)["decode"])(params, z))
    got = port.decode(z).numpy()
    assert got.shape == want.shape == (3, *IMG)
    assert np.abs(got - want).max() < 5e-4


def test_encode_z_matches_jax_with_the_sampling_key(jax_model, port, images):
    """JAX's entry point takes the rng of ``model.apply`` and derives the
    sampling key with make_rng("sample"); the port takes that sampling key.
    Encoder error passes through the sampler, hence 1e-3."""
    model, params = jax_model
    rng = jax.random.PRNGKey(42)
    want = np.asarray(jax.jit(serving_fns(model, IMG)["encode_z"])(
        params, rng, images))
    sample_key = model.apply({"params": params}, rngs={"sample": rng},
                             method=lambda m: m.make_rng("sample"))
    before = (attention.launches, sampler.launches)
    got = port.encode_z(np.asarray(sample_key), images).numpy()
    assert got.shape == want.shape == (3, 64 * 16)
    assert np.abs(got - want).max() <= 1e-3
    # the plain versions ran: a CPU run launches no kernel
    assert (attention.launches, sampler.launches) == before


def test_load_params_npz_round_trip(jax_model, port, images, tmp_path):
    """A params.npz written in JAX's flat format loads into the same
    serving outputs."""
    _, params = jax_model
    flat = _flatten_params(jax.device_get(params))
    np.savez(tmp_path / "params.npz", **flat)
    loaded = serving.load_params_npz(tmp_path / "params.npz")
    assert loaded.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k])
    again = serving.CliffordARServing(_tiny_port(), params=loaded,
                                      device="cpu")
    np.testing.assert_array_equal(again.encode_mu(images).numpy(),
                                  port.encode_mu(images).numpy())


def test_quantized_npz_and_foreign_trees_are_refused(jax_model, tmp_path):
    """A quantized params.npz that the JAX package wrote loads and equals
    JAX's own dequantization (its refusal is gone since the storage modes
    are ported); a tree with a key of no port parameter is refused."""
    _, params = jax_model
    flat = _flatten_params(jax.device_get(params))
    for mode in ("bfloat16", "int8"):
        stored = _quantize_flat(flat, mode)
        np.savez(tmp_path / "q.npz", **stored)
        got = serving.load_params_npz(tmp_path / "q.npz")
        want = _dequantize_flat(stored)
        assert got.keys() == want.keys() == flat.keys()
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    with pytest.raises(ValueError):
        serving.CliffordARServing(
            _tiny_port(), params={**flat, "extra/kernel": np.zeros(1)},
            device="cpu")


def test_one_serving_class_and_the_sampler_routes(port, images):
    """``CliffordARServing`` is ``Serving``, which serves either family;
    ``sampler=`` reaches the draw: "unfused" gives the keyed draw's u and v
    and so its latents, "rng" another stream on the same torus."""
    assert serving.CliffordARServing is serving.Serving
    key = (0, 9)
    keyed = port.encode_z(key, images)
    assert torch.equal(keyed, port.encode_z(key, images, sampler="keyed"))
    np.testing.assert_allclose(
        port.encode_z(key, images, sampler="unfused").numpy(), keyed.numpy(),
        atol=1e-6)
    z = port.encode_z(key, images, sampler="rng")
    assert torch.equal(z, port.encode_z(key, images, sampler="rng"))
    assert not torch.equal(z, port.encode_z((0, 10), images, sampler="rng"))
    assert not torch.allclose(z, keyed, atol=1e-3)
    np.testing.assert_allclose(z.reshape(3, 64, 16).norm(dim=-1).numpy(), 1.0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="sampler"):
        port.encode_z(key, images, sampler="pallas_rng")
