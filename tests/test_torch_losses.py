"""The port's VAE losses and test metrics (cliffordtpu_torch/nn/losses.py)
against cliffordtpu/nn/losses.py, and the clifford draw with a
``sample_shape`` that the IWAE bounds take.

Models on parameters of the JAX models' shapes from a numpy seed, carried
across by nn/param_import.py; the same keys on both sides.  Bars: BCE
elementwise 1e-6; every loss piece within 1e-5 of max(1, |value|); the
IWAE bounds and the test metrics within 1e-4 of max(1, |value|) (a
logsumexp over densities of a few hundred nats, in float32); the
clifford draw's uniforms bit for bit and its points within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.distributions import CliffordPowerSphericalDistribution
from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn import losses as jlosses
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu_torch import random
from cliffordtpu_torch.distributions import clifford_torus
from cliffordtpu_torch.kernels import sampler as sampler_kernel
from cliffordtpu_torch.nn import conv_vae, losses, mlp_vae, param_import
from cliffordtpu_torch.nn import vit_vae

torch.set_num_threads(1)

B = 8
N_IWAE = 4
FAMILIES = {"normal": 5, "powerspherical": 6, "vmf": 5, "clifford": 5}


def _params(jmodel, example, seed):
    """Flat params of ``jmodel``'s shapes from a numpy seed."""
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0),
                                          "sample": jax.random.PRNGKey(1)},
                            example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1))
        .astype(np.float32) for k, v in flat.items()}


def _near(got, want, bar):
    got, want = float(got), float(want)
    return abs(got - want) <= bar * max(1.0, abs(want))


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, 784)) * 20).astype(np.float32)
    targets = (rng.uniform(size=(64, 784)) > 0.5).astype(np.float32)
    want = np.asarray(jlosses.bce_with_logits(jnp.asarray(logits),
                                              jnp.asarray(targets)))
    got = losses.bce_with_logits(torch.from_numpy(logits),
                                 torch.from_numpy(targets)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _mlp(dist):
    """A JAX MLPVAE of the family on flat params from a numpy seed, the
    port's model on the same weights, and binarised rows (2B, 784)."""
    jmodel = JaxMLPVAE(h_dim=32, z_dim=FAMILIES[dist], distribution=dist)
    flat = _params(jmodel, jnp.zeros((2, 784)), len(dist))
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    port = mlp_vae.MLPVAE(32, FAMILIES[dist], dist)
    port.load_state_dict(param_import.from_jax(flat))
    x = (np.random.default_rng(1).uniform(size=(2 * B, 784)) > 0.5) \
        .astype(np.float32)
    return jmodel, params, port.eval(), x


@pytest.fixture(scope="module", params=list(FAMILIES))
def mlp(request):
    """One MLPVAE per family: the JAX loss pieces and IWAE bound on carried
    weights, in one jitted call; the port's model."""
    dist = request.param
    jmodel, params, port, x = _mlp(dist)
    rng, iwae_key = jax.random.PRNGKey(2), jax.random.PRNGKey(3)

    @jax.jit
    def pieces(p, x):
        out = jmodel.apply({"params": p}, x, rngs={"sample": rng})
        return (jlosses.vae_loss_from_outputs(x, out, beta=0.7),
                jlosses.iwae_log_likelihood(iwae_key, jmodel, p, x, N_IWAE))

    want_loss, want_iwae = jax.device_get(pieces(params, x[:B]))
    return dict(dist=dist, x=x, rng=np.asarray(rng),
                iwae_key=np.asarray(iwae_key), loss=want_loss,
                iwae=want_iwae, port=port)


def test_vae_loss_from_outputs_matches_jax(mlp):
    x = torch.from_numpy(mlp["x"][:B])
    with torch.no_grad():
        got = losses.vae_loss_from_outputs(
            x, mlp["port"](x, random.sample_key(mlp["rng"])), beta=0.7)
    assert set(got) == set(mlp["loss"])
    for k, v in mlp["loss"].items():
        assert _near(got[k], v, 1e-5), (k, float(got[k]), float(v))


def test_iwae_log_likelihood_matches_jax(mlp):
    got = losses.iwae_log_likelihood(mlp["iwae_key"], mlp["port"],
                                     torch.from_numpy(mlp["x"][:B]), N_IWAE)
    assert got.dim() == 0 and _near(got, mlp["iwae"], 1e-4), (
        float(got), float(mlp["iwae"]))


def test_compute_test_metrics_matches_jax():
    """Two batches of the clifford model, batch i on split(fold_in(key,
    i)) (the other families' pieces and bounds are held above; JAX runs
    this function op by op, seconds a family)."""
    jmodel, params, port, x = _mlp("clifford")
    batches = [(x[:B], None), (x[B:], None)]
    want = jlosses.compute_test_metrics(jax.random.PRNGKey(4), jmodel,
                                        params, batches, N_IWAE)
    got = losses.compute_test_metrics(np.asarray(jax.random.PRNGKey(4)),
                                      port, batches, N_IWAE)
    assert set(got) == set(want)
    for k, v in want.items():
        assert _near(got[k], v, 1e-4), (k, got[k], v)


def test_clifford_draw_with_a_sample_shape_is_jaxs():
    """With a ``sample_shape`` the draw takes the unfused route on any
    ``sampler``: u and v of shape sample_shape + loc's from the split key
    bit for bit, and the same torus points."""
    rng = np.random.default_rng(5)
    loc = rng.uniform(-np.pi, np.pi, (4, 5)).astype(np.float32)
    kappa = rng.uniform(0.03, 10.0, (4, 1)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jq = CliffordPowerSphericalDistribution(jnp.asarray(loc),
                                            jnp.asarray(kappa))
    want = np.asarray(jax.jit(lambda k: jq.sample(k, (3,)))(key))
    k_u, k_v = jax.random.split(key)
    ju = np.asarray(jax.random.uniform(k_u, (3, 4, 5), minval=1e-12))
    jv = np.asarray(jax.random.uniform(k_v, (3, 4, 5)))
    tk_u, tk_v = random.split_words(np.asarray(key))
    tu = random.uniform(tk_u, (3, 4, 5), minval=sampler_kernel.U_MIN)
    tv = random.uniform(tk_v, (3, 4, 5))
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tv.numpy(), jv)
    tq = clifford_torus.CliffordPowerSphericalDistribution(
        torch.from_numpy(loc), torch.from_numpy(kappa))
    for sampler in clifford_torus.SAMPLERS:
        got = tq.sample(np.asarray(key), (3,), sampler=sampler)
        assert torch.equal(got, tq.sample_from_uniforms(tu, tv))
        assert got.shape == want.shape == (3, 4, 10)
        assert np.abs(got.numpy() - want).max() <= 1e-6
    # without a sample_shape nothing changed: one draw of loc's shape
    assert tq.sample(np.asarray(key)).shape == (4, 10)


CNN_CASES = [("cnn", "clifford", False, "l1"), ("cnn", "gaussian", True, "mse"),
             ("vit", "powerspherical", False, "l1")]


@pytest.mark.parametrize("case", CNN_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_iwae_log_likelihood_cnn_matches_jax(case):
    """``CNNVAE`` (latent 16) and the tiny ``CliffordARVAE`` (the per-token
    sum and the sqrt(d) scale folded into the decoder)."""
    family, dist, l2, recon = case
    if family == "cnn":
        jmodel = jconv.CNNVAE(latent_dim=16, in_channels=1, distribution=dist,
                              l2_normalize=l2, img_size=32)
        port = conv_vae.CNNVAE(16, 1, distribution=dist, l2_normalize=l2)
    else:
        jmodel = graft._flagship(tiny=True).clone(distribution=dist)
        port = vit_vae.CliffordARVAE(
            latent_dim=8, image_size=32, in_channels=1, distribution=dist,
            cnn_chs=[16, 32, 64], z_channels=64, encoder_vit_layers=1,
            decoder_vit_layers=2, patch_size=4)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 1)) \
        .astype(np.float32)
    flat = _params(jmodel, jnp.zeros((2, 32, 32, 1)), 8 + len(dist))
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda p, x: jlosses.iwae_log_likelihood_cnn(
        key, jmodel, p, x, 3, recon))(params, x)
    port.load_state_dict(param_import.from_jax(flat, dist))
    got = losses.iwae_log_likelihood_cnn(np.asarray(key), port.eval(),
                                         torch.from_numpy(x), 3, recon)
    assert _near(got, want, 1e-4), (float(got), float(want))
