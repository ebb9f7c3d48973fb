"""The gaussian and powerspherical heads of the port's models, the vmf
head of ``CliffordARVAE``, the KL of every pair and ``reparameterize`` for
every latent, against the JAX package:
cliffordtpu/nn/{reparam,conv_vae,vit_vae}.py and
cliffordtpu/distributions/kl.py.

The models run at tiny widths (``CNNVAE`` at latent 16; the
``__graft_entry__._flagship(tiny=True)`` ``CliffordARVAE``: latent 8, one
head of 64, 1 + 2 blocks) on parameters of the JAX model's shapes, drawn
from a numpy seed and carried across by nn/param_import.py, with the
sampling key the JAX model derives.  Bars: heads, latents and images
< 5e-4; loss pieces 1e-4 of max(1, |value|); every parameter's gradient
within 5e-4 of the global gradient norm against ``jax.grad``; the KL of
every pair within 1e-5 of max(1, |KL|)
(``test_torch_distributions.py::_close``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu import distributions as jd
from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn import reparam as jreparam
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu_torch import serving
from cliffordtpu_torch.distributions import clifford_torus as tct
from cliffordtpu_torch.distributions import kl as tkl
from cliffordtpu_torch.distributions import normal as tnormal
from cliffordtpu_torch.distributions import power_spherical as tps
from cliffordtpu_torch.distributions import uniforms as tuni
from cliffordtpu_torch.distributions import von_mises_fisher as tvmf
from cliffordtpu_torch.distributions import reparam
from cliffordtpu_torch.nn import conv_vae, param_import, vit_vae

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 6
B = 2
IMG = (32, 32, 1)
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}


def _close(got, want, bar=1e-5):
    return np.abs(got - want).max() < bar * max(1.0, np.abs(want).max())


def _unit(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _kl_pairs(rng):
    """(JAX q, JAX p, port q, port p) of every registered pair."""
    d = 6
    loc = _unit(rng, (N, d))
    kap = rng.uniform(0.1, 10.0, N).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    kaps = rng.uniform(0.0, 10.0, (N, d)).astype(np.float32)
    mu = rng.normal(size=(N, d)).astype(np.float32)
    sd = rng.uniform(0.1, 3.0, (N, d)).astype(np.float32)
    mu2 = rng.normal(size=(N, d)).astype(np.float32)
    sd2 = rng.uniform(0.5, 2.0, (N, d)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    return {
        "powerspherical": (jd.PowerSpherical(j(loc), j(kap)),
                           jd.HypersphericalUniform(d),
                           tps.PowerSpherical(t(loc), t(kap)),
                           tuni.HypersphericalUniform(d)),
        "vmf": (jd.VonMisesFisher(j(loc), j(kap[:, None])),
                jd.VMFHypersphericalUniform(d - 1),
                tvmf.VonMisesFisher(t(loc), t(kap[:, None])),
                tuni.VMFHypersphericalUniform(d - 1)),
        "clifford_vm": (jd.CliffordTorusDistribution(j(ang), j(kaps)),
                        jd.CliffordTorusUniform(d),
                        tct.CliffordTorusDistribution(t(ang), t(kaps)),
                        tuni.CliffordTorusUniform(d)),
        "clifford_ps": (jd.CliffordPowerSphericalDistribution(j(ang),
                                                              j(kaps)),
                        jd.CliffordTorusUniform(d),
                        tct.CliffordPowerSphericalDistribution(t(ang),
                                                               t(kaps)),
                        tuni.CliffordTorusUniform(d)),
        "normal": (jd.Normal(j(mu), j(sd)), jd.Normal(j(mu2), j(sd2)),
                   tnormal.Normal(t(mu), t(sd)),
                   tnormal.Normal(t(mu2), t(sd2))),
    }


def test_every_kl_pair_matches_jax():
    pairs = _kl_pairs(np.random.default_rng(0))
    assert {(type(q), type(p)) for _, _, q, p in pairs.values()} == set(
        tkl._KL_REGISTRY)
    for name, (jq, jp, tq, tp) in pairs.items():
        want = np.asarray(jd.kl_divergence(jq, jp))
        got = tkl.kl_divergence(tq, tp).numpy()
        assert got.shape == want.shape, name
        assert _close(got, want), name


@pytest.mark.parametrize("dist", ["normal", "gaussian", "powerspherical",
                                  "vmf", "clifford"])
def test_reparameterize_and_sample_latent_match_jax(dist):
    """(q_z, p_z) of every branch, and one draw with the same key (the
    Gaussian one with and without the l2 step): the powerspherical head's
    (N, 1) concentration is squeezed, the vMF prior takes z_dim - 1."""
    d = 5
    rng = np.random.default_rng(len(dist))
    mu = rng.normal(size=(N, d)).astype(np.float32)
    if dist in ("powerspherical", "vmf"):
        mu = _unit(rng, (N, d))
    p2 = rng.uniform(0.2, 8.0, (N, 1 if dist != "clifford" else d)) \
        .astype(np.float32)
    if dist in ("normal", "gaussian"):
        p2 = rng.normal(size=(N, d)).astype(np.float32)
    jq, jp = jreparam.reparameterize(dist, jnp.asarray(mu), jnp.asarray(p2),
                                     d)
    tq, tp = reparam.reparameterize(dist, torch.from_numpy(mu),
                                    torch.from_numpy(p2), d)
    assert type(tq).__name__ == type(jq).__name__
    assert type(tp).__name__ == type(jp).__name__
    assert _close(tkl.kl_divergence(tq, tp).numpy(),
                  np.asarray(jd.kl_divergence(jq, jp)))
    key = jax.random.PRNGKey(7)
    for l2 in ((False, True) if dist in ("normal", "gaussian") else
               (False,)):
        want = np.asarray(jax.jit(lambda k, q, l2=l2: jreparam.sample_latent(
            k, dist, q, l2))(key, jq))
        got = reparam.sample_latent(np.asarray(key), dist, tq, l2)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5
    if dist != "clifford":
        with pytest.raises(ValueError, match="sampler"):
            reparam.sample_latent(np.asarray(key), dist, tq, sampler="keyed")


def _random_params(module, example, seed):
    """Flat params of ``module``'s shapes (no initialiser is run)."""
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


def _jax_model(family, dist, l2):
    if family == "cnn":
        return jconv.CNNVAE(latent_dim=16, in_channels=1, distribution=dist,
                            l2_normalize=l2, img_size=32)
    return graft._flagship(tiny=True).clone(distribution=dist,
                                            l2_normalize=l2)


def _port_model(family, dist, l2):
    if family == "cnn":
        return conv_vae.CNNVAE(16, 1, distribution=dist, l2_normalize=l2)
    return vit_vae.CliffordARVAE(
        latent_dim=8, image_size=32, in_channels=1, distribution=dist,
        l2_normalize=l2, cnn_chs=[16, 32, 64], z_channels=64,
        encoder_vit_layers=1, decoder_vit_layers=2, patch_size=4)


CONFIGS = [("cnn", "gaussian", False), ("cnn", "gaussian", True),
           ("cnn", "powerspherical", False), ("vit", "gaussian", False),
           ("vit", "powerspherical", False)]
# the vmf head of CliffordARVAE (the JAX module reads it as its clifford
# head: raw means, a floored concentration (B, T) into VonMisesFisher);
# CNNVAE has none
VMF_CONFIGS = [("vit", "vmf", False)]


@pytest.fixture(scope="module", params=CONFIGS + VMF_CONFIGS,
                ids=lambda c: "-".join(map(str, c)))
def pair(request):
    """The JAX side of one model and head, computed in one jitted call:
    the heads, the sampled latent, a decode, and the loss pieces with
    their gradients; the port's model on the same parameters."""
    family, dist, l2 = request.param
    jmodel = _jax_model(family, dist, l2)
    flat = _random_params(jmodel, jnp.zeros((B, *IMG)),
                          len(CONFIGS) * (family == "vit") + len(dist) + l2)
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, *IMG)).astype(np.float32)
    rng_key = jax.random.PRNGKey(42)
    sample_key = np.asarray(jmodel.apply(
        {"params": params}, rngs={"sample": rng_key},
        method=lambda m: m.make_rng("sample")))

    def loss_fn(p, x):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": p}, x,
                                            rngs={"sample": rng_key})
        losses = jconv.cnn_vae_loss(x, x_recon, q_z, p_z, dist, beta=0.7)
        return losses["total_loss"], losses

    def heads_and_latent(m, x):
        """``encode_heads`` and ``get_flat_latent`` on one encoder pass."""
        heads = m.encode_heads(x)
        z = m.reparam(*heads)[0]
        return heads, z.reshape(z.shape[0], -1)

    @jax.jit
    def everything(p, x):
        heads, z = jmodel.apply({"params": p}, x, rngs={"sample": rng_key},
                                method=heads_and_latent)
        grads, losses = jax.grad(loss_fn, has_aux=True)(p, x)
        return heads, z, jmodel.apply({"params": p}, z * 0.5,
                                      method=jmodel.decode), grads, losses

    heads, z, img, grads, losses = jax.device_get(everything(params, x))
    port = _port_model(family, dist, l2)
    port.load_state_dict(param_import.from_jax(flat, dist))
    return dict(family=family, dist=dist, flat=flat, x=x, key=sample_key,
                heads=heads, z=z, img=img, grads=grads, losses=losses,
                port=port.eval())


def test_heads_latent_and_decode_match_jax(pair):
    port, x = pair["port"], torch.from_numpy(pair["x"])
    with torch.no_grad():
        heads = port.encode_heads(x)
        z = port.get_flat_latent(x, pair["key"])
        img = port.decode(z * 0.5)
    for got, want in zip(heads, pair["heads"]):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() < 5e-4
    assert z.shape == pair["z"].shape
    assert np.abs(z.numpy() - pair["z"]).max() < 5e-4
    assert img.shape == pair["img"].shape == (B, *IMG)
    assert np.abs(img.numpy() - pair["img"]).max() < 5e-4
    if pair["dist"] == "powerspherical":
        per = z.reshape(B, -1, port.latent_dim).norm(dim=-1)
        scale = port.latent_dim ** 0.5 if pair["family"] == "vit" else 1.0
        np.testing.assert_allclose(per.numpy(), scale, rtol=1e-4)


def test_loss_pieces_and_every_gradient_match_jax_grad(pair):
    port, x = pair["port"], torch.from_numpy(pair["x"])
    port.train()
    port.zero_grad()
    x_recon, q_z, p_z, _ = port(x, pair["key"])
    got = conv_vae.cnn_vae_loss(x, x_recon, q_z, p_z, pair["dist"],
                                beta=0.7)
    assert set(got) == set(pair["losses"])
    for k, v in pair["losses"].items():
        assert abs(float(got[k].detach()) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v))), k
    got["total_loss"].backward()
    want = param_import.from_jax(_flatten_params(pair["grads"]),
                                 pair["dist"])
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    norm = float(optax.global_norm(pair["grads"]))
    for name, p in named.items():
        assert (p.grad - want[name]).abs().max().item() <= 5e-4 * norm, name


def test_serving_refuses_a_sampler_for_these_heads(pair):
    """``Serving`` on the carried parameters answers as the model does,
    and ``sampler=`` for a latent with one route raises."""
    srv = serving.Serving(_port_model(pair["family"], pair["dist"],
                                      False if pair["dist"] != "gaussian"
                                      else pair["port"].l2_normalize),
                          params=pair["flat"], device="cpu")
    np.testing.assert_array_equal(srv.encode_z(pair["key"], pair["x"])
                                  .numpy(), pair["port"].get_flat_latent(
                                      torch.from_numpy(pair["x"]),
                                      pair["key"]).detach().numpy())
    with pytest.raises(ValueError, match="sampler"):
        srv.encode_z(pair["key"], pair["x"], sampler="keyed")
