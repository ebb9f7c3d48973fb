"""The port's VAE loss (cliffordtpu_torch/nn/conv_vae.py) and (q_z, p_z)
construction (nn/reparam.py) against cliffordtpu/nn/conv_vae.py and
nn/reparam.py on the same arrays: each of the five outputs < 1e-4 of its
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn.reparam import reparameterize as jax_reparameterize
from cliffordtpu_torch.distributions.clifford_torus import (
    CliffordPowerSphericalDistribution,
)
from cliffordtpu_torch.distributions.uniforms import CliffordTorusUniform
from cliffordtpu_torch.nn import conv_vae, vit_vae
from cliffordtpu_torch.nn.reparam import reparameterize

torch.set_num_threads(1)

KEYS = {"total_loss", "recon_loss", "kld_loss", "entropy", "effective_beta"}
B, T, D = 3, 64, 8


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32)
    x_recon = (x + 0.3 * rng.normal(size=x.shape)).astype(np.float32)
    mu = rng.uniform(-np.pi, np.pi, (B, T, D)).astype(np.float32)
    kappa = rng.uniform(0.03, 10.0, (B, T)).astype(np.float32)
    return x, x_recon, mu, kappa


@pytest.mark.parametrize("recon,beta,l1_weight", [("l1", 1.0, 1.0),
                                                  ("l1", 0.7, 2.5),
                                                  ("mse", 0.25, 1.0)])
def test_cnn_vae_loss_matches_jax(recon, beta, l1_weight):
    x, x_recon, mu, kappa = _arrays()
    jq, jp = jax_reparameterize(
        "clifford", jnp.asarray(mu),
        jnp.broadcast_to(jnp.asarray(kappa)[..., None], mu.shape), D)
    want = jconv.cnn_vae_loss(jnp.asarray(x), jnp.asarray(x_recon), jq, jp,
                              "clifford", beta=beta, recon_loss_type=recon,
                              l1_weight=l1_weight)
    q, p = reparameterize("clifford", torch.from_numpy(mu),
                          torch.from_numpy(kappa)[..., None].expand(B, T, D),
                          D)
    assert isinstance(q, CliffordPowerSphericalDistribution)
    assert isinstance(p, CliffordTorusUniform) and p.dim == D
    got = conv_vae.cnn_vae_loss(torch.from_numpy(x),
                                torch.from_numpy(x_recon), q, p, "clifford",
                                beta=beta, recon_loss_type=recon,
                                l1_weight=l1_weight)
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        w = float(want[k])
        assert got[k].shape == () and got[k].dtype == torch.float32
        assert abs(float(got[k]) - w) < 1e-4 * max(1.0, abs(w)), k


def test_loss_takes_beta_as_a_tensor_and_carries_the_gradient():
    x, x_recon, mu, kappa = _arrays(1)
    kap = torch.from_numpy(kappa).requires_grad_()
    xr = torch.from_numpy(x_recon).requires_grad_()
    q, p = reparameterize("clifford", torch.from_numpy(mu),
                          kap[..., None].expand(B, T, D), D)
    out = conv_vae.cnn_vae_loss(torch.from_numpy(x), xr, q, p, "clifford",
                                beta=torch.tensor(0.5))
    assert float(out["effective_beta"]) == 0.5
    out["total_loss"].backward()
    assert xr.grad.abs().max() > 0 and kap.grad.abs().max() > 0
    assert not out["entropy"].requires_grad  # reported only


def test_concentration_floor_schedule_matches_jax():
    for d in (2, 16, 255, 256, 512, 513, 1024, 1025, 2048, 2049, 4096):
        assert conv_vae.clifford_concentration_floor(d) == \
            jconv.clifford_concentration_floor(d)


@pytest.mark.parametrize("recon", ["l1", "mse"])
def test_sigma_form_of_the_loss_matches_jax(recon):
    """The learnable-beta form recon / s0^2 + KL / s1^2 + s0^2 + s1^2 with
    its seven outputs, each < 1e-4 of its magnitude; beta is not used; the
    gradient reaches the log-sigmas."""
    x, x_recon, mu, kappa = _arrays(4)
    log_sigmas = np.array([[0.3], [-0.2]], np.float32)
    jq, jp = jax_reparameterize(
        "clifford", jnp.asarray(mu),
        jnp.broadcast_to(jnp.asarray(kappa)[..., None], mu.shape), D)
    want = jconv.cnn_vae_loss(
        jnp.asarray(x), jnp.asarray(x_recon), jq, jp, "clifford", beta=0.5,
        recon_loss_type=recon,
        sigmas=tuple(jnp.exp(jnp.asarray(s)) for s in log_sigmas))
    q, p = reparameterize("clifford", torch.from_numpy(mu),
                          torch.from_numpy(kappa)[..., None].expand(B, T, D),
                          D)
    ls = [torch.from_numpy(s.copy()).requires_grad_() for s in log_sigmas]
    got = conv_vae.cnn_vae_loss(
        torch.from_numpy(x), torch.from_numpy(x_recon), q, p, "clifford",
        beta=123.0, recon_loss_type=recon,
        sigmas=tuple(torch.exp(s) for s in ls))
    assert set(got) == set(want) == KEYS | {"sigma_0", "sigma_1"}
    for k in got:
        w = float(want[k])
        assert got[k].shape == ()
        assert abs(float(got[k].detach()) - w) < 1e-4 * max(1.0, abs(w)), k
    assert float(got["effective_beta"].detach()) == pytest.approx(
        np.exp(2 * (0.3 + 0.2)), rel=1e-6)
    got["total_loss"].backward()
    assert all(s.grad.abs().item() > 0 for s in ls)


def test_models_give_their_loss_sigmas():
    """``use_learnable_beta`` adds two zero-initialised (1,) parameters to
    either family; ``loss_sigmas`` is their exponential, or (None, None)."""
    ar = vit_vae.CliffordARVAE(latent_dim=4, image_size=32, in_channels=1,
                               cnn_chs=[8, 16, 64], z_channels=64,
                               encoder_vit_layers=1, decoder_vit_layers=1,
                               use_learnable_beta=True)
    cnn = conv_vae.CNNVAE(8, 1, use_learnable_beta=True)
    for model in (ar, cnn):
        names = [n for n, _ in model.named_parameters() if "log_sigma" in n]
        assert names == ["log_sigma_0", "log_sigma_1"]
        s0, s1 = model.loss_sigmas()
        assert s0.shape == s1.shape == (1,) and s0.requires_grad
        assert float(s0.detach()) == float(s1.detach()) == 1.0
    assert conv_vae.CNNVAE(8, 1).loss_sigmas() == (None, None)
    assert not any("log_sigma" in n for n, _ in conv_vae.CNNVAE(
        8, 1).named_parameters())


def test_paths_not_ported_yet_raise():
    x, x_recon, mu, kappa = _arrays(2)
    q, p = reparameterize("clifford", torch.from_numpy(mu),
                          torch.from_numpy(kappa)[..., None], D)
    args = (torch.from_numpy(x), torch.from_numpy(x_recon), q, p)
    # every latent is ported now: what still raises is an unknown
    # reconstruction loss, latent or model head
    with pytest.raises(ValueError):
        conv_vae.cnn_vae_loss(*args, "clifford", recon_loss_type="bce")
    with pytest.raises(ValueError, match="unknown distribution"):
        reparameterize("beta", torch.from_numpy(mu), torch.from_numpy(kappa),
                       D)
    # CliffordARVAE takes vmf as the JAX module does; CNNVAE has no vmf
    # head, in the JAX package either
    with pytest.raises(ValueError, match="distribution"):
        conv_vae.CNNVAE(latent_dim=4, in_channels=1, distribution="vmf")
