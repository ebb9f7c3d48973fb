"""The port's HybridVAE (cliffordtpu_torch/nn/hybrid_vae.py) against
cliffordtpu/nn/hybrid_vae.py on the same parameters, carried by
nn/param_import.py::hybridvae_from_jax: the heads, the sampled latent, a
decode, every loss piece and every gradient (d kappa through the (B, T)
-> (B, T, d) broadcast included), AdamW steps through
make_cnn_train_step, the three Serving entry points, and which JAX
latent names run or raise.  Then ``param_import.from_jax`` routes a tree
of each of the four families.  Tiny config: channels [8, 16], 8 px, 16
tokens, latent 4, batch 3, float32.  Bars: 5e-4 for whole stacks, 1e-4
relative per loss piece, 5e-4 of the global gradient norm per
parameter's gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn import hybrid_vae as jhybrid
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params, serving_fns
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch import serving
from cliffordtpu_torch.kernels import sampler, torus
from cliffordtpu_torch.nn import (
    conv_vae,
    hybrid_vae,
    mlp_vae,
    param_import,
    vit_vae,
)
from cliffordtpu_torch.train.loop import make_cnn_train_step
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)

LATENT = 4
B = 3
IMG = 8
CHS = [8, 16]
T = 16  # (8 / 2) ** 2 tokens
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}


def _random_params(module, example, seed):
    """Flat params of ``module``'s shapes, drawn from a numpy seed (no
    initialiser is run): kernels at 1 / sqrt(fan-in), the rest at 0.1."""
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


def _tree(flat):
    return _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _jax_model(dist, learn=False):
    return jhybrid.HybridVAE(latent_dim=LATENT, in_channels=1,
                             distribution=dist, encoder_chs=CHS,
                             img_size=IMG, use_learnable_beta=learn)


def _port_model(dist, learn=False):
    return hybrid_vae.HybridVAE(latent_dim=LATENT, in_channels=1,
                                distribution=dist, encoder_chs=CHS,
                                img_size=IMG, use_learnable_beta=learn)


def _images(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, IMG, IMG, 1)).astype(np.float32)


HEADS = ["clifford", "gaussian", "powerspherical"]


@pytest.fixture(scope="module", params=HEADS)
def pair(request):
    """The JAX side in one jitted call: the heads, the sampled flat latent,
    a decode, the loss pieces with their gradients and d kappa of a
    clifford draw; the port's model on the same parameters."""
    dist = request.param
    jmodel = _jax_model(dist)
    flat = _random_params(jmodel, jnp.zeros((B, IMG, IMG, 1)),
                          HEADS.index(dist))
    params = _tree(flat)
    x = _images(3)
    rng_key = jax.random.PRNGKey(42)
    sample_key = np.asarray(jmodel.apply(
        {"params": params}, rngs={"sample": rng_key},
        method=lambda m: m.make_rng("sample")))
    g = np.random.default_rng(4).normal(size=(B, T, 2 * LATENT)).astype(
        np.float32)

    def loss_fn(p, x):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": p}, x,
                                            rngs={"sample": rng_key})
        losses = jconv.cnn_vae_loss(x, x_recon, q_z, p_z, dist, beta=0.7)
        return losses["total_loss"], losses

    def draw_dot(kappa, p, mu):
        z = jmodel.apply({"params": p}, mu, kappa, rngs={"sample": rng_key},
                         method=lambda m, mu, k: m.reparam(mu, k)[0])
        return jnp.sum(z * g)

    @jax.jit
    def everything(p, x):
        heads = jmodel.apply({"params": p}, x, method=jmodel.encode_heads)
        z = jmodel.apply({"params": p}, x, rngs={"sample": rng_key},
                         method=jmodel.get_flat_latent)
        img = jmodel.apply({"params": p}, z * 0.5, method=jmodel.decode)
        grads, losses = jax.grad(loss_fn, has_aux=True)(p, x)
        dkappa = (jax.grad(draw_dot)(heads[1], p, heads[0])
                  if dist == "clifford" else None)
        return heads, z, img, grads, losses, dkappa

    out = jax.device_get(everything(params, jnp.asarray(x)))
    port = _port_model(dist)
    port.load_state_dict(param_import.hybridvae_from_jax(flat))
    return dict(zip(("heads", "z", "img", "grads", "losses", "dkappa"), out),
                dist=dist, flat=flat, x=x, key=sample_key, g=g,
                rng=rng_key, jmodel=jmodel, port=port.eval())


def test_heads_latent_and_decode_match_jax(pair):
    """Per-token heads (mu (B, T, d); kappa (B, T) or log_var (B, T, d)),
    the flat latent drawn with the same sampling key, and a decode of it;
    the token order is JAX's NHWC one."""
    port, x = pair["port"], torch.from_numpy(pair["x"])
    with torch.no_grad():
        heads = port.encode_heads(x)
        z = port.get_flat_latent(x, pair["key"])
        img = port.decode(z * 0.5)
    assert heads[0].shape == (B, T, LATENT)
    for got, want in zip(heads, pair["heads"]):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() < 5e-4
    k = 2 * LATENT if pair["dist"] == "clifford" else LATENT
    assert z.shape == pair["z"].shape == (B, T * k)
    assert np.abs(z.numpy() - pair["z"]).max() < 5e-4
    assert img.shape == pair["img"].shape == (B, IMG, IMG, 1)
    assert np.abs(img.numpy() - pair["img"]).max() < 5e-4
    if pair["dist"] == "powerspherical":  # unit per token, no sqrt(d)
        np.testing.assert_allclose(
            z.reshape(B, T, LATENT).norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    if pair["dist"] == "clifford":
        assert float(heads[1].min()) >= 0.03


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
    want = param_import.hybridvae_from_jax(_flatten_params(pair["grads"]))
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    norm = float(optax.global_norm(pair["grads"]))
    for name, p in named.items():
        assert (p.grad - want[name]).abs().max().item() <= 5e-4 * norm, name
    if pair["dist"] == "clifford":
        assert named["encoder.fc_kappa.weight"].grad.abs().max() > 0


@pytest.mark.parametrize("pair", ["clifford"], indirect=True)
def test_dkappa_through_the_broadcast_matches_jax(pair):
    """A clifford draw reads kappa (B, T) broadcast over the d circles; the
    gradient of <g, z> in kappa comes back summed to (B, T), within 5e-4
    of its largest value of JAX's."""
    port = pair["port"]
    mu = torch.from_numpy(pair["heads"][0].copy())
    kappa = torch.from_numpy(pair["heads"][1].copy()).requires_grad_()
    z = port.reparam(mu, kappa, pair["key"])[0]
    (z * torch.from_numpy(pair["g"])).sum().backward()
    want = pair["dkappa"]
    assert kappa.grad.shape == want.shape == (B, T)
    assert np.abs(kappa.grad.numpy() - want).max() <= 5e-4 * max(
        1.0, np.abs(want).max())


def test_serving_entry_points_match_jax(pair):
    """``Serving`` with T = num_tokens: encode_mu (B, T*d), encode_z with
    the sampling key, decode of flat latents, against the JAX package's
    serving functions."""
    fns = serving_fns(pair["jmodel"], (IMG, IMG, 1))
    params = _tree(pair["flat"])
    srv = serving.Serving(_port_model(pair["dist"]), params=pair["flat"],
                          device="cpu")
    assert srv.model.num_tokens == T
    x = pair["x"]
    k = 2 * LATENT if pair["dist"] == "clifford" else LATENT
    z = np.random.default_rng(8).normal(size=(B, T * k)).astype(np.float32)
    want = {"encode_mu": fns["encode_mu"](params, x),
            "encode_z": fns["encode_z"](params, pair["rng"], x),
            "decode": fns["decode"](params, z)}
    before = (sampler.launches, torus.launches)
    got = {"encode_mu": srv.encode_mu(x),
           "encode_z": srv.encode_z(pair["key"], x),
           "decode": srv.decode(z)}
    assert (sampler.launches, torus.launches) == before
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].shape == w.shape, name
        assert np.abs(got[name].numpy() - w).max() < 5e-4, name


def test_three_adamw_steps_follow_the_jax_step():
    """Three AdamW steps (lr 1e-3, clip 1, the runner's) of the clifford
    model with learnable-beta sigmas at a tenth of the rate, through
    ``make_cnn_train_step``, against the JAX package's chain: the total
    loss within 1e-3 relative at every step, and the parameters after the
    first step within 2e-6 + 1e-2 * lr where JAX's gradient is larger than
    1e-3 of its norm (Adam's first step is lr * sign(g) where g is tiny)."""
    lr, scale = 1e-3, 0.1
    jmodel = _jax_model("clifford", learn=True)
    flat = _random_params(jmodel, jnp.zeros((B, IMG, IMG, 1)), 21)
    params = _tree(flat)
    rng = jax.random.PRNGKey(7)
    sample_key = np.asarray(jmodel.apply(
        {"params": params}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))
    x = _images(31)

    def loss_fn(p):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": p}, jnp.asarray(x),
                                            rngs={"sample": rng})
        losses = jconv.cnn_vae_loss(
            jnp.asarray(x), x_recon, q_z, p_z, "clifford",
            sigmas=(jnp.exp(p["log_sigma_0"]), jnp.exp(p["log_sigma_1"])))
        return losses["total_loss"]

    tx = jax_make_optimizer("adamw", lr, sigma_lr_scale=scale,
                            params=params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    opt_state = tx.init(params)
    want, after_first, first_grads = [], None, None
    for i in range(3):
        params, opt_state, loss, g = step(params, opt_state)
        want.append(float(loss))
        if i == 0:
            after_first = _flatten_params(jax.device_get(params))
            first_grads = _flatten_params(jax.device_get(g))
    port = _port_model("clifford", learn=True)
    port.load_state_dict(param_import.hybridvae_from_jax(flat))
    st = create_train_state(port, "adamw", lr, sigma_lr_scale=scale,
                            device="cpu")
    train_step = make_cnn_train_step(st.model, st.optimizer)
    got = []
    for i in range(3):
        got.append(float(train_step(torch.from_numpy(x), sample_key,
                                    1.0)["total_loss"]))
        if i == 0:
            stepped = {k: v.detach().clone()
                       for k, v in port.state_dict().items()}
    for g_, w in zip(got, want):
        assert abs(g_ - w) <= 1e-3 * abs(w), (got, want)
    assert got[2] < got[0]
    ref = param_import.hybridvae_from_jax(after_first)
    grads = param_import.hybridvae_from_jax(first_grads)
    norm = np.sqrt(sum(float((g_ ** 2).sum()) for g_ in grads.values()))
    for name, w in ref.items():
        clear = grads[name].abs() > 1e-3 * norm
        diff = (stepped[name] - w).abs()[clear]
        assert diff.numel() == 0 or diff.max() <= 2e-6 + 1e-2 * lr, name


@pytest.mark.parametrize("dist", ["vmf", "normal", "beta"])
def test_other_latent_names_run_or_raise_as_in_jax(dist):
    """The JAX encoder sends every other name down its clifford branch:
    "vmf" then runs (a von Mises-Fisher posterior per token, decoded
    d-wide) and the port's latent matches it; "normal" fails JAX's
    broadcast of mu (B, T, d) against the (B, T) concentration and an
    unknown name fails ``reparameterize``; the port refuses both."""
    jmodel = _jax_model(dist)
    x = _images(5)
    try:
        flat = _random_params(jmodel, jnp.zeros((B, IMG, IMG, 1)), 9)
        rng = jax.random.PRNGKey(3)
        want = np.asarray(jmodel.apply({"params": _tree(flat)}, x,
                                       rngs={"sample": rng},
                                       method=jmodel.get_flat_latent))
    except ValueError:
        with pytest.raises(ValueError, match="distribution"):
            _port_model(dist)
        assert dist != "vmf"
        return
    assert dist == "vmf"
    port = _port_model(dist)
    port.load_state_dict(param_import.hybridvae_from_jax(flat))
    sample_key = np.asarray(jmodel.apply(
        {"params": _tree(flat)}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))
    with torch.no_grad():
        got = port.get_flat_latent(torch.from_numpy(x), sample_key)
        img = port.decode(got)
    assert got.shape == want.shape == (B, T * LATENT)
    assert np.abs(got.numpy() - want).max() < 5e-4
    assert img.shape == (B, IMG, IMG, 1)


def test_channel_defaults_and_token_geometry():
    """[64, 128, 256] at 32 px (8 x 8 = 64 tokens), [64, 128, 256, 512] at
    64 px; the decoder reverses them; a clifford decode reads 2d per
    token.  The Fashion sweep's largest latent: 256 per token."""
    m = hybrid_vae.HybridVAE(latent_dim=256, in_channels=1, img_size=32)
    assert m.num_tokens == 64 and m.token_spatial_size == 8
    assert [b.conv1.out_channels for b in m.encoder.down] == [128, 256]
    assert [b.conv1.out_channels for b in m.decoder.up] == [128, 64]
    assert m.decoder.input_proj.in_features == 512
    m64 = hybrid_vae.HybridVAE(latent_dim=8, in_channels=3, img_size=64,
                               distribution="gaussian")
    assert m64.num_tokens == 64
    assert m64.decoder.input_proj.in_features == 8
    assert m.loss_sigmas() == (None, None)


def test_from_jax_routes_each_family():
    """A tree of each family goes to its own rules by keys only it holds,
    and the result loads into that family's port module strictly; a tree
    of no ported family raises."""
    trees = {
        "mlp": (_random_params(JaxMLPVAE(h_dim=128, z_dim=5,
                                         distribution="clifford"),
                               jnp.zeros((2, 784)), 1),
                mlp_vae.MLPVAE(128, 5, "clifford")),
        "cnn": (_random_params(jconv.CNNVAE(latent_dim=8, in_channels=1,
                                            distribution="clifford"),
                               jnp.zeros((2, 32, 32, 1)), 2),
                conv_vae.CNNVAE(8, 1)),
        "hybrid": (_random_params(_jax_model("clifford"),
                                  jnp.zeros((2, IMG, IMG, 1)), 3),
                   _port_model("clifford")),
        "vit": (_random_params(graft._flagship(tiny=True),
                               jnp.zeros((2, 32, 32, 1)), 4),
                vit_vae.CliffordARVAE(
                    latent_dim=8, image_size=32, in_channels=1,
                    cnn_chs=[16, 32, 64], z_channels=64,
                    encoder_vit_layers=1, decoder_vit_layers=2,
                    patch_size=4)),
    }
    for family, (flat, port) in trees.items():
        port.load_state_dict(param_import.from_jax(flat, "clifford"))
        assert any(k.startswith("encoder/input_conv")
                   for k in flat) == (family == "hybrid")
    with pytest.raises(ValueError, match="family"):
        param_import.from_jax({"head/kernel": np.zeros((2, 2), np.float32)})


def test_initial_weights_have_flax_spread():
    """The CNN runners' hybrid arm (latent 128 // 16 per token, 32 px) at
    initialisation: every tensor's spread within 5% of flax's and its mean
    within 0.02 (two seeds each), so trials of the two packages start from
    one distribution; the values differ."""
    jmodel = jhybrid.HybridVAE(latent_dim=8, in_channels=1,
                               distribution="clifford", img_size=32)
    x = jnp.zeros((2, 32, 32, 1))
    init = jax.jit(jmodel.init)
    want, got = {}, {}
    for seed in range(2):
        rng = jax.random.PRNGKey(seed)
        flat = param_import.from_jax(_flatten_params(jax.device_get(
            init({"params": rng, "sample": rng}, x)["params"])), "clifford")
        port = hybrid_vae.HybridVAE(latent_dim=8, in_channels=1,
                                    distribution="clifford", img_size=32,
                                    seed=seed).state_dict()
        assert port.keys() == flat.keys()
        for k in port:
            want.setdefault(k, []).append(np.asarray(flat[k], np.float64))
            got.setdefault(k, []).append(port[k].double().numpy())
    for k in want:
        w, g = np.concatenate(want[k], None), np.concatenate(got[k], None)
        assert abs(g.mean() - w.mean()) <= 0.02, k
        if w.std() == 0:
            assert g.std() == 0, k
        else:
            assert abs(g.std() / w.std() - 1) <= 0.05, k
