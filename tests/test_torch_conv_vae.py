"""The port's CNN VAE (cliffordtpu_torch/nn/conv_vae.py) against
cliffordtpu/nn/conv_vae.py: blocks, encoder, decoder, the serving entry
points and the whole train step, on parameters of the JAX model's shapes
carried across by nn/param_import.py::cnnvae_from_jax.  Every leaf is drawn
from a numpy seed (kernels at 1 / sqrt(fan-in), biases and log-sigmas at
0.1), so no weight is symmetric under a permutation of its axes and none is
zero.  Float32, latent 16, batch 3."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.serving import _flatten_params, _unflatten_params, serving_fns
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch import serving
from cliffordtpu_torch.kernels import sampler, torus
from cliffordtpu_torch.nn import conv_vae, param_import
from cliffordtpu_torch.train.loop import make_cnn_train_step
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LATENT = 16
B = 3
LR = 1e-4
SIGMA_LR_SCALE = 0.1


RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}


def _random_params(module, rngs, example, seed):
    """Flat params of ``module``'s shapes (no initialiser is run)."""
    shapes = jax.eval_shape(module.init, rngs, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


def _tree(flat):
    return _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})


def _images(img, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, img, img, 1)).astype(np.float32)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("in_ch,out_ch", [(8, 24), (16, 16)],
                         ids=["skip_conv", "identity_skip"])
def test_res_blocks_match_jax(up, in_ch, out_ch):
    """``ResBlock`` (4x4 s2 conv, LeakyReLU, skip = 1x1 conv then average
    pool) and ``ResUpBlock`` (4x4 s2 transposed conv "SAME", skip = 1x1 conv
    then nearest x2), < 1e-4."""
    rng = np.random.default_rng(in_ch + out_ch + up)
    x = rng.normal(size=(B, 6, 6, in_ch)).astype(np.float32)
    jmod = (jconv.ResUpBlock if up else jconv.ResBlock)(out_ch)
    flat = _random_params(jmod, jax.random.PRNGKey(1), jnp.asarray(x), 3)
    want = np.asarray(jmod.apply({"params": _tree(flat)}, jnp.asarray(x)))
    port = (conv_vae.ResUpBlock if up else conv_vae.ResBlock)(in_ch, out_ch)
    assert (port.skip is None) == (in_ch == out_ch)
    nested = {f"blk/{k}": v for k, v in flat.items()}
    rules = param_import._nest(
        param_import.res_block_rules(nested, "blk", up), "blk", "blk")
    port.load_state_dict({k[len("blk."):]: v for k, v in
                          param_import.convert(nested, rules).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (B, 12 if up else 3, 12 if up else 3,
                                       out_ch)
    assert np.abs(got - want).max() < 1e-4


@pytest.fixture(scope="module", params=[32, 64], ids=["img32", "img64"])
def pair(request):
    """(JAX model, flat params, port model with them) per image size."""
    img = request.param
    jmodel = jconv.CNNVAE(latent_dim=LATENT, in_channels=1,
                          distribution="clifford", img_size=img)
    flat = _random_params(jmodel, RNGS, jnp.zeros((2, img, img, 1)), img)
    port = conv_vae.CNNVAE(LATENT, 1, img_size=img)
    port.load_state_dict(param_import.cnnvae_from_jax(flat))
    return img, jmodel, flat, port.eval()


def test_encoder_matches_jax(pair):
    """mu and kappa (softplus + the latent-dim floor, clipped at 10) on
    carried-across weights, < 5e-4; the flatten order before the heads is
    JAX's NHWC one."""
    img, jmodel, flat, port = pair
    x = _images(img)
    mu, kappa = jmodel.apply({"params": _tree(flat)}, jnp.asarray(x),
                             method=jmodel.encode)
    with torch.no_grad():
        got_mu, got_kappa = port.encode(torch.from_numpy(x))
    assert got_mu.shape == (B, LATENT) and got_kappa.shape == (B, 1)
    assert np.abs(got_mu.numpy() - np.asarray(mu)).max() < 5e-4
    assert np.abs(got_kappa.numpy() - np.asarray(kappa)).max() < 5e-4
    assert port.floor == jconv.clifford_concentration_floor(LATENT) == 0.04
    assert float(got_kappa.min()) >= port.floor


def test_decoder_matches_jax(pair):
    img, jmodel, flat, port = pair
    z = np.random.default_rng(2).normal(size=(B, 2 * LATENT)).astype(
        np.float32)
    want = np.asarray(jmodel.apply({"params": _tree(flat)}, jnp.asarray(z),
                                   method=jmodel.decode))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (B, img, img, 1)
    assert np.abs(got - want).max() < 5e-4


def test_flatten_order_is_the_nhwc_one(pair):
    """What reaches the heads is JAX's (h, w, c) flattening of the last
    feature map, and what leaves the decoder's Dense is read as (2, 2, 512):
    a channel-major (NCHW) flattening of the same map differs by far more
    than the bar, so a missed permutation cannot pass."""
    img, _, flat, port = pair
    x = torch.from_numpy(_images(img, 5))
    seen = {}
    hooks = [
        port.encoder.blocks[-1].register_forward_hook(
            lambda m, i, o: seen.update(last=o)),
        port.encoder.mu.register_forward_hook(
            lambda m, i, o: seen.update(flat=i[0])),
        port.decoder.blocks[0].register_forward_hook(
            lambda m, i, o: seen.update(first=i[0])),
    ]
    with torch.no_grad():
        mu, _ = port.encode(x)
        z = torch.from_numpy(np.random.default_rng(6).normal(
            size=(B, 2 * LATENT)).astype(np.float32))
        port.decode(z)
    for h in hooks:
        h.remove()
    nchw = seen["last"]  # (B, 512, 2, 2)
    assert nchw.shape == (B, 512, 2, 2)
    nhwc_flat = nchw.permute(0, 2, 3, 1).reshape(B, -1)
    assert torch.equal(seen["flat"], nhwc_flat)
    head, fc = (
        (torch.from_numpy(flat[f"{name}/Dense_0/kernel"].copy()),
         torch.from_numpy(flat[f"{name}/Dense_0/bias"].copy()))
        for name in ("encoder", "decoder"))
    wrong = nchw.reshape(B, -1) @ head[0] + head[1]
    assert (wrong - mu).abs().max() > 1e-2
    dense = z @ fc[0] + fc[1]
    np.testing.assert_allclose(
        seen["first"].numpy(),
        dense.reshape(B, 2, 2, 512).permute(0, 3, 1, 2).numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def served():
    """The three JAX serving functions and the port's serving object at
    img 32 on the same parameters."""
    jmodel = jconv.CNNVAE(latent_dim=LATENT, in_channels=1,
                          distribution="clifford", img_size=32)
    flat = _random_params(jmodel, RNGS, jnp.zeros((2, 32, 32, 1)), 11)
    port = serving.Serving(conv_vae.CNNVAE(LATENT, 1), params=flat,
                           device="cpu")
    return jmodel, _tree(flat), serving_fns(jmodel, (32, 32, 1)), port


def test_encode_mu_and_decode_match_jax(served):
    _, params, fns, port = served
    x = _images(32, 7)
    want = np.asarray(jax.jit(fns["encode_mu"])(params, x))
    got = port.encode_mu(x).numpy()
    assert got.shape == want.shape == (B, LATENT)
    assert np.abs(got - want).max() < 5e-4
    z = np.random.default_rng(8).normal(size=(B, 2 * LATENT)).astype(
        np.float32)
    want = np.asarray(jax.jit(fns["decode"])(params, z))
    got = port.decode(z).numpy()
    assert got.shape == want.shape == (B, 32, 32, 1)
    assert np.abs(got - want).max() < 5e-4


@pytest.mark.parametrize("route", ["keyed", "unfused"])
def test_encode_z_matches_jax_with_the_sampling_key(served, route):
    """Both routes draw the u and v of ``jax.random`` for the sampling key
    that JAX derives from the rng of ``model.apply``; encoder error passes
    through the sampler, hence 1e-3.  A CPU run launches no kernel."""
    jmodel, params, fns, port = served
    x = _images(32, 9)
    rng = jax.random.PRNGKey(42)
    want = np.asarray(jax.jit(fns["encode_z"])(params, rng, x))
    sample_key = np.asarray(jmodel.apply(
        {"params": params}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))
    before = (sampler.launches, sampler.rng_launches, torus.fwd_launches)
    got = port.encode_z(sample_key, x, sampler=route).numpy()
    assert got.shape == want.shape == (B, 2 * LATENT)
    assert np.abs(got - want).max() <= 1e-3
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert (sampler.launches, sampler.rng_launches,
            torus.fwd_launches) == before


def test_rng_route_serves_unit_torus_points_on_its_own_stream(served):
    _, _, _, port = served
    x = _images(32, 9)
    z1 = port.encode_z((0, 5), x, sampler="rng")
    assert torch.equal(z1, port.encode_z((0, 5), x, sampler="rng"))
    assert not torch.equal(z1, port.encode_z((0, 6), x, sampler="rng"))
    assert not torch.allclose(z1, port.encode_z((0, 5), x), atol=1e-3)
    np.testing.assert_allclose(z1.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_heads_not_ported_and_bad_arguments_raise():
    """Every head of the JAX model is ported now; a latent the JAX CNN has
    no head for (vmf) or an unknown one raises ValueError, as the JAX
    encoder does; so do a float16 compute dtype, an unknown sampler
    route, and any route for a latent that has one route only."""
    for dist in ("vmf", "beta"):
        with pytest.raises(ValueError, match="distribution"):
            conv_vae.CNNVAE(LATENT, 1, distribution=dist)
    with pytest.raises(ValueError, match="sampler"):
        conv_vae.CNNVAE(LATENT, 1, distribution="gaussian",
                        sampler="keyed")(torch.zeros(1, 32, 32, 1), (0, 1))
    with pytest.raises(ValueError):
        conv_vae.CNNVAE(LATENT, 1, compute_dtype=torch.float16)
    model = conv_vae.CNNVAE(LATENT, 1, sampler="philox")
    with pytest.raises(ValueError, match="sampler"):
        model(torch.zeros(1, 32, 32, 1), (0, 1))
    assert model.loss_sigmas() == (None, None)


def test_bf16_compute_keeps_f32_params_and_f32_heads():
    """Under bfloat16 compute the convolution stacks and the decoder's
    Dense run in bfloat16; parameters, heads, latent and image stay
    float32, and the output lies within bfloat16 rounding of float32's."""
    x = torch.from_numpy(_images(32, 12))
    f32 = conv_vae.CNNVAE(LATENT, 1, seed=4)
    bf16 = conv_vae.CNNVAE(LATENT, 1, seed=4, compute_dtype=torch.bfloat16)
    seen = []
    hook = bf16.decoder.fc.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        want, _, _, want_mu = f32(x, (0, 1))
        got, q_z, _, mu = bf16(x, (0, 1))
    hook.remove()
    assert seen == [torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert got.dtype == mu.dtype == q_z.concentration.dtype == torch.float32
    assert (mu - want_mu).abs().max() < 0.05
    assert (got - want).abs().max() < 0.05


# ---- the whole train step ----


@pytest.fixture(scope="module", params=[False, True],
                ids=["fixed_beta", "learnable_beta"])
def stepped(request):
    """JAX's loss-and-gradient function (what ``make_cnn_train_step``
    differentiates) and optimizer, and the port's model on the same
    parameters, with and without the learnable-beta sigmas."""
    learn = request.param
    jmodel = jconv.CNNVAE(latent_dim=LATENT, in_channels=1,
                          distribution="clifford", img_size=32,
                          use_learnable_beta=learn)
    flat = _random_params(jmodel, RNGS, jnp.zeros((2, 32, 32, 1)), 21)
    params = _tree(flat)
    rng = jax.random.PRNGKey(42)
    sample_key = np.asarray(jmodel.apply(
        {"params": params}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))

    def loss_fn(p, x, beta):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": p}, x,
                                            rngs={"sample": rng})
        sigmas = (None, None)
        if learn:
            sigmas = (jnp.exp(p["log_sigma_0"]), jnp.exp(p["log_sigma_1"]))
        losses = jconv.cnn_vae_loss(
            x, x_recon, q_z, p_z, "clifford", beta=beta,
            recon_loss_type=jmodel.recon_loss_type,
            l1_weight=jmodel.l1_weight, sigmas=sigmas)
        return losses["total_loss"], losses

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    port = conv_vae.CNNVAE(LATENT, 1, use_learnable_beta=learn)
    port.load_state_dict(param_import.cnnvae_from_jax(flat))
    return learn, params, sample_key, grad_fn, port


def test_losses_and_every_gradient_match_jax_grad(stepped):
    """Loss pieces 1e-4 relative; every parameter's gradient within 5e-4 of
    the global gradient norm, the log-sigmas' included."""
    learn, params, sample_key, grad_fn, port = stepped
    x = _images(32, 30)
    grads, losses = grad_fn(params, jnp.asarray(x), jnp.float32(0.7))
    port.train()
    port.zero_grad()
    tx = torch.from_numpy(x)
    x_recon, q_z, p_z, _ = port(tx, sample_key)
    got = conv_vae.cnn_vae_loss(tx, x_recon, q_z, p_z, "clifford", beta=0.7,
                                sigmas=port.loss_sigmas())
    assert set(got) == set(losses)
    assert ("sigma_0" in got) == learn
    for k, v in losses.items():
        assert abs(float(got[k].detach()) - float(v)) <= 1e-4 * max(
            1.0, abs(float(v)))
    got["total_loss"].backward()
    want = param_import.cnnvae_from_jax(_flatten_params(
        jax.device_get(grads)))
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    norm = float(optax.global_norm(grads))
    for name, p in named.items():
        assert (p.grad - want[name]).abs().max().item() <= 5e-4 * norm, name
    if learn:
        assert named["log_sigma_0"].grad.abs().item() > 0


def test_three_steps_follow_the_jax_step(stepped):
    """Three AdamW steps at lr 1e-4 behind the clip (the sigmas at a tenth
    of it when the model has them): total loss within 1e-3 relative at
    every step against the JAX package's own optimizer chain."""
    learn, params, sample_key, grad_fn, port = stepped
    scale = SIGMA_LR_SCALE if learn else None
    x = _images(32, 31)
    tx = jax_make_optimizer("adamw", LR, sigma_lr_scale=scale, params=params)
    opt_state = tx.init(params)
    apply = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u),
                                                    s2))(*tx.update(g, s, p)))
    want = []
    for _ in range(3):
        grads, losses = grad_fn(params, jnp.asarray(x), jnp.float32(1.0))
        want.append(float(losses["total_loss"]))
        params, opt_state = apply(params, opt_state, grads)
    st = create_train_state(port, "adamw", LR, sigma_lr_scale=scale,
                            device="cpu")
    step = make_cnn_train_step(st.model, st.optimizer)
    got = [float(step(torch.from_numpy(x), sample_key, 1.0)["total_loss"])
           for _ in range(3)]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w), (got, want)
    assert got[2] < got[0]
