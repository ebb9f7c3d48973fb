"""The training path as a whole: the port's train step (cliffordtpu_torch/train)
on the tiny flagship model, with the JAX model's own initial params
carried across, the same batch and the same sampling key, against
cliffordtpu/train/loop.py::make_cnn_train_step's loss function and
optimizer (cliffordtpu/train/state.py).  Float32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.nn.conv_vae import cnn_vae_loss as jax_cnn_vae_loss
from cliffordtpu.serving import _flatten_params
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch.kernels import attention, sampler, torus
from cliffordtpu_torch.nn.conv_vae import CNNVAE, cnn_vae_loss
from cliffordtpu_torch.nn.param_import import cliffordar_from_jax
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
from cliffordtpu_torch.train.loop import (
    make_cnn_eval_step,
    make_cnn_train_step,
)
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMG = (32, 32, 1)
LR = 1e-4
PIECES = ("total_loss", "recon_loss", "kld_loss", "entropy", "effective_beta")


def _tiny_port(**kw):
    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4, **kw)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(-1, 1, (3, *IMG)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_side(images):
    """The JAX model, its initial params, the rng of ``model.apply``, the
    sampling key that ``make_rng("sample")`` derives from it, and one
    jitted loss-and-gradient function (what ``make_cnn_train_step``
    differentiates)."""
    model = graft._flagship(tiny=True)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(0),
                                  "sample": jax.random.PRNGKey(1)},
                                 jnp.zeros((2, *IMG)))["params"]
    rng = jax.random.PRNGKey(42)
    sample_key = np.asarray(model.apply(
        {"params": params}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))

    def loss_fn(params, x, beta):
        x_recon, q_z, p_z, _ = model.apply({"params": params}, x,
                                           rngs={"sample": rng})
        losses = jax_cnn_vae_loss(
            x, x_recon, q_z, p_z, model.distribution, beta=beta,
            recon_loss_type=model.recon_loss_type, l1_weight=model.l1_weight)
        return losses["total_loss"], losses

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    return model, params, rng, sample_key, grad_fn


@pytest.fixture(scope="module")
def first_step(jax_side, images):
    """JAX's gradients and losses, and the port's after one train step
    (its gradients read back before the clip scaled them)."""
    _, params, _, sample_key, grad_fn = jax_side
    grads, losses = grad_fn(params, jnp.asarray(images), jnp.float32(1.0))
    model = _tiny_port()
    model.load_state_dict(cliffordar_from_jax(
        _flatten_params(jax.device_get(params))))
    st = create_train_state(model, "adamw", LR, device="cpu")
    x = torch.from_numpy(images)
    # the step's own pieces, stopping before the update
    st.optimizer.zero_grad()
    x_recon, q_z, p_z, mu = st.model(x, sample_key)
    port_losses = cnn_vae_loss(x, x_recon, q_z, p_z, "clifford", beta=1.0)
    port_losses["total_loss"].backward()
    port_grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
    port_losses = {k: v.detach() for k, v in port_losses.items()}
    return dict(jax_grads=grads, jax_losses=losses, losses=port_losses,
                grads=port_grads, outputs=(x_recon, q_z, p_z, mu))


def test_forward_returns_recon_posterior_prior_and_mean(first_step):
    x_recon, q_z, p_z, mu = first_step["outputs"]
    assert x_recon.shape == (3, *IMG) and mu.shape == (3, 64, 8)
    assert q_z.loc is mu and q_z.concentration.shape == (3, 64, 8)
    assert p_z.dim == 8


def test_loss_pieces_match_jax(first_step):
    """Each of the five outputs within 1e-4 relative."""
    for k in PIECES:
        want = float(first_step["jax_losses"][k])
        got = float(first_step["losses"][k])
        assert abs(got - want) <= 1e-4 * abs(want), (k, got, want)


def test_every_parameter_gradient_matches_jax_grad(first_step):
    """jax.grad's tree goes through the import rules (a transpose, a flip
    or the identity per leaf); every parameter's gradient lies within 5e-4
    of the global gradient norm, and the norm itself within 1e-4 relative.
    """
    want = cliffordar_from_jax(_flatten_params(jax.device_get(
        first_step["jax_grads"])))
    got = first_step["grads"]
    assert set(got) == set(want)
    norm = float(optax.global_norm(first_step["jax_grads"]))
    for name, g in got.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        assert (g - want[name]).abs().max().item() <= 5e-4 * norm, name
    port_norm = torch.sqrt(sum(g.double().pow(2).sum() for g in got.values()))
    assert abs(float(port_norm) - norm) <= 1e-4 * norm


def test_three_steps_follow_the_jax_step(jax_side, images):
    """Three consecutive AdamW steps on one batch at lr 1e-4, the port's
    ``make_cnn_train_step`` against grad -> pre-clip norm -> the JAX
    package's optimizer chain: total loss within 1e-3 relative at every
    step, the pre-clip ``grad_norm`` of the first within 1e-4 relative."""
    _, params, _, sample_key, grad_fn = jax_side
    tx = jax_make_optimizer("adamw", LR)
    opt_state = tx.init(params)
    apply = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u),
                                                    s2))(*tx.update(g, s, p)))
    x, beta = jnp.asarray(images), jnp.float32(1.0)
    want = []
    jparams = params
    for _ in range(3):
        grads, losses = grad_fn(jparams, x, beta)
        want.append((float(losses["total_loss"]),
                     float(optax.global_norm(grads))))
        jparams, opt_state = apply(jparams, opt_state, grads)

    model = _tiny_port()
    model.load_state_dict(cliffordar_from_jax(
        _flatten_params(jax.device_get(params))))
    st = create_train_state(model, "adamw", LR, device="cpu")
    step = make_cnn_train_step(st.model, st.optimizer)
    before = (attention.launches, attention.bwd_launches, sampler.launches,
              torus.launches)
    tx_ = torch.from_numpy(images)
    got = []
    for _ in range(3):
        losses = step(tx_, sample_key, 1.0)
        assert set(losses) == set(PIECES) | {"grad_norm"}
        assert not any(v.requires_grad for v in losses.values())
        got.append((float(losses["total_loss"]), float(losses["grad_norm"])))
    # the plain versions ran: a CPU run launches no kernel
    assert (attention.launches, attention.bwd_launches, sampler.launches,
            torus.launches) == before
    assert abs(got[0][1] - want[0][1]) <= 1e-4 * want[0][1]
    for (g_loss, _), (w_loss, _) in zip(got, want):
        assert abs(g_loss - w_loss) <= 1e-3 * abs(w_loss), (got, want)
    assert got[2][0] < got[0][0]  # and it trains


def test_eval_step_and_encode_match_jax(jax_side, images):
    model, params, rng, sample_key, _ = jax_side
    port = _tiny_port()
    port.load_state_dict(cliffordar_from_jax(
        _flatten_params(jax.device_get(params))))
    port.eval()
    losses = make_cnn_eval_step(port)(torch.from_numpy(images), sample_key,
                                      0.5)
    assert not losses["total_loss"].requires_grad
    want_z, want_kl = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, rngs={"sample": rng}, method="encode"))(
        params, jnp.asarray(images))
    with torch.no_grad():
        z, kl = port.encode(torch.from_numpy(images), sample_key)
    assert z.shape == (3, 64, 16)
    assert np.abs(z.numpy() - np.asarray(want_z)).max() <= 1e-3
    assert abs(float(kl) - float(want_kl)) <= 1e-4 * abs(float(want_kl))
    assert abs(float(losses["kld_loss"]) - float(want_kl)) <= \
        1e-4 * abs(float(want_kl))
    assert float(losses["effective_beta"]) == 0.5


def test_bf16_compute_keeps_f32_params_grads_and_moments(first_step, jax_side,
                                                         images):
    """Under bfloat16 compute every parameter, gradient and Adam moment
    stays float32, the activations of the transformer run in bfloat16, and
    the first loss lies within 2% of the float32 loss (bfloat16 keeps 8
    bits of mantissa; measured 0.1%)."""
    _, params, _, sample_key, _ = jax_side
    model = _tiny_port(compute_dtype=torch.bfloat16)
    model.load_state_dict(cliffordar_from_jax(
        _flatten_params(jax.device_get(params))))
    st = create_train_state(model, "adamw", LR, device="cpu")
    seen = []
    hook = st.model.decoder_vit.layers[0].attn.wq.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    losses = make_cnn_train_step(st.model, st.optimizer)(
        torch.from_numpy(images), sample_key, 1.0)
    hook.remove()
    assert seen == [torch.bfloat16]
    for name, p in st.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name
    moments = st.optimizer.inner.state
    assert len(moments) == len(list(st.model.parameters()))
    for s in moments.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32
    f32 = float(first_step["losses"]["total_loss"])
    assert abs(float(losses["total_loss"]) - f32) <= 2e-2 * abs(f32)
    # its gradients, read after the clip scaled them by 1 / ||g||, are the
    # float32 step's up to bfloat16 rounding
    norm = float(losses["grad_norm"])
    ref = first_step["grads"]
    err = sum(((p.grad * norm - ref[n]).double() ** 2).sum()
              for n, p in st.model.named_parameters()) ** 0.5
    ref_norm = sum((g.double() ** 2).sum() for g in ref.values()) ** 0.5
    assert float(err / ref_norm) <= 0.1  # measured 0.039


def test_learnable_beta_step_matches_jax(jax_side, images):
    """``use_learnable_beta`` on the tiny flagship: the sigma-form losses
    within 1e-4 relative, the pre-clip gradient norm within 1e-4 relative
    and the two log-sigma gradients within 5e-4 of it, against jax.grad of
    what ``make_cnn_train_step`` differentiates; the sigmas train in their
    own parameter group."""
    model = graft._flagship(tiny=True).clone(use_learnable_beta=True)
    params = {**jax_side[1], "log_sigma_0": jnp.asarray([0.3], jnp.float32),
              "log_sigma_1": jnp.asarray([-0.2], jnp.float32)}
    rng = jax.random.PRNGKey(42)
    sample_key = np.asarray(model.apply(
        {"params": params}, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample")))

    def loss_fn(p, x):
        x_recon, q_z, p_z, _ = model.apply({"params": p}, x,
                                           rngs={"sample": rng})
        losses = jax_cnn_vae_loss(
            x, x_recon, q_z, p_z, model.distribution, beta=1.0,
            sigmas=(jnp.exp(p["log_sigma_0"]), jnp.exp(p["log_sigma_1"])))
        return losses["total_loss"], losses

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, jnp.asarray(images))
    port = _tiny_port(use_learnable_beta=True)
    port.load_state_dict(cliffordar_from_jax(
        _flatten_params(jax.device_get(params))))
    st = create_train_state(port, "adamw", LR, sigma_lr_scale=0.1,
                            device="cpu")
    assert [len(g["params"]) for g in st.optimizer.inner.param_groups] == [
        len(list(port.parameters())) - 2, 2]
    got = make_cnn_train_step(st.model, st.optimizer)(
        torch.from_numpy(images), sample_key, 1.0)
    assert set(got) == set(PIECES) | {"sigma_0", "sigma_1", "grad_norm"}
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-4 * abs(float(w)), k
    norm = float(optax.global_norm(grads))
    assert abs(float(got["grad_norm"]) - norm) <= 1e-4 * norm
    for name in ("log_sigma_0", "log_sigma_1"):
        # read after the clip scaled the gradients by 1 / ||g||
        g = float(getattr(st.model, name).grad) * float(got["grad_norm"])
        assert abs(g - float(grads[name][0])) <= 5e-4 * norm, name


def test_sampler_routes_through_the_train_step():
    """The model's ``sampler`` reaches the draw of a train step: "unfused"
    takes the keyed route's u and v, so the first losses agree; "rng" gives
    equal losses for one key and other losses for another."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (3, *IMG)).astype(np.float32))
    first = {}
    for route in ("keyed", "unfused", "rng"):
        runs = []
        for key in ((0, 3), (0, 3), (0, 4)):
            st = create_train_state(CNNVAE(16, 1, sampler=route, seed=2),
                                    "adamw", LR, device="cpu")
            runs.append(float(make_cnn_train_step(st.model, st.optimizer)(
                x, key, 1.0)["total_loss"]))
        assert runs[0] == runs[1] and runs[0] != runs[2], route
        first[route] = runs[0]
    assert abs(first["keyed"] - first["unfused"]) <= 1e-5 * first["keyed"]
    assert first["rng"] != first["keyed"]
