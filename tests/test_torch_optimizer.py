"""The port's optimizer chain (cliffordtpu_torch/train/state.py) against
``optax.chain(clip_by_global_norm(1), adam[w](1e-4))`` on EQUAL gradients:
JAX-layout gradients go to optax as they are and to the port through the
import rules (nn/param_import.py), for 3 steps, once with a global norm
below the clip and once above; parameters agree to 1e-6.  (On its own
gradients Adam's first step, g / |g|, would blow a 1e-7 difference near
g = 0 up to 2 lr.)"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.nn.conv_vae import CNNVAE as JaxCNNVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.param_import import (
    cliffordar_from_jax,
    cnnvae_from_jax,
)
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
from cliffordtpu_torch.train import state

torch.set_num_threads(1)

STEPS = 3
LR = 1e-4


def _tiny_port(**kw):
    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, 64], z_channels=64,
                         encoder_vit_layers=1, decoder_vit_layers=2,
                         patch_size=4, **kw)


@pytest.fixture(scope="module")
def jax_params():
    """The tiny flagship's parameter tree (flat, JAX layout), filled from a
    numpy seed."""
    model = graft._flagship(tiny=True)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 32, 32, 1)))["params"]
    rng = np.random.default_rng(0)
    return _flatten_params(jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes))


@pytest.fixture(scope="module")
def optax_steps():
    """One jitted optax step per optimizer name, compiled once."""
    steps = {}

    def get(name):
        if name not in steps:
            tx = jax_make_optimizer(name, LR)  # clip 1.0, then adam / adamw

            @jax.jit
            def step(params, opt_state, g):
                updates, opt_state = tx.update(g, opt_state, params)
                return optax.apply_updates(params, updates), opt_state

            steps[name] = (tx, step)
        return steps[name]

    return get


def _gradients(flat, norm, seed):
    """STEPS random gradient trees in JAX's flat layout, each of global
    norm ``norm``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in flat.items()}
        total = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                            for a in g.values()))
        out.append({k: (a * (norm / total)).astype(np.float32)
                    for k, a in g.items()})
    return out


@pytest.mark.parametrize("norm", [0.5, 40.0], ids=["below_clip", "above_clip"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_matches_optax_on_equal_gradients(jax_params, optax_steps,
                                                    name, norm):
    grads = _gradients(jax_params, norm, seed=int(norm * 10))
    params = _unflatten_params({k: jnp.asarray(v)
                                for k, v in jax_params.items()})
    tx, optax_step = optax_steps(name)
    opt_state = tx.init(params)
    for g in grads:
        params, opt_state = optax_step(
            params, opt_state,
            _unflatten_params({k: jnp.asarray(v) for k, v in g.items()}))
    want = cliffordar_from_jax(_flatten_params(jax.device_get(params)))

    model = _tiny_port()
    model.load_state_dict(cliffordar_from_jax(jax_params))
    opt = state.make_optimizer(model.parameters(), name, LR)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for g in grads:
        opt.zero_grad()
        for k, t in cliffordar_from_jax(g).items():
            named[k].grad = t
        pre_clip = opt.step()
        assert float(pre_clip) == pytest.approx(norm, rel=1e-5)
    moved = 0.0
    for k, p in named.items():
        moved = max(moved, (p.detach() - cliffordar_from_jax(jax_params)[k])
                    .abs().max().item())
        assert (p.detach() - want[k]).abs().max().item() <= 1e-6, k
    assert moved > 0.5 * STEPS * LR  # the parameters did move


def test_clip_has_optax_form_and_returns_the_pre_clip_norm():
    """g if ||g|| < c else g * (c / ||g||): no 1e-6 in the denominator, and
    gradients below the clip stay bit for bit."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = state.ClippedOptimizer(torch.optim.SGD([p], lr=1.0), clip_norm=1.0)
    p.grad = torch.tensor([3.0, 0.0, 4.0, 0.0])
    assert float(opt.step()) == 5.0
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.0, 0.8, 0.0],
                               rtol=1e-7)
    small = torch.tensor([0.3, 0.1, -0.2, 0.0])
    p.grad = small.clone()
    opt.step()
    assert torch.equal(p.grad, small)


def test_adamw_decays_every_parameter_at_1e_4():
    """optax.adamw's default weight decay (torch's default is 1e-2), with
    no mask: norm scales and biases decay too."""
    model = _tiny_port()
    opt = state.make_optimizer(model.parameters(), "adamw", LR)
    (group,) = opt.inner.param_groups
    assert group["weight_decay"] == state.ADAMW_WEIGHT_DECAY == 1e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert len(group["params"]) == len(list(model.parameters()))
    adam = state.make_optimizer(model.parameters(), "adam", LR)
    assert adam.inner.param_groups[0]["weight_decay"] == 0


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_sigma_group_matches_optax_multi_transform(name):
    """``sigma_lr_scale``: the log-sigmas train at lr * scale in a second
    parameter group, every other parameter at lr, behind one clip over
    both, as ``optax.multi_transform`` in the JAX package; parameters agree
    to 1e-6 after 3 steps on equal gradients above the clip."""
    scale = 0.1
    jmodel = JaxCNNVAE(latent_dim=16, in_channels=1, distribution="clifford",
                       use_learnable_beta=True)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0),
                                          "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 32, 32, 1)))["params"]
    rng = np.random.default_rng(1)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes))
    grads = _gradients(flat, 40.0, seed=2)
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    tx = jax_make_optimizer(name, LR, sigma_lr_scale=scale, params=params)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads:
        params, opt_state = step(params, opt_state, _unflatten_params(
            {k: jnp.asarray(v) for k, v in g.items()}))
    want = cnnvae_from_jax(_flatten_params(jax.device_get(params)))

    model = CNNVAE(16, 1, use_learnable_beta=True)
    start = cnnvae_from_jax(flat)
    model.load_state_dict(start)
    opt = state.make_optimizer(model.named_parameters(), name, LR,
                               sigma_lr_scale=scale)
    main, sigma = opt.inner.param_groups
    assert main["lr"] == LR and sigma["lr"] == pytest.approx(LR * scale)
    assert len(sigma["params"]) == 2
    assert len(main["params"]) == len(list(model.parameters())) - 2
    named = dict(model.named_parameters())
    for g in grads:
        opt.zero_grad()
        for k, t in cnnvae_from_jax(g).items():
            named[k].grad = t
        # float32 sum of squares over 6 M elements: 1e-4 relative
        assert float(opt.step()) == pytest.approx(40.0, rel=1e-4)
    for k, p in named.items():
        assert (p.detach() - want[k]).abs().max().item() <= 1e-6, k
    moved = {k: (p.detach() - start[k]).abs().max().item()
             for k, p in named.items()}
    # Adam moves a parameter by about lr per step: the sigmas a tenth of it
    assert moved["log_sigma_0"] < 0.15 * moved["encoder.mu.bias"]
    assert moved["log_sigma_0"] > 0.5 * STEPS * LR * scale


def test_sigma_group_needs_names_and_a_train_state_gives_them():
    model = CNNVAE(16, 1, use_learnable_beta=True)
    with pytest.raises(ValueError, match="name"):
        state.make_optimizer(model.parameters(), "adamw", LR,
                             sigma_lr_scale=0.1)
    st = state.create_train_state(model, "adamw", LR, sigma_lr_scale=0.1,
                                  device="cpu")
    main, sigma = st.optimizer.inner.param_groups
    assert {id(p) for p in sigma["params"]} == {id(model.log_sigma_0),
                                                id(model.log_sigma_1)}
    assert sigma["weight_decay"] == main["weight_decay"] == 1e-4
    # without the scale, named parameters form one group at lr
    (one,) = state.make_optimizer(model.named_parameters(), "adamw",
                                  LR).inner.param_groups
    assert len(one["params"]) == len(list(model.parameters()))


def test_paths_not_ported_yet_and_missing_devices_raise(monkeypatch):
    model = _tiny_port()
    # gradient accumulation is ported (tests/test_torch_optim.py holds it
    # against optax.MultiSteps); a cycle shorter than one step raises
    assert state.create_train_state(model, accum_steps=2, device="cpu"
                                    ).optimizer.accum_steps == 2
    with pytest.raises(ValueError, match="accum_steps"):
        state.make_optimizer(model.parameters(), "adam", accum_steps=0)
    with pytest.raises(ValueError):
        state.make_optimizer(model.parameters(), "sgd")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.create_train_state(model)
    st = state.create_train_state(model, "adamw", LR, device="cpu")
    assert st.device == torch.device("cpu") and st.model.training
