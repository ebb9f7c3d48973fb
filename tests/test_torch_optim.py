"""Gradient accumulation and the fused optimizer names of the port
(cliffordtpu_torch/train/state.py) against the JAX package's
``optax.MultiSteps`` chain and ``fused_adam`` (cliffordtpu/train/state.py)
on EQUAL gradients: random JAX-layout gradient trees of the MLPVAE's
parameters go to optax as they are and to the port through
nn/param_import.py.  Parameters agree to 1e-6 after every step (the bar
of tests/test_torch_optimizer.py); between two updates of an
accumulation cycle they do not move at all."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch.nn import mlp_vae, param_import
from cliffordtpu_torch.train import state

torch.set_num_threads(1)

LR = 1e-3


@pytest.fixture(scope="module")
def flat():
    """The MLPVAE's parameter tree (flat, JAX layout) from a numpy seed."""
    shapes = jax.eval_shape(
        JaxMLPVAE(h_dim=32, z_dim=4).init,
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 784)))["params"]
    rng = np.random.default_rng(0)
    return _flatten_params(jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes))


def _gradients(flat, norms, seed):
    """One random gradient tree per entry of ``norms``, of that global
    norm (below and above the clip at 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for norm in norms:
        g = {k: rng.normal(size=v.shape) for k, v in flat.items()}
        total = np.sqrt(sum(float((a ** 2).sum()) for a in g.values()))
        out.append({k: (a * (norm / total)).astype(np.float32)
                    for k, a in g.items()})
    return out


def _run(flat, tx, port_opt, model, grads):
    """Apply ``grads`` through the optax transform and the port's
    optimizer; after each step yield (JAX params as port tensors, the
    port's parameters)."""
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    named = dict(model.named_parameters())
    for g in grads:
        params, opt_state = step(params, opt_state, _unflatten_params(
            {k: jnp.asarray(v) for k, v in g.items()}))
        for name, t in param_import.mlpvae_from_jax(g).items():
            named[name].grad = t.clone()
        port_opt.step()
        yield param_import.mlpvae_from_jax(_flatten_params(
            jax.device_get(params))), named


def _model(flat):
    model = mlp_vae.MLPVAE(32, 4)
    model.load_state_dict(param_import.mlpvae_from_jax(flat))
    return model


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_accumulation_matches_optax_multisteps(flat, name):
    """k = 3: the running mean of the gradients, one clip and update per
    cycle, parameters still in between, Adam's count advancing per cycle
    only; the returned norm is each step's own."""
    k = 3
    tx = optax.MultiSteps(jax_make_optimizer(name, LR, 1.0),
                          every_k_schedule=k)
    model = _model(flat)
    st = state.create_train_state(model, name, LR, accum_steps=k,
                                  device="cpu")
    grads = _gradients(flat, [0.3, 2.0, 0.7, 5.0, 0.1, 0.4], seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (want, named) in enumerate(_run(flat, tx, st.optimizer, model,
                                           grads)):
        for n, p in named.items():
            assert (p.detach() - want[n]).abs().max() <= 1e-6, (i, n)
            if (i + 1) % k:
                assert torch.equal(p.detach(), before[n]), (i, n)
        if (i + 1) % k == 0:
            before = {n: p.detach().clone() for n, p in named.items()}
            steps = {int(s["step"]) for s in st.optimizer.inner.state
                     .values()}
            assert steps == {(i + 1) // k}
    assert st.optimizer.micro_step == 0


@pytest.mark.parametrize("name", ["adam_fused", "adamw_fused"])
def test_fused_names_match_jax_fused_adam(flat, name):
    """``adam_fused`` / ``adamw_fused`` (decay 1e-4) against the JAX
    package's flat-vector ``fused_adam`` with its clip at 1."""
    tx = jax_make_optimizer(name, LR, 1.0)
    model = _model(flat)
    opt = state.make_optimizer(model.named_parameters(), name, LR)
    wd = opt.inner.param_groups[0]["weight_decay"]
    assert wd == (state.ADAMW_WEIGHT_DECAY if name == "adamw_fused" else 0)
    grads = _gradients(flat, [0.5, 40.0, 0.5], seed=2)
    for i, (want, named) in enumerate(_run(flat, tx, opt, model, grads)):
        for n, p in named.items():
            assert (p.detach() - want[n]).abs().max() <= 1e-6, (i, n)
