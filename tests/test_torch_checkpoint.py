"""Checkpoints of the port (cliffordtpu_torch/train/checkpoint.py): save,
load, delete and exact resume on the CPU, and a run that the JAX package
trained and checkpointed (cliffordtpu/train/checkpoint.py, orbax) carried
by ``state_from_jax`` into the port, whose next step is held against the
JAX run's own next step: the clip + adamw chain, its learnable-beta sigma
group, the flat ``fused_adam`` state and ``optax.MultiSteps``.  Then the
legacy (v1) RoPE migration and the refusal of fused projections.  The
tiny HybridVAE of test_torch_hybrid_vae.py, batch 3, float32.  Bars: the
carried step's loss within 1e-4 relative of JAX's, every parameter
afterwards within 1e-5 of JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from cliffordtpu.nn import conv_vae as jconv
from cliffordtpu.nn import hybrid_vae as jhybrid
from cliffordtpu.serving import _flatten_params, _unflatten_params
from cliffordtpu.train import checkpoint as jckpt
from cliffordtpu.train.state import TrainState as JaxTrainState
from cliffordtpu.train.state import make_optimizer as jax_make_optimizer
from cliffordtpu_torch import random
from cliffordtpu_torch.nn import hybrid_vae, param_import, vit_vae
from cliffordtpu_torch.train import checkpoint
from cliffordtpu_torch.train.loop import make_cnn_train_step
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)

B, IMG, LATENT, CHS = 3, 8, 4, [8, 16]
LR, SIGMA_SCALE = 1e-3, 0.1
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}


def _random_params(module, example, seed):
    shapes = jax.eval_shape(module.init, RNGS, example)["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel") else 0.1)
                ).astype(np.float32) for k, v in flat.items()}


def _images(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, IMG, IMG, 1)).astype(np.float32)


def _port(learn, seed=0):
    return hybrid_vae.HybridVAE(LATENT, 1, encoder_chs=CHS, img_size=IMG,
                                use_learnable_beta=learn, seed=seed)


def _state(model, learn, accum=1, optimizer="adamw"):
    return create_train_state(model, optimizer, LR,
                              sigma_lr_scale=SIGMA_SCALE if learn else None,
                              accum_steps=accum, device="cpu")


def _steps(st, keys, x):
    step = make_cnn_train_step(st.model, st.optimizer)
    return [step(x, k, 1.0)["total_loss"] for k in keys]


@pytest.mark.parametrize("learn,accum", [(False, 1), (True, 2)],
                         ids=["adamw", "sigma_group_accum2"])
def test_resume_is_bit_exact(tmp_path, learn, accum):
    """Five steps straight against three steps, a save, a load into a
    fresh model (another seed) and optimizer, and steps four and five:
    losses and every parameter bit-equal.  With accum 2 the save falls in
    the middle of a cycle, so the accumulator is live."""
    x = torch.from_numpy(_images(1))
    keys = [random.fold_in_words((0, 5), i) for i in range(5)]
    straight = _state(_port(learn), learn, accum)
    want = _steps(straight, keys, x)
    first = _state(_port(learn), learn, accum)
    got = _steps(first, keys[:3], x)
    assert first.optimizer.micro_step == (1 if accum == 2 else 0)
    path = checkpoint.save_checkpoint(str(tmp_path), first, step=3,
                                      best_metric=1.5, rng_key=keys[3])
    assert os.path.basename(path) == "best_model.ckpt"
    payload = checkpoint.load_checkpoint(str(tmp_path))
    resumed = _state(_port(learn, seed=9), learn, accum)
    meta = checkpoint.restore_checkpoint(resumed, payload)
    assert meta == {"step": 3, "best_metric": 1.5, "rng_key": keys[3]}
    got += _steps(resumed, keys[3:], x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            straight.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_save_load_delete(tmp_path):
    """None when nothing is saved; a second save replaces the first (a JAX
    checkpoint directory of the same name too); delete removes it; an
    orbax directory is refused by ``load_checkpoint``."""
    out = str(tmp_path / "run")
    assert checkpoint.load_checkpoint(out) is None
    st = _state(_port(False), False)
    checkpoint.save_checkpoint(out, st, step=1)
    checkpoint.save_checkpoint(out, st, step=2)
    assert os.listdir(out) == ["best_model.ckpt"]
    assert checkpoint.load_checkpoint(out)["step"] == 2
    checkpoint.delete_checkpoint(out)
    assert checkpoint.load_checkpoint(out) is None
    checkpoint.delete_checkpoint(out)  # nothing there: no error
    os.makedirs(os.path.join(out, "best_model.ckpt"))
    with pytest.raises(ValueError, match="state_from_jax"):
        checkpoint.load_checkpoint(out)
    checkpoint.save_checkpoint(out, st, step=4)
    assert checkpoint.load_checkpoint(out)["step"] == 4


# ---- a JAX run carried into the port ----


FORMS = {  # name: (JAX optimizer, learnable beta, accum steps, JAX steps)
    "adamw_chain": ("adamw", False, 1, 2),
    "sigma_group": ("adamw", True, 1, 2),
    "fused": ("adamw_fused", True, 1, 2),
    "multisteps": ("adamw", False, 2, 3),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_jax_checkpoint_carries_into_the_port(tmp_path, form):
    """JAX trains, saves with orbax and reloads; ``state_from_jax`` carries
    the payload into a fresh port model and optimizer, which take the next
    step; JAX takes the same step with the same key."""
    opt, learn, accum, n = FORMS[form]
    jmodel = jhybrid.HybridVAE(latent_dim=LATENT, in_channels=1,
                               encoder_chs=CHS, img_size=IMG,
                               use_learnable_beta=learn)
    flat = _random_params(jmodel, jnp.zeros((B, IMG, IMG, 1)), 7)
    params = _unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})
    x = _images(2)
    tx = jax_make_optimizer(opt, LR, 1.0, SIGMA_SCALE if learn else None,
                            params)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                 tx=tx)

    def loss_fn(p, rng):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": p}, jnp.asarray(x),
                                            rngs={"sample": rng})
        sigmas = ((jnp.exp(p["log_sigma_0"]), jnp.exp(p["log_sigma_1"]))
                  if learn else (None, None))
        return jconv.cnn_vae_loss(jnp.asarray(x), x_recon, q_z, p_z,
                                  "clifford", sigmas=sigmas)["total_loss"]

    @jax.jit
    def step(st, rng):
        loss, g = jax.value_and_grad(loss_fn)(st.params, rng)
        return st.apply_gradients(grads=g), loss

    rngs = [jax.random.PRNGKey(100 + i) for i in range(n + 1)]
    for rng in rngs[:n]:
        state, _ = step(state, rng)
    jckpt.save_checkpoint(str(tmp_path), state, step=n, best_metric=0.5,
                          rng_key=rngs[n])
    payload = jckpt.load_checkpoint(str(tmp_path))
    state, want_loss = step(state, rngs[n])
    want = param_import.hybridvae_from_jax(
        _flatten_params(jax.device_get(state.params)))

    st = _state(_port(learn, seed=3), learn, accum)
    meta = checkpoint.state_from_jax(payload, st.model, st.optimizer)
    assert meta == {"step": n, "best_metric": 0.5,
                    "rng_key": random.key_words(np.asarray(rngs[n]))}
    assert st.optimizer.micro_step == (n % accum)
    loss = make_cnn_train_step(st.model, st.optimizer)(
        torch.from_numpy(x), random.sample_key(np.asarray(rngs[n])),
        1.0)["total_loss"]
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(
        float(want_loss))
    for name, p in st.model.state_dict().items():
        assert (p - want[name]).abs().max().item() <= 1e-5, name


def test_optimizer_settings_must_match_the_jax_run(tmp_path):
    """A MultiSteps state into an optimizer without accumulation, and the
    other way round, raise and name the mismatch."""
    jmodel = jhybrid.HybridVAE(latent_dim=LATENT, in_channels=1,
                               encoder_chs=CHS, img_size=IMG)
    params = _unflatten_params({k: jnp.asarray(v) for k, v in _random_params(
        jmodel, jnp.zeros((B, IMG, IMG, 1)), 8).items()})
    for accum in (1, 2):
        tx = jax_make_optimizer("adamw", LR, 1.0, None, params)
        if accum > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=accum)
        out = str(tmp_path / f"accum{accum}")
        jckpt.save_checkpoint(out, JaxTrainState.create(
            apply_fn=jmodel.apply, params=params, tx=tx))
        payload = jckpt.load_checkpoint(out)
        st = _state(_port(False), False, 3 - accum)
        with pytest.raises(ValueError, match="accum"):
            checkpoint.state_from_jax(payload, st.model, st.optimizer)


def test_v1_rope_migration_matches_jax():
    """The port's copy of ``_migrate_rope_layout`` permutes the q / k
    kernels of a synthetic tree, with a leading layer axis too, as the JAX
    one does, and leaves v and everything else alone."""
    rng = np.random.default_rng(0)

    def tree():
        return {"encoder_vit": {f"TransformerBlock_{i}": {"Attention_0": {
            f"Dense_{j}": {"kernel": rng.normal(size=(2, 16, 16) if i
                                                else (16, 16))}
            for j in range(4)}} for i in range(2)}, "other": {
                "kernel": rng.normal(size=(4, 4))}}

    orig = tree()
    a, b = (jax.tree_util.tree_map(np.copy, orig) for _ in range(2))
    assert checkpoint._migrate_rope_layout(a, 2) == \
        jckpt._migrate_rope_layout(b, 2) == 4
    for (ka, va), (kb, vb), (_, vo) in zip(checkpoint._leaves(a),
                                           checkpoint._leaves(b),
                                           checkpoint._leaves(orig)):
        assert ka == kb and np.array_equal(va, vb)
        moved = ka.split("/")[-2] in ("Dense_0", "Dense_1")
        assert np.array_equal(va, vo) != moved, ka


def test_v1_payload_carries_into_the_port():
    """A CliffordARVAE payload with no ``rope_layout`` tag (its q / k
    kernels and their Adam moments in the interleaved layout) is migrated
    before it loads: the port's parameters and moments are those of the
    half-split tree it was made from."""
    jmodel = graft._flagship(tiny=True)
    flat = _random_params(jmodel, jnp.zeros((2, 32, 32, 1)), 5)
    inverse = {}
    for k, v in flat.items():
        parts = k.split("/")
        if len(parts) > 2 and parts[-3].startswith("Attention_") and \
                parts[-2] in ("Dense_0", "Dense_1"):
            perm = checkpoint._rope_half_perm(v.shape[-1], 1)
            v = v[..., np.argsort(perm)]
        inverse[k] = v
    legacy = _unflatten_params(inverse)
    moments = {"count": np.int32(2), "mu": legacy, "nu": jax.tree_util
               .tree_map(np.abs, legacy)}
    payload = {"params": legacy, "opt_state": [None, [moments, None, None]],
               "step": 2, "best_metric": 0.0}
    port = vit_vae.CliffordARVAE(
        latent_dim=8, image_size=32, in_channels=1, cnn_chs=[16, 32, 64],
        z_channels=64, encoder_vit_layers=1, decoder_vit_layers=2,
        patch_size=4)
    st = create_train_state(port, "adamw", LR, device="cpu")
    checkpoint.state_from_jax(payload, st.model, st.optimizer)
    want = param_import.cliffordar_from_jax(flat)
    opt_state = st.optimizer.inner.state
    for name, p in st.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        assert torch.equal(opt_state[p]["exp_avg"], want[name]), name
        assert torch.equal(opt_state[p]["exp_avg_sq"], want[name].abs())
        assert float(opt_state[p]["step"]) == 2.0
    assert any("Attention" in k for k in flat)


def test_fused_projections_are_refused():
    with pytest.raises(NotImplementedError, match="fused"):
        checkpoint.state_from_jax({"proj_layout": "fused", "params": {}},
                                  _port(False))
