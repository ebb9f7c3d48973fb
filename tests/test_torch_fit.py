"""The port's MLP training loop (cliffordtpu_torch/train/loop.py,
random.py's permutation and sample key, data/loaders.py, schedules.py)
against cliffordtpu/train/loop.py on the same initial weights and keys.

Bars: permutations, binarisation and schedules exact; the train and eval
steps' losses and grad_norm within 1e-5 of max(1, |value|) for three
steps, the first step's gradients within 1e-5 of the global gradient norm
(later steps are held through the losses: Adam's first update is about
lr * sign(g), which turns a 1e-7 difference near g = 0 into 2 lr);
``fit`` and ``fit_trials`` histories and best values within rtol 2e-4,
the bar ``tests/test_train.py`` holds the JAX loops to; the port's own
paths (epoch step against per-step, lanes against their sequential
``fit``, per-lane clip) within 1e-5 or exact, a restored lane's
parameters within 1e-4 of its ``fit``'s (a tenth of lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.data.loaders import binarize_with_random_threshold as jbin
from cliffordtpu.nn.losses import vae_loss_from_outputs as jvae_loss
from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params
from cliffordtpu.train import loop as jloop
from cliffordtpu.train import schedules as jsched
from cliffordtpu.train.state import create_train_state as jax_state
from cliffordtpu_torch import random
from cliffordtpu_torch.data import loaders
from cliffordtpu_torch.nn import conv_vae, mlp_vae, param_import
from cliffordtpu_torch.train import loop, schedules, state

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
Z = 4
X = np.random.default_rng(2).uniform(0, 1, (96, 784)).astype(np.float32)


def _near(got, want, bar):
    return abs(float(got) - float(want)) <= bar * max(1.0, abs(float(want)))


def _jax_state(dist, key=KEY):
    model = JaxMLPVAE(h_dim=32, z_dim=Z, distribution=dist)
    return model, jax_state(key, model, jnp.zeros((2, 784)), lr=1e-3)


def _port_state(dist, jst, optimizer="adam"):
    """The port's model on the JAX state's initial weights."""
    model = mlp_vae.MLPVAE(32, Z, dist)
    model.load_state_dict(param_import.from_jax(_flatten_params(
        jax.device_get(jst.params))))
    return state.create_train_state(model, optimizer, 1e-3, device="cpu")


@pytest.mark.parametrize("n", [1, 7, 96, 60000])
def test_permutation_matches_jax(n):
    """ceil(3 ln n / ln(2**32 - 1)) rounds of a stable sort: 0 at n 1, 2 at
    n 60000."""
    for seed in (0, 11):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            random.permutation(np.asarray(key), n).numpy(),
            np.asarray(jax.random.permutation(key, n)))


def test_binarize_and_lane_draws_match_jax():
    x = X[:16].reshape(16, 28, 28)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.vmap(lambda k: jbin(k, jnp.asarray(x)))(keys))
    for t in range(3):
        got = loaders.binarize_with_random_threshold(
            np.asarray(keys[t]), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want[t])
    lanes = loaders.binarize_lanes(
        torch.from_numpy(np.asarray(keys).astype(np.int64)),
        torch.from_numpy(np.stack([x] * 3)))
    np.testing.assert_array_equal(lanes.numpy(), want)
    with pytest.raises(ValueError, match="int64"):
        random.lane_uniform(torch.zeros(3, 2, dtype=torch.int32), (4,))


def test_sample_key_is_flaxs_make_rng():
    model, jst = _jax_state("clifford")
    rng = jax.random.PRNGKey(9)
    want = model.apply({"params": jst.params}, rngs={"sample": rng},
                       method=lambda m: m.make_rng("sample"))
    assert random.sample_key(np.asarray(rng)) == tuple(
        int(w) for w in np.asarray(want))
    np.testing.assert_array_equal(random.fold_in(np.asarray(rng), 3).numpy(),
                                  np.asarray(jax.random.fold_in(rng, 3)))


def test_schedules_match_jax():
    for e in range(12):
        for w in (0, 1, 4):
            assert schedules.linear_kl_warmup(e, w) == \
                jsched.linear_kl_warmup(e, w)
            for c in (0, 1, 4, 5):
                args = (e, w, c, 0.1, 0.9)
                assert schedules.cyclical_kl_beta(*args) == \
                    jsched.cyclical_kl_beta(*args)


@pytest.mark.parametrize("dist", ["clifford"])
def test_train_and_eval_steps_match_jax(dist):
    """Three steps on the same keys: the split into (k_bin, k_sample), the
    binarisation, the sampling key from make_rng, the clip and Adam (the
    other families' steps: tests/test_torch_losses.py holds their losses,
    the short-batch ``fit_trials`` case the normal family's training)."""
    model, jst = _jax_state(dist)
    st = _port_state(dist, jst)
    beta = 0.5
    k0 = jax.random.PRNGKey(4)
    k_bin, k_sample = jax.random.split(k0)
    xb0 = jbin(k_bin, jnp.asarray(X[:16]))

    def loss_fn(p):
        out = model.apply({"params": p}, xb0, rngs={"sample": k_sample})
        return jvae_loss(xb0, out, beta)["total"]

    want_grads = param_import.from_jax(_flatten_params(jax.device_get(
        jax.jit(jax.grad(loss_fn))(jst.params))))
    jstep, jeval = jloop.make_mlp_train_step(model), \
        jloop.make_mlp_eval_step(model)
    step = loop.make_mlp_train_step(st.model, st.optimizer)
    evaluate = loop.make_mlp_eval_step(st.model)
    for i in range(3):
        key = jax.random.fold_in(k0, i) if i else k0
        xb = X[16 * i:16 * (i + 1)]
        want_eval = jax.device_get(jeval(jst.params, xb, key, beta))
        got_eval = evaluate(torch.from_numpy(xb), np.asarray(key), beta)
        for k, v in want_eval.items():
            assert _near(got_eval[k], v, 1e-5), (i, "eval", k)
        jst, want = jstep(jst, xb, key, beta)
        got = step(torch.from_numpy(xb), np.asarray(key), beta)
        assert set(got) == set(want)
        for k, v in jax.device_get(want).items():
            assert _near(got[k], v, 1e-5), (i, k, float(got[k]), float(v))
        if i == 0:
            grads = dict(st.model.named_parameters())
            norm = float(got["grad_norm"])
            for name, g in want_grads.items():
                # the clip scaled the gradients in place by min(1, 1 / norm)
                g_port = grads[name].grad / min(1.0, 1.0 / norm)
                assert (g_port - g).abs().max() <= 1e-5 * norm, name


def test_fit_matches_jax():
    model, jst = _jax_state("clifford")
    st = _port_state("clifford", jst)
    kw = dict(epochs=2, batch_size=16, beta_fn=lambda e: 0.5 * (e + 1))
    key = jax.random.fold_in(KEY, 1)
    _, want = jloop.fit(jst, jloop.make_mlp_train_step(model),
                        jloop.make_mlp_eval_step(model), key, X[:64],
                        X[64:], **kw)
    logged = []
    _, got = loop.fit(st, loop.make_mlp_train_step(st.model, st.optimizer),
                      loop.make_mlp_eval_step(st.model), np.asarray(key),
                      X[:64], X[64:], log_fn=lambda e, d: logged.append(d),
                      **kw)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4)
    np.testing.assert_allclose(got["best_val"], want["best_val"], rtol=2e-4)
    assert [d["beta"] for d in logged] == [0.5, 1.0]
    assert all(np.isfinite(d["grad_norm"]) for d in logged)


def test_epoch_step_equals_the_per_step_path():
    """``fit``'s epoch (by default, and through ``make_mlp_epoch_step``)
    trains as the per-step loop written out here: batch s of the epoch's
    permutation with step key ``fold_in(ekey, s + 1)``.  The scripted
    validation falls every epoch, so the last epoch's parameters are kept:
    equal parameters, train histories within 1e-6."""
    _, jst = _jax_state("clifford")
    kw = dict(epochs=2, batch_size=16, beta_fn=lambda e: 0.5)
    st = _port_state("clifford", jst)
    step = loop.make_mlp_train_step(st.model, st.optimizer)
    want = []
    for epoch in range(2):
        ekey = random.fold_in_words((0, 1), epoch)
        perm = random.permutation(random.fold_in_words(ekey, 0), 64, "cpu")
        want.append(torch.stack([step(
            torch.from_numpy(X[perm[s * 16:(s + 1) * 16].numpy()]),
            random.fold_in_words(ekey, s + 1), torch.tensor(0.5))["total"]
            for s in range(4)]).mean().item())
    for use_epoch_step in (False, True):
        calls = iter(range(100))
        falling = lambda x, k, b: {  # noqa: E731
            "total": torch.tensor(-float(next(calls)))}
        got = _port_state("clifford", jst)
        ep = (loop.make_mlp_epoch_step(got.model, got.optimizer)
              if use_epoch_step else None)
        got, hist = loop.fit(
            got, loop.make_mlp_train_step(got.model, got.optimizer),
            falling, (0, 1), X[:64], X[64:], epoch_step=ep, **kw)
        np.testing.assert_allclose(hist["train_loss"], want, rtol=1e-6)
        for a, b in zip(got.model.parameters(), st.model.parameters()):
            assert torch.equal(a, b)


def test_fit_short_batch_matches_jax():
    """n_train 18 < batch 32: ``fit`` trains one short batch per epoch,
    as the JAX ``fit`` does; histories within rtol 2e-4."""
    model, jst = _jax_state("normal")
    st = _port_state("normal", jst)
    kw = dict(epochs=2, batch_size=32, beta_fn=lambda e: 1.0)
    _, want = jloop.fit(jst, jloop.make_mlp_train_step(model),
                        jloop.make_mlp_eval_step(model), KEY, X[:18],
                        X[18:50], **kw)
    _, got = loop.fit(st, loop.make_mlp_train_step(st.model, st.optimizer),
                      loop.make_mlp_eval_step(st.model), np.asarray(KEY),
                      X[:18], X[18:50], **kw)
    for k in ("train_loss", "val_loss", "best_val"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4)


def test_cnn_epoch_step_equals_looped_train_steps():
    """Step i of the CNN epoch step samples with sample_key(fold_in(key, i
    + 1)), as the looped ``make_cnn_train_step`` does with that key."""
    x = np.random.default_rng(3).uniform(-1, 1, (3, 4, 32, 32, 1)) \
        .astype(np.float32)
    beta = torch.tensor(0.7)
    got = []
    for epoch in (False, True):
        st = state.create_train_state(conv_vae.CNNVAE(8, 1), "adamw", 1e-3,
                                      device="cpu")
        if epoch:
            got.append(loop.make_cnn_epoch_step(st.model, st.optimizer)(
                torch.from_numpy(x), (0, 9), beta)["total_loss"])
        else:
            step = loop.make_cnn_train_step(st.model, st.optimizer)
            got.append(torch.stack([step(torch.from_numpy(x[i]),
                                         random.sample_key(
                                             random.fold_in_words((0, 9),
                                                                  i + 1)),
                                         beta)["total_loss"]
                                    for i in range(3)]))
    assert torch.equal(got[0], got[1])


def test_fit_stops_early_and_restores_the_best_parameters():
    """A scripted validation loss that rises every epoch: the run stops
    after 1 + patience epochs with the first epoch's parameters."""
    _, jst = _jax_state("normal")
    st = _port_state("normal", jst)
    step = loop.make_mlp_train_step(st.model, st.optimizer)
    epoch = {"n": -1}
    snapshots = []

    def scripted_eval(x, key, beta):
        return {"total": torch.tensor(100.0 + epoch["n"])}

    def beta_fn(e):
        epoch["n"] = e
        snapshots.append({k: v.clone()
                          for k, v in st.model.state_dict().items()})
        return 1.0

    _, hist = loop.fit(st, step, scripted_eval, (0, 3), X[:32], X[32:48],
                       epochs=10, batch_size=16, beta_fn=beta_fn, patience=2)
    assert len(hist["val_loss"]) == 3 and hist["best_val"] == 100.0
    # the state after epoch 0 is the state before epoch 1
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, snapshots[1][k]), k


def _trial_runs(T, x_tr, x_val, kw, dist="clifford"):
    """JAX fit_trials on T lanes, and the port's lanes on the same initial
    weights and keys."""
    model = JaxMLPVAE(h_dim=32, z_dim=Z, distribution=dist)
    trial_keys = [jax.random.fold_in(KEY, 100 + t) for t in range(T)]
    jstates = [jax_state(k, model, jnp.zeros((2, 784)), lr=1e-3)
               for k in trial_keys]
    fit_keys = jnp.stack([jax.random.fold_in(k, 1) for k in trial_keys])
    _, want = jloop.fit_trials(jloop.stack_trial_states(jstates), fit_keys,
                               x_tr, x_val, model, **kw)
    ports = [_port_state(dist, j) for j in jstates]
    lanes = loop.stack_trial_states(ports)
    _, got = loop.fit_trials(lanes, np.asarray(fit_keys), x_tr, x_val, **kw)
    return want, got, jstates, np.asarray(fit_keys), lanes


def test_fit_trials_matches_jax_and_the_sequential_fit():
    """T 3 lanes with patience 1, so lanes may stop at different epochs:
    each lane's history and best value as JAX's ``fit_trials`` gives them,
    and as the port's own sequential ``fit`` of that trial; the restored
    lane equals that ``fit``'s best parameters."""
    kw = dict(epochs=3, batch_size=16, beta_fn=lambda e: 0.5, patience=1)
    want, got, jstates, keys, lanes = _trial_runs(3, X[:64], X[64:], kw)
    for t in range(3):
        assert len(got[t]["train_loss"]) == len(want[t]["train_loss"])
        for k in ("train_loss", "val_loss", "best_val"):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=2e-4)
    for t in (0, 2):
        st = _port_state("clifford", jstates[t])
        st, seq = loop.fit(
            st, loop.make_mlp_train_step(st.model, st.optimizer),
            loop.make_mlp_eval_step(st.model), keys[t], X[:64], X[64:], **kw)
        for k in ("train_loss", "val_loss", "best_val"):
            np.testing.assert_allclose(got[t][k], seq[k], rtol=1e-5)
        # a lane runs its model's own products and norms, but on the CPU
        # an elementwise function (softplus) rounds otherwise in the vector
        # loop than in its scalar tail, where a single model's few rows
        # fall; Adam's normalised step can carry that near g = 0 up to a
        # fraction of lr (1e-3); a wrong lane would move parameters by
        # whole multiples of lr
        lane = loop.index_trial_state(lanes, t)
        for (n, a), b in zip(lane.model.named_parameters(),
                             st.model.parameters()):
            assert (a - b).abs().max() <= 1e-4, n


def test_fit_trials_short_batch_matches_jax():
    """n_train 18 < batch 32: one short train batch per epoch, validation
    offsets at the caller's batch size."""
    kw = dict(epochs=2, batch_size=32, beta_fn=lambda e: 1.0, patience=5)
    want, got, *_ = _trial_runs(1, X[:18], X[18:50], kw, dist="normal")
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=2e-4)


def test_lane_clip_is_per_lane_and_stacking_round_trips():
    """Two lanes, one gradient above the clip and one below: each lane's
    update equals its own ``ClippedOptimizer``'s, and the moments and step
    count come back out of ``index_trial_state``."""
    singles = [state.create_train_state(mlp_vae.MLPVAE(32, Z, seed=s),
                                        "adamw", 1e-3, device="cpu")
               for s in (0, 1)]
    lanes = loop.stack_trial_states(singles)
    rng = np.random.default_rng(4)
    for _ in range(2):
        grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for n, p in lanes.model.named_parameters()}
        for n, p in lanes.model.named_parameters():
            p.grad = grads[n].clone()
            p.grad[1] *= 1e-3  # lane 1 far below the clip
        norms = lanes.optimizer.step()
        for t, st in enumerate(singles):
            for n, p in st.model.named_parameters():
                p.grad = grads[n][t].clone() * (1e-3 if t else 1.0)
            assert torch.allclose(norms[t], st.optimizer.step(), rtol=1e-6)
    assert norms[0] > 1.0 > norms[1]
    for t, st in enumerate(singles):
        back = loop.index_trial_state(lanes, t)
        for (n, a), b in zip(back.model.named_parameters(),
                             st.model.parameters()):
            assert torch.allclose(a, b, atol=1e-7), n
            mine = back.optimizer.inner.state[a]
            theirs = st.optimizer.inner.state[b]
            assert int(mine["step"]) == int(theirs["step"]) == 2
            assert torch.allclose(mine["exp_avg"], theirs["exp_avg"],
                                  atol=1e-9)
