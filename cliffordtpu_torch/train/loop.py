"""Train and eval steps, epoch steps, ``fit`` and ``fit_trials`` (port of
``cliffordtpu/train/loop.py``).

A step is eager PyTorch: forward, loss, backward through the hand-written
kernels, global-norm clip, Adam(W).  The losses stay on the device and a
step forces no host synchronisation; ``fit`` and ``fit_trials`` read them
once per epoch.

Keys are two uint32 words.  The MLP steps take the step's rng as the JAX
steps do: it splits into (k_bin, k_sample), and the forward pass samples
with the key flax's ``make_rng("sample")`` derives from k_sample
(``random.sample_key``).  The CNN steps take that sampling key itself;
their epoch step derives it from each step's rng.  Epoch keys follow the
JAX loop: the epoch's key ``fold_in(key, epoch)``, its permutation from
``fold_in(ekey, 0)``, step s from ``fold_in(ekey, s + 1)`` and the
validation batch at offset s from ``fold_in(fold_in(ekey, 10_000), s)``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.data.loaders import (
    binarize_lanes,
    binarize_with_random_threshold,
)
from cliffordtpu_torch.nn.conv_vae import cnn_vae_loss
from cliffordtpu_torch.nn.losses import vae_loss_from_outputs
from cliffordtpu_torch.nn.mlp_vae import LaneMLPVAE, MLPVAE
from cliffordtpu_torch.train.state import (
    ClippedOptimizer,
    LaneClippedOptimizer,
    TrainState,
)

VAL_FOLD = 10_000  # fold_in(ekey, VAL_FOLD) keys an epoch's validation


def _losses(model, x, key, beta, rows=None, call=None
            ) -> Dict[str, torch.Tensor]:
    """``cnn_vae_loss`` of ``model`` on ``x``; ``rows`` as the model's
    ``forward``; ``call`` runs the forward in the model's place (a
    wrapper of it, such as DDP's)."""
    x_recon, q_z, p_z, _ = (call or model)(x, key, rows=rows)
    return cnn_vae_loss(x, x_recon, q_z, p_z, model.distribution, beta=beta,
                        recon_loss_type=model.recon_loss_type,
                        l1_weight=model.l1_weight,
                        sigmas=model.loss_sigmas())


def _train_step(optimizer, loss_fn, total: str,
                after_backward: Optional[Callable] = None,
                reduce: Optional[Callable] = None) -> Callable:
    """``step(x, key, beta) -> losses``: loss, backward, clip, update;
    ``losses`` gains ``grad_norm``, the norm from before the clip.
    ``after_backward()`` runs between the backward pass and the update,
    and ``reduce`` maps the detached losses before they are returned (the
    sharded step's gradient and loss all-reduces)."""

    def train_step(x, key, beta):
        optimizer.zero_grad()
        losses = loss_fn(x, key, beta)
        losses[total].sum().backward()  # a lane's gradient is its own
        if after_backward is not None:
            after_backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if reduce is not None:
            losses = reduce(losses)
        losses["grad_norm"] = optimizer.step()
        return losses

    return train_step


def make_cnn_train_step(model, optimizer: ClippedOptimizer) -> Callable:
    """``train_step(x, key, beta) -> losses`` for ``CNNVAE`` and
    ``CliffordARVAE`` (with the learnable-beta sigmas when the model has
    them, and then ``beta`` is not used): loss,
    backward, clip at the optimizer's ``clip_norm``, update.  ``x`` is a
    batch of images (B, H, W, C) on the model's device, ``key`` the
    sampling key (two uint32 words), ``beta`` a float or a scalar tensor on
    the device.  ``losses`` holds the five outputs of ``cnn_vae_loss`` and
    ``grad_norm``, the global gradient norm from before the clip."""
    return _train_step(optimizer, lambda x, key, beta: _losses(
        model, x, key, beta), "total_loss")


def make_cnn_eval_step(model) -> Callable:
    """``eval_step(x, key, beta) -> losses`` without gradients."""

    @torch.no_grad()
    def eval_step(x, key, beta):
        return _losses(model, x, key, beta)

    return eval_step


def mlp_losses(model, x, key, beta, binarize: bool = True
               ) -> Dict[str, torch.Tensor]:
    """The loss pieces of one MLP step on the step's rng ``key``, without
    the backward pass and the update."""
    k_bin, k_sample = random.split_words(key)
    if binarize:
        x = binarize_with_random_threshold(k_bin, x)
    return vae_loss_from_outputs(x, model(x, random.sample_key(k_sample)),
                                 beta)


def make_mlp_train_step(model, optimizer: ClippedOptimizer,
                        binarize: bool = True) -> Callable:
    """``train_step(x, key, beta) -> losses`` for ``MLPVAE``: ``key`` (the
    step's rng) splits into (k_bin, k_sample); x (B, ...) is binarised on
    k_bin, the forward pass samples with ``sample_key(k_sample)``; then
    the BCE ELBO (``vae_loss_from_outputs``), backward, clip, update.
    ``losses``: total, recon, kl, entropy, elbo and grad_norm."""
    return _train_step(optimizer, lambda x, key, beta: mlp_losses(
        model, x, key, beta, binarize), "total")


def make_mlp_eval_step(model, binarize: bool = True) -> Callable:
    """``eval_step(x, key, beta) -> losses`` without gradients."""

    @torch.no_grad()
    def eval_step(x, key, beta):
        return mlp_losses(model, x, key, beta, binarize)

    return eval_step


def _run_epoch(step, batches, key, beta) -> Dict[str, torch.Tensor]:
    """``step`` over the stacked batches (S, B, ...) with step keys
    ``fold_in(key, i + 1)``; the losses stacked (S,) on the device."""
    out = [step(xb, random.fold_in_words(key, i + 1), beta)
           for i, xb in enumerate(batches)]
    return {k: torch.stack([o[k] for o in out]) for k in out[0]}


def make_mlp_epoch_step(model, optimizer: ClippedOptimizer,
                        binarize: bool = True) -> Callable:
    """``epoch_step(batches, key, beta) -> losses``: the MLP train step over
    every batch of (S, B, ...), the step keys of ``fit``'s per-step path,
    each loss stacked to (S,)."""
    return functools.partial(_run_epoch, make_mlp_train_step(
        model, optimizer, binarize))


def make_cnn_epoch_step(model, optimizer: ClippedOptimizer) -> Callable:
    """``make_mlp_epoch_step`` for ``CNNVAE`` / ``CliffordARVAE``: step i
    samples with ``sample_key(fold_in(key, i + 1))``."""
    step = make_cnn_train_step(model, optimizer)
    return lambda batches, key, beta: _run_epoch(
        lambda xb, skey, b: step(xb, random.sample_key(skey), b), batches,
        key, beta)


def stack_epoch_batches(x_train, perm, steps: int, batch_size: int
                        ) -> torch.Tensor:
    """The first steps * batch_size rows of ``x_train`` in the order of
    ``perm``, as (steps, batch_size, ...) on x_train's device; the tail
    (n % batch_size) is dropped, as by the per-step path."""
    x = torch.as_tensor(x_train)
    idx = torch.as_tensor(perm[:steps * batch_size], device=x.device)
    return x[idx].reshape(steps, batch_size, *x.shape[1:])


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def fit(state: TrainState, train_step, eval_step, key, x_train, x_val, *,
        epochs: int, batch_size: int, beta_fn: Callable[[int], float],
        patience: int = 50,
        log_fn: Optional[Callable[[int, Dict], None]] = None,
        epoch_step=None) -> Tuple[TrainState, Dict]:
    """The epoch loop with validation early stopping and best-parameter
    restore of the JAX ``fit``: ``train_step`` / ``eval_step`` from
    ``make_mlp_*_step`` on ``state``'s model; an epoch trains through
    ``epoch_step`` (``make_mlp_epoch_step``'s form), by default
    ``train_step`` over the epoch's batches.  Arrays or tensors
    ``x_train``, ``x_val`` are moved to the state's device once.  With
    n < batch_size an epoch trains one short batch.  Returns the state
    with its best parameters and ``{"train_loss", "val_loss",
    "best_val"}``."""
    device = state.device
    x_train, x_val = _on(x_train, device), _on(x_val, device)
    n, n_val = x_train.shape[0], x_val.shape[0]
    train_bs = min(batch_size, n)
    steps = max(1, n // train_bs)
    epoch_step = epoch_step or functools.partial(_run_epoch, train_step)
    best_val = float("inf")
    best_params = _snapshot(state.model)
    patience_counter = 0
    history = {"train_loss": [], "val_loss": []}
    for epoch in range(epochs):
        beta_f = beta_fn(epoch)
        beta = torch.full((), beta_f, dtype=torch.float32, device=device)
        ekey = random.fold_in_words(key, epoch)
        perm = random.permutation(random.fold_in_words(ekey, 0), n, device)
        ep = epoch_step(stack_epoch_batches(x_train, perm, steps, train_bs),
                        ekey, beta)
        ep_loss = ep["total"].mean().double()
        ep_gnorm = ep["grad_norm"].mean().double()
        vkey = random.fold_in_words(ekey, VAL_FOLD)
        val_sum = torch.zeros((), dtype=torch.float64, device=device)
        for s in range(0, n_val, batch_size):
            xb = x_val[s:s + batch_size]
            v = eval_step(xb, random.fold_in_words(vkey, s), beta)
            val_sum = val_sum + v["total"].double() * xb.shape[0]
        # the one copy to the host of this epoch
        ep_loss, ep_gnorm, val_loss = torch.stack(
            [ep_loss, ep_gnorm, val_sum / n_val]).tolist()
        history["train_loss"].append(ep_loss)
        history["val_loss"].append(val_loss)
        if log_fn:
            log_fn(epoch, {"train_loss": ep_loss, "val_loss": val_loss,
                           "grad_norm": ep_gnorm, "beta": beta_f})
        if np.isfinite(val_loss) and val_loss < best_val:
            best_val = val_loss
            best_params = _snapshot(state.model)
            patience_counter = 0
        else:
            patience_counter += 1
            if patience_counter >= patience:
                break
    state.model.load_state_dict(best_params)
    history["best_val"] = best_val
    return state, history


# ---- batched trials: T lanes of one MLPVAE in stacked parameters ----


def _rebuild_optimizer(source: ClippedOptimizer, source_model, model,
                       moments: Callable, cls) -> ClippedOptimizer:
    """An optimizer of ``source``'s kind and hyperparameters over
    ``model``'s parameters (matched by name), its state from
    ``moments(name, state)`` for each of ``source``'s parameter states."""
    names = {id(p): n for n, p in source_model.named_parameters()}
    params = dict(model.named_parameters())
    inner0 = source.inner
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [params[names[id(p)]] for p in g["params"]]}
              for g in inner0.param_groups]
    # each group carries every hyperparameter of its source group
    inner = type(inner0)(groups, fused=inner0.defaults["fused"])
    for p, st in inner0.state.items():
        if st:
            inner.state[params[names[id(p)]]] = moments(names[id(p)], st)
    return cls(inner, source.clip_norm, source.accum_steps)


def stack_trial_states(states: Sequence[TrainState]) -> TrainState:
    """T train states of one ``MLPVAE`` shape and one optimizer setting ->
    one state of a ``LaneMLPVAE`` (every parameter stacked on a leading
    lane axis) with a ``LaneClippedOptimizer`` (Adam's moments stacked, the
    step count shared; lanes must have taken equal steps)."""
    s0, m0 = states[0], states[0].model
    if any(s.optimizer.micro_step for s in states):
        raise ValueError("cannot stack states inside an accumulation cycle")
    model = LaneMLPVAE(len(states), m0.h_dim, m0.z_dim, m0.distribution,
                       m0.l2_normalize, m0.sampler).to(s0.device)
    dicts = [s.model.state_dict() for s in states]
    model.load_state_dict({k: torch.stack([d[k] for d in dicts])
                           for k in dicts[0]})
    per_lane = [{n: s.optimizer.inner.state[p]
                 for n, p in s.model.named_parameters()} for s in states]

    def moments(name, st):
        lanes = [pl[name] for pl in per_lane]
        if any(int(ln["step"]) != int(st["step"]) for ln in lanes):
            raise ValueError("lanes have taken different numbers of steps")
        return {k: v.clone() if k == "step" else torch.stack(
            [ln[k] for ln in lanes]) for k, v in st.items()}

    opt = _rebuild_optimizer(s0.optimizer, m0, model, moments,
                             LaneClippedOptimizer)
    return TrainState(model=model.train(), optimizer=opt, device=s0.device)


def index_trial_state(states: TrainState, t: int) -> TrainState:
    """Lane t of a stacked state as the train state of one ``MLPVAE``."""
    lm = states.model
    model = MLPVAE(lm.h_dim, lm.z_dim, lm.distribution, lm.l2_normalize,
                   lm.sampler, seed=None).to(states.device)
    model.load_state_dict({k: v[t] for k, v in lm.state_dict().items()})
    opt = _rebuild_optimizer(
        states.optimizer, lm, model,
        lambda name, st: {k: v.clone() if k == "step" else v[t].clone()
                          for k, v in st.items()}, ClippedOptimizer)
    return TrainState(model=model.train(), optimizer=opt,
                      device=states.device)


def lane_losses(model: LaneMLPVAE, x, kbins, ksamples, beta,
                binarize: bool = True) -> Dict[str, torch.Tensor]:
    """``mlp_losses`` of every lane of a ``LaneMLPVAE`` at once: x (T, B,
    ...), ``kbins`` the lanes' binarisation keys as int64 (T, 2) on x's
    device and ``ksamples`` their T sampling keys (``lane_keys``); every
    piece (T,)."""
    if binarize:
        x = binarize_lanes(kbins, x)
    return vae_loss_from_outputs(x, model(x, ksamples), beta, lane_axes=1)


def make_lane_train_step(model: LaneMLPVAE, optimizer: LaneClippedOptimizer,
                         binarize: bool = True) -> Callable:
    """``train_step(x, (kbins, ksamples), beta) -> losses``: one train step
    of every lane (``lane_losses``, backward, the per-lane clip, Adam);
    every piece and ``grad_norm`` (T,)."""
    return _train_step(optimizer, lambda x, keys, beta: lane_losses(
        model, x, *keys, beta, binarize), "total")


def lane_keys(rngs, device):
    """The split of every lane's rng of every step: the binarisation words
    as one int64 tensor (steps, T, 2) on ``device`` (one copy) and the
    forward sampling keys, a list per step."""
    pairs = [[random.split_words(k) for k in step] for step in rngs]
    return (torch.tensor([[b for b, _ in step] for step in pairs],
                         dtype=torch.int64, device=device),
            [[random.sample_key(s) for _, s in step] for step in pairs])


def fit_trials(states: TrainState, keys, x_train, x_val, *, epochs: int,
               batch_size: int, beta_fn: Callable[[int], float],
               patience: int = 50, binarize: bool = True,
               log_fn: Optional[Callable[[int, Dict], None]] = None):
    """``fit`` for T trials at once: ``states`` from ``stack_trial_states``
    and ``keys`` T keys (T, 2).  Lane t draws its own permutation, step
    and validation keys from keys[t] as the sequential ``fit`` does, and
    runs what that ``fit`` runs with ``make_mlp_train_step`` /
    ``make_mlp_eval_step``; every step is one pass over all lanes (one
    draw of the latent per lane).  Early stopping is per lane: a lane whose
    patience runs out keeps computing, but its history and best
    parameters freeze; the loop ends when every lane has stopped.  The
    train batch is capped at n, the validation offsets keep
    ``batch_size``.  Returns the stacked states with each lane's best
    parameters and the T histories."""
    model, opt, device = states.model, states.optimizer, states.device
    T = model.lanes
    keys = [random.key_words(k) for k in keys]
    if len(keys) != T:
        raise ValueError(f"{T} lanes need {T} keys, got {len(keys)}")
    x_train, x_val = _on(x_train, device), _on(x_val, device)
    n, n_val = x_train.shape[0], x_val.shape[0]
    train_bs = min(batch_size, n)
    steps = max(1, n // train_bs)
    offsets = range(0, n_val, batch_size)

    step = make_lane_train_step(model, opt, binarize)

    @torch.no_grad()
    def val_losses(kbins, ksamples, beta) -> torch.Tensor:
        total = torch.zeros(T, dtype=torch.float64, device=device)
        for i, s in enumerate(offsets):
            xb = x_val[s:s + batch_size].expand(T, -1, -1)
            v = lane_losses(model, xb, kbins[i], ksamples[i], beta,
                            binarize)["total"]
            total += v.double() * xb.shape[1]
        return total / n_val

    best_val = np.full(T, np.inf)
    best_params = _snapshot(model)
    patience_ctr = np.zeros(T, np.int64)
    stopped = np.zeros(T, bool)
    histories = [{"train_loss": [], "val_loss": []} for _ in range(T)]
    for epoch in range(epochs):
        beta_f = beta_fn(epoch)
        beta = torch.full((), beta_f, dtype=torch.float32, device=device)
        ekeys = [random.fold_in_words(k, epoch) for k in keys]
        ids = torch.stack([random.permutation(
            random.fold_in_words(ek, 0), n, device)[:steps * train_bs]
            for ek in ekeys]).reshape(T, steps, train_bs)
        vkeys = [random.fold_in_words(ek, VAL_FOLD) for ek in ekeys]
        kbins, ksamples = lane_keys(
            [[random.fold_in_words(ek, i + 1) for ek in ekeys]
             for i in range(steps)]
            + [[random.fold_in_words(vk, s) for vk in vkeys]
               for s in offsets], device)
        ep = [step(x_train[ids[:, i]], (kbins[i], ksamples[i]), beta)
              for i in range(steps)]
        ep_loss = torch.stack([e["total"] for e in ep]).mean(0)
        ep_gnorm = torch.stack([e["grad_norm"] for e in ep]).mean(0)
        val = val_losses(kbins[steps:], ksamples[steps:], beta)
        # the one copy to the host of this epoch
        ep_loss, ep_gnorm, val_loss = torch.stack(
            [ep_loss.double(), ep_gnorm.double(), val]).cpu().numpy()
        active = ~stopped
        for t in np.nonzero(active)[0]:
            histories[t]["train_loss"].append(float(ep_loss[t]))
            histories[t]["val_loss"].append(float(val_loss[t]))
        if log_fn:
            log_fn(epoch, {"train_loss": float(ep_loss[active].mean()),
                           "val_loss": float(val_loss[active].mean()),
                           "grad_norm": float(ep_gnorm[active].mean()),
                           "beta": beta_f,
                           "active_trials": int(active.sum())})
        improved = active & np.isfinite(val_loss) & (val_loss < best_val)
        if improved.any():
            sel = torch.as_tensor(improved, device=device)
            for k, v in model.state_dict().items():
                b = best_params[k]
                b.copy_(torch.where(sel.reshape((T,) + (1,) * (v.dim() - 1)),
                                    v, b))
            best_val = np.where(improved, val_loss, best_val)
        patience_ctr = np.where(improved, 0,
                                patience_ctr + active.astype(np.int64))
        stopped = stopped | (patience_ctr >= patience)
        if stopped.all():
            break
    model.load_state_dict(best_params)
    for t in range(T):
        histories[t]["best_val"] = float(best_val[t])
    return states, histories
