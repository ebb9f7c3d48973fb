"""The per-token clifford heads through the CNN runner's ``train_model``,
against the JAX package: the hybrid (``HybridVAE``, kappa a token from a
1x1 convolution) and the ViT (``CliffordARVAE``, kappa a token from
``quant_proj``), each narrowed, trained in both packages from JAX's
initial weights (carried by ``param_import``) with one run key on 64
digits of the committed mnist32 shard: one epoch of 4 steps of batch 16
at the fashion runner's lr 1e-3 and its cyclical beta.  As in
tests/test_torch_runner.py, the port must part from JAX by no more than
twice JAX's own parting when its training images move by 1e-6 (normal,
seed 0): in every parameter, and in the best loss (or twice the 1e-4
bar).  ``tests/torch_trajectory_witness.py`` holds the same at the CNN
check's full size over many epochs."""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cliffordtpu.nn.conv_vae import cnn_vae_loss as jax_cnn_vae_loss
from cliffordtpu.runners import cnn_runner as jrunner
from cliffordtpu.serving import _flatten_params
from cliffordtpu_torch import random
from cliffordtpu_torch.data import load_dataset
from cliffordtpu_torch.nn import param_import
from cliffordtpu_torch.runners import cnn_runner
from cliffordtpu_torch.scripts import fashion_train
from cliffordtpu_torch.train import loop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_jax_once  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_BAR = 1e-4
NARROW = {"HybridVAE": dict(encoder_chs=[8, 16, 16]),
          "CliffordARVAE": dict(cnn_chs=[8, 16, 32], z_channels=32,
                                encoder_vit_layers=1, decoder_vit_layers=1)}
ARCH_CLASS = {"hybrid": "HybridVAE", "vit": "CliffordARVAE"}


def _narrow(monkeypatch, module, name):
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda **kw: real(**{**kw, **NARROW[name]}))


def _max_diff(a, b):
    assert set(a) == set(b)
    return max((a[n] - b[n]).abs().max().item() for n in a)


@pytest.fixture(scope="module")
def digits():
    os.environ.setdefault("CLIFFORDTPU_DATA_DIR",
                          os.path.join(ROOT, "tests", "data"))
    ds = load_dataset("mnist32", n_train=64, n_test=32)
    assert ds["source"] != "synthetic"
    return ds["x_train"], ds["x_test"]


@pytest.fixture(scope="module", params=["hybrid", "vit"])
def runs(request, digits):
    """One arch's runs, shared by the tests: JAX's initial weights, and
    from them the port's and JAX's ``train_model`` for one epoch of 4
    steps (JAX's weights, batch and key of each step kept), and JAX's on
    the digits moved by 1e-6."""
    arch, (x_train, x_test) = request.param, digits
    argv = ["--arch", arch, "--epochs", "1", "--batch_size", "16",
            "--warmup_epochs", "1", "--cycle_epochs", "2", "--patience", "0"]
    jargs = torch_jax_once.jax_script("fashion_train").build_parser() \
        .parse_args(argv)
    args = fashion_train.build_parser().parse_args(argv + ["--device", "cpu"])
    for a in (jargs, args):
        a.cur_lr = a.lr
    assert args.lr == 1e-3
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp, jrunner, ARCH_CLASS[arch])
        _narrow(mp, cnn_runner, ARCH_CLASS[arch])
        torch_jax_once.patch(mp, seen)  # the JAX runs share one compile
        run_key = jax.random.fold_in(jax.random.PRNGKey(0), 12345)
        jmodel = jrunner.build_model(jargs, "clifford", 16, 1)
        init = param_import.from_jax(_flatten_params(jax.device_get(
            torch_jax_once.created_once(
                run_key, jmodel, x_train[:2], optimizer="adamw",
                lr=jargs.cur_lr, clip_norm=1.0).params)), "clifford")

        def run_jax(images):
            jstate, jbest, _ = jrunner.train_model(jargs, jmodel, images,
                                                   x_test, run_key)
            return param_import.from_jax(_flatten_params(jax.device_get(
                jstate.params)), "clifford"), jbest

        model = cnn_runner.build_model(args, "clifford", 16, 1)
        assert model.concentration_floor == jmodel.concentration_floor
        model.load_state_dict(init)
        state, best = cnn_runner.train_model(args, model, x_train, x_test,
                                             np.asarray(run_key))[:2]
        want = run_jax(x_train)
        steps = list(seen)
        moved = run_jax((x_train + 1e-6 * np.random.default_rng(0)
                         .standard_normal(x_train.shape)).astype(np.float32))
    got = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    return dict(arch=arch, jmodel=jmodel, model=state.model, init=init,
                port=(got, best), jax=want,
                moved=moved, steps=steps)


def _jax_grad(jmodel):
    """``jax.grad`` of the runner's loss (``make_cnn_train_step``'s)."""
    def loss(params, x, key, beta):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": params}, x,
                                            rngs={"sample": key})
        out = jax_cnn_vae_loss(x, x_recon, q_z, p_z, jmodel.distribution,
                               beta=beta,
                               recon_loss_type=jmodel.recon_loss_type,
                               l1_weight=jmodel.l1_weight)
        return out["total_loss"], out
    return jax.jit(jax.grad(loss, has_aux=True))


@pytest.mark.parametrize("runs", ["vit"], indirect=True)
def test_each_step_at_jax_weights_matches_jax(runs):
    """The ViT, whose parameters the test below cannot hold: each of the
    epoch's 4 steps, at JAX's weights before it, on its batch and key as
    the runner draws them, the port's loss pieces within 1e-5 relative
    and its gradient within 1e-5 relative (L2 over every parameter) of
    ``jax.grad`` (measured 1.6e-6; JAX's own parting under a 1e-6 move of
    the batch 8.6e-7; a fault of the step, a wrong kappa floor or loss
    term, shows as 1e-3 and more)."""
    model, grad = runs["model"], _jax_grad(runs["jmodel"])
    assert len(runs["steps"]) == 4
    for params, x, key, beta in runs["steps"]:
        want, aux = grad(params, x, key, beta)
        want = param_import.from_jax(_flatten_params(jax.device_get(want)),
                                     "clifford")
        model.load_state_dict(param_import.from_jax(_flatten_params(params),
                                                    "clifford"))
        model.zero_grad()
        got = loop._losses(model, torch.as_tensor(np.asarray(x)),
                           random.sample_key(np.asarray(key)), float(beta))
        got["total_loss"].backward()
        for k in ("total_loss", "recon_loss", "kld_loss"):
            assert abs(float(got[k].detach()) - float(aux[k])) <= 1e-5 * abs(
                float(aux[k])), k
        num = sum(float(((p.grad.double() - want[n].double()) ** 2).sum())
                  for n, p in model.named_parameters())
        den = sum(float((w.double() ** 2).sum()) for w in want.values())
        assert math.sqrt(num / den) <= 1e-5, math.sqrt(num / den)


def test_one_epoch_parts_as_jax_from_itself(runs):
    """One epoch of 4 steps through ``train_model``: the best loss within
    twice JAX's own parting (or twice the 1e-4 bar); the hybrid's
    parameters within twice JAX's own parting.  The ViT's part 3.6 times
    as far as JAX's own (9.9e-5 against 2.8e-5), from the first step on,
    in four weights whose clipped gradient is within Adam's eps of zero
    (4e-9 to 4e-8), where float32 rounding decides the step: the test
    above holds its steps."""
    (got, best), (want, jbest), (moved, mbest) = (runs["port"], runs["jax"],
                                                  runs["moved"])
    jax_own = _max_diff(moved, want)
    assert math.isfinite(best) and jax_own > 0
    assert abs(best - jbest) <= 2 * max(abs(mbest - jbest),
                                        LOSS_BAR * abs(jbest)), (best, jbest)
    if runs["arch"] == "hybrid":
        assert _max_diff(got, want) <= 2 * jax_own, (_max_diff(got, want),
                                                     jax_own)
    # the epoch moved the weights well beyond the parting
    assert _max_diff(got, runs["init"]) > 20 * jax_own
