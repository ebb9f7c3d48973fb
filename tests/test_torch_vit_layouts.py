"""The ViT's two other block layouts in the port (``fused_proj`` and
``scan_layers``, cliffordtpu_torch/nn/vit_vae.py) held against the JAX
package: ``param_convert`` exactly against JAX's on the same numpy trees;
the forward of every layout on weights carried from JAX's model of that
layout (< 5e-4 of the largest value, the full-stack bar); one train step
of the fused + stacked model against JAX's step on the same weights and
key; the port's own checkpoints restored across projection layouts."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn import param_convert as jconvert
from cliffordtpu.nn.vit_vae import CliffordARVAE as JaxViT
from cliffordtpu.serving import _flatten_params
from cliffordtpu.train.loop import make_cnn_train_step as jax_step
from cliffordtpu.train.state import create_train_state as jax_state
from cliffordtpu_torch import random as trandom
from cliffordtpu_torch.nn import param_convert, param_import
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
from cliffordtpu_torch.train import checkpoint
from cliffordtpu_torch.train.loop import make_cnn_train_step
from cliffordtpu_torch.train.state import create_train_state

torch.set_num_threads(1)

KW = dict(latent_dim=8, image_size=32, in_channels=1, cnn_chs=[8, 16, 64],
          z_channels=64, encoder_vit_layers=1, decoder_vit_layers=2,
          patch_size=4)
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["split", "fused", "scan", "fused_scan"]
KEY = jax.random.PRNGKey(3)
BAR = 5e-4


def _x(b=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 1)) \
        .astype(np.float32)


def _jax(fused, scan, seed=0):
    """The JAX model of a layout and random numpy weights in its tree
    (shapes from ``eval_shape``: no compile)."""
    model = JaxViT(**KW, fused_proj=fused, scan_layers=scan)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 32, 32, 1)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) / np.sqrt(max(
            1, a.shape[-2] if len(a.shape) >= 2 else 1))).astype(np.float32)
        if len(a.shape) >= 2 else np.ones(a.shape, np.float32), shapes)
    return model, params


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_param_convert_is_jax_exactly(scan):
    """fuse / unfuse / detect on a JAX tree and on Adam moment trees of
    its shape, in both packages: the same arrays bit for bit, and the
    round trip is the identity."""
    _, params = _jax(False, scan)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(1)
    moments = {"mu": jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)}
    for t in (tree, moments):
        mine, theirs = copy.deepcopy(t), copy.deepcopy(t)
        assert param_convert.fuse_vit_params(mine, 1) == \
            jconvert.fuse_vit_params(theirs, 1) > 0
        assert param_convert.detect_proj_layout(mine) == \
            jconvert.detect_proj_layout(theirs) == "fused"
        for (ka, va), (kb, vb) in zip(
                jax.tree_util.tree_flatten_with_path(mine)[0],
                jax.tree_util.tree_flatten_with_path(theirs)[0]):
            assert ka == kb and np.array_equal(va, vb)
        assert param_convert.unfuse_vit_params(mine, 1) > 0
        for a, b in zip(jax.tree_util.tree_leaves(mine),
                        jax.tree_util.tree_leaves(t)):
            assert np.array_equal(a, b)
    flat = _flatten_params(params)
    assert param_convert.flatten(param_convert.nest(flat)).keys() == \
        flat.keys()


@pytest.mark.parametrize("fused,scan", LAYOUTS, ids=IDS)
def test_layout_forward_matches_jax_on_carried_weights(fused, scan):
    """encode_z (the keyed draw on JAX's key) and decode of the port's
    model of each layout, weights carried from JAX's model of the same
    layout by ``from_jax``, within the full-stack bar; ``to_jax`` gives
    the JAX tree back exactly."""
    model, params = _jax(fused, scan)
    flat = {k: np.asarray(v) for k, v in _flatten_params(params).items()}
    port = CliffordARVAE(**KW, fused_proj=fused, scan_layers=scan)
    port.load_state_dict(param_import.from_jax(flat))
    back = param_import.to_jax(port)
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    x = _x()
    jz = model.apply({"params": params}, jnp.asarray(x),
                     method=model.get_flat_latent, rngs={"sample": KEY})
    jr = model.apply({"params": params}, jz, method=model.decode)
    with torch.no_grad():
        tz = port.get_flat_latent(torch.from_numpy(x),
                                  trandom.sample_key(np.asarray(KEY)))
        tr = port.decode(tz)
    assert _rel(tz.numpy(), jz) < BAR
    assert _rel(tr.numpy(), jr) < BAR


def test_fused_scan_step_matches_jax():
    """One AdamW step of the fused + stacked model from JAX's weights and
    key, batch 4: the loss pieces and the gradient norm from before the
    clip within the full-stack bar.  (The parameters after a first Adam
    step are lr * g / (|g| + eps): where |g| is within rounding of zero
    they move by up to lr either way, so they are not held here.)"""
    model = JaxViT(**KW, fused_proj=True, scan_layers=True)
    x = _x(4, 2)
    st = jax_state(jax.random.PRNGKey(0), model, jnp.asarray(x[:2]),
                   optimizer="adamw", lr=1e-4)
    flat = {k: np.asarray(v) for k, v in _flatten_params(st.params).items()}
    port = CliffordARVAE(**KW, fused_proj=True, scan_layers=True)
    port.load_state_dict(param_import.from_jax(flat))
    pst = create_train_state(port, "adamw", 1e-4, device="cpu")
    key = jax.random.PRNGKey(7)
    st, jl = jax_step(model)(st, jnp.asarray(x), key, jnp.float32(1.0))
    tl = make_cnn_train_step(pst.model, pst.optimizer)(
        torch.from_numpy(x), trandom.sample_key(np.asarray(key)), 1.0)
    for k in ("total_loss", "recon_loss", "kld_loss", "grad_norm"):
        assert abs(float(tl[k]) - float(jl[k])) <= BAR * abs(float(jl[k])), k


def test_restore_converts_between_projection_layouts(tmp_path):
    """A port checkpoint of the split model restored into a fused one
    (and back): parameters, Adam moments and steps carried through
    ``param_convert``, so the next step is the one the split run takes."""
    x = torch.from_numpy(_x(2, 3))
    split = create_train_state(CliffordARVAE(**KW, seed=2), "adamw", 1e-3,
                               device="cpu")
    step = make_cnn_train_step(split.model, split.optimizer)
    step(x, (0, 1), 1.0)
    checkpoint.save_checkpoint(str(tmp_path), split, step=1)
    want = float(step(x, (0, 2), 1.0)["total_loss"])
    fused = create_train_state(CliffordARVAE(**KW, fused_proj=True, seed=5),
                               "adamw", 1e-3, device="cpu")
    meta = checkpoint.restore_checkpoint(
        fused, checkpoint.load_checkpoint(str(tmp_path)))
    assert meta["step"] == 1
    got = float(make_cnn_train_step(fused.model, fused.optimizer)(
        x, (0, 2), 1.0)["total_loss"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    checkpoint.save_checkpoint(str(tmp_path), fused, step=2)
    back = create_train_state(CliffordARVAE(**KW, seed=6), "adamw", 1e-3,
                              device="cpu")
    checkpoint.restore_checkpoint(back,
                                  checkpoint.load_checkpoint(str(tmp_path)))
    for (n, p), (_, q) in zip(back.model.named_parameters(),
                              split.model.named_parameters()):
        assert p.shape == q.shape, n
