"""The port's ViT VAE modules (cliffordtpu_torch/nn/vit_vae.py), with JAX
weights carried by cliffordtpu_torch/nn/param_import.py, against
cliffordtpu/nn/vit_vae.py (bars from PARITY.md)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn import vit_vae as jvit
from cliffordtpu.serving import _flatten_params
from cliffordtpu_torch.nn import param_import as pi
from cliffordtpu_torch.nn import vit_vae as tvit

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def random_flat_params(module, *args, seed=0):
    """A flax module's param tree filled from numpy: fan-in scaled kernels,
    scales near 1 and nonzero biases, so a swapped or dropped norm
    parameter shows.  Returned flat, as params.npz stores it."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            scale = 1.0 / math.sqrt(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * scale).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return rng.normal(size=s.shape).astype(np.float32)

    return _flatten_params(jax.tree_util.tree_map_with_path(fill, shapes))


def _unflat(flat):
    from cliffordtpu.serving import _unflatten_params

    return {"params": _unflatten_params(
        {k: jnp.asarray(v) for k, v in flat.items()})}


def _load(module, flat, rules):
    module.load_state_dict(pi.convert(flat, rules))
    return module.eval()


def test_transformer_block_matches_jax():
    """The flagship head layout (d 512 = 8 heads of 64, S = 68): < 2e-4."""
    B, S, D, H = 2, 68, 512, 8
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    cos, sin = jvit.rope_2d_cos_sin(32, 8, D // H, cls_token_num=4)
    jblock = jvit.TransformerBlock(D, H)
    flat = random_flat_params(jblock, jnp.asarray(x), jnp.asarray(cos),
                              jnp.asarray(sin), seed=2)
    want = np.asarray(jax.jit(jblock.apply)(_unflat(flat), jnp.asarray(x),
                                            jnp.asarray(cos),
                                            jnp.asarray(sin)))
    port = _load(tvit.TransformerBlock(D, H), flat,
                 pi.transformer_block_rules())
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cos),
                   torch.from_numpy(sin)).numpy()
    assert np.abs(got - want).max() < 2e-4


@pytest.mark.parametrize("kind", ["down", "up"])
def test_res_blocks_match_jax(kind):
    """GroupNorm grouping and eps, strides, paddings and the transposed
    convolutions' kernel flip: < 1e-4."""
    rng = np.random.default_rng(3)
    if kind == "down":
        x = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
        jblock, port, rules = (jvit.ResDownBlock(32),
                               tvit.ResDownBlock(16, 32),
                               pi.res_down_block_rules())
        out_hw = 8
    else:
        x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
        jblock, port, rules = (jvit.ResUpBlock(16), tvit.ResUpBlock(32, 16),
                               pi.res_up_block_rules())
        out_hw = 16
    flat = random_flat_params(jblock, jnp.asarray(x), seed=4)
    want = np.asarray(jax.jit(jblock.apply)(_unflat(flat), jnp.asarray(x)))
    port = _load(port, flat, rules)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.shape[1] == out_hw
    assert np.abs(got - want).max() < 1e-4


TINY = dict(n_heads=1, d_model=64, image_size=32, patch_size=4)


def test_vit_encoder_matches_jax():
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 1))
    x = x.astype(np.float32)
    jenc = jvit.ViTEncoder(n_layers=1, cnn_chs=[16, 32, 64], **TINY)
    flat = random_flat_params(jenc, jnp.asarray(x), seed=6)
    want = np.asarray(jax.jit(jenc.apply)(_unflat(flat), jnp.asarray(x)))
    port = _load(tvit.ViTEncoder(1, cnn_chs=[16, 32, 64], in_channels=1,
                                 **TINY), flat, pi.vit_encoder_rules(flat))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64)
    assert np.abs(got - want).max() < 5e-4


def test_vit_decoder_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 64, 64)).astype(np.float32)
    jdec = jvit.ViTDecoder(n_layers=2, cnn_chs=[64, 32, 16], out_channels=1,
                           **TINY)
    flat = random_flat_params(jdec, jnp.asarray(x), seed=8)
    want = np.asarray(jax.jit(jdec.apply)(_unflat(flat), jnp.asarray(x)))
    port = _load(tvit.ViTDecoder(2, cnn_chs=[64, 32, 16], out_channels=1,
                                 **TINY), flat, pi.vit_decoder_rules(flat))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1)
    assert np.abs(got - want).max() < 5e-4


def test_default_config_and_flagship_shapes_match_jax():
    for size in (32, 64, 128, 256):
        assert tvit.default_config(size) == jvit.default_config(size)
    model = tvit.CliffordARVAE(latent_dim=16, image_size=32, in_channels=1)
    assert model.num_tokens == 64
    n_params = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: jvit.CliffordARVAE(latent_dim=16, image_size=32,
                                   in_channels=1).init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 32, 1))))
    assert n_params == sum(int(np.prod(s.shape)) for s in
                           jax.tree_util.tree_leaves(shapes["params"]))
