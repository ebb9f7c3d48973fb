"""cliffordtpu_torch/utils/torch_interop.py: the reference's torch
state_dicts onto the port's modules.  There is no reference checkpoint
here, so each test builds a synthetic state_dict with the key names and
shapes that the JAX package's ``copy_*`` functions read (numpy values
from a seed), and sends it (a) through JAX's ``copy_*`` and
``param_import.from_jax`` and (b) through the port's ``*_from_torch``:
the two state dicts are equal exactly, and a forward of each agrees."""

import numpy as np
import pytest
import torch

from cliffordtpu.serving import _flatten_params
from cliffordtpu.utils import torch_interop as jinterop
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
from cliffordtpu_torch.nn.mlp_vae import MLPVAE
from cliffordtpu_torch.nn.param_import import from_jax
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
from cliffordtpu_torch.utils import torch_interop

torch.set_num_threads(1)

# port block part -> the reference's, in the down / up residual blocks
DOWN = {"norm1": "block.0", "conv1": "block.2", "norm2": "block.3",
        "conv2": "block.5", "shortcut": "shortcut"}
UP = {**DOWN, "norm3": "block2.0", "conv3": "block2.2", "norm4": "block2.3",
      "conv4": "block2.5"}
MLP = {"enc1": "encoder.0", "enc2": "encoder.2", "dec1": "decoder.0",
       "dec2": "decoder.2", "dec3": "decoder.4"}
CNN = {"mu": "fc_mu", "kappa": "fc_concentration", "log_var": "fc_log_var",
       "conv_out": "final.0"}


def _block(rest, parts, path):
    i, part, leaf = rest.split(".", 2)
    return f"{path}.{i}.{parts[part]}.{leaf}"


def mlp_ref(name):
    layer, leaf = name.split(".")
    return f"{MLP.get(layer, layer)}.{leaf}"


def cnn_ref(name):
    """An encoder or decoder parameter, without its ``encoder.`` /
    ``decoder.`` prefix (the reference keeps two state_dicts)."""
    head, leaf = name.rsplit(".", 1)
    return f"{CNN.get(head, head)}.{leaf}"


def vit_ref(name):
    top, rest = name.split(".", 1)
    if top not in ("encoder_vit", "decoder_vit"):
        return name
    if rest == "register_token":
        return f"{top}.register_token.weight"
    if rest.startswith("down."):
        return f"{top}." + _block(rest[5:], DOWN, "patchify.0.net")
    if rest.startswith("up."):
        return f"{top}." + _block(rest[3:], UP, "unpatchify.1.net")
    if top == "decoder_vit":
        head, leaf = rest.rsplit(".", 1)
        head = {"conv_in": "conv_in.1", "norm_out": "conv_out.0",
                "conv_out": "conv_out.2"}.get(head, head)
        return f"{top}.{head}.{leaf}"
    return name


def hybrid_ref(name):
    top, rest = name.split(".", 1)
    if rest.startswith("down."):
        return f"{top}." + _block(rest[5:], DOWN, "down_blocks")
    if rest.startswith("up."):
        return f"{top}." + _block(rest[3:], UP, "up_blocks")
    head, leaf = rest.rsplit(".", 1)
    head = {"norm_out": "output_conv.0",
            "output_conv": "output_conv.2"}.get(head, head) \
        if top == "decoder" else head
    return f"{top}.{head}.{leaf}"


def _synthetic(model, ref, prefix="", seed=0):
    """{reference key: random array of the port parameter's shape} for the
    parameters of ``model`` under ``prefix`` (the reference keeps torch's
    layouts, so the shapes are the port's)."""
    rng = np.random.default_rng(seed)
    return {ref(name[len(prefix):]): rng.normal(size=tuple(p.shape))
            .astype(np.float32)
            for name, p in model.named_parameters()
            if name.startswith(prefix)}


def _equal_and_forward(model_a, model_b, sd_a, sd_b, x, call):
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    model_a.load_state_dict(sd_a)
    model_b.load_state_dict(sd_b)
    with torch.no_grad():
        torch.testing.assert_close(call(model_a, x), call(model_b, x),
                                   rtol=0, atol=0)


def _images(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


@pytest.mark.parametrize("dist", ["normal", "clifford"])
def test_mlp_state_dict(dist):
    model = MLPVAE(32, 5, dist)
    sd = _synthetic(model, mlp_ref)
    head = "fc_var" if dist == "normal" else "fc_scale"
    params = {n: {} for n in ("enc1", "enc2", "fc_mean", head, "dec1",
                              "dec2", "dec3")}
    flat = _flatten_params(jinterop.copy_mlp_weights(sd, params, dist))
    _equal_and_forward(model, MLPVAE(32, 5, dist), from_jax(flat, dist),
                       torch_interop.mlpvae_from_torch(sd, dist),
                       _images((3, 784)) * 0.5 + 0.5,
                       lambda m, x: m.encode(x)[0])


@pytest.mark.parametrize("dist", ["gaussian", "clifford"])
def test_cnn_state_dicts(dist):
    model = CNNVAE(latent_dim=16, in_channels=1, distribution=dist,
                   img_size=32)
    enc = _synthetic(model, cnn_ref, prefix="encoder.")
    dec = _synthetic(model, cnn_ref, prefix="decoder.", seed=1)
    n_down = len(model.encoder.blocks)
    n_up = len(model.decoder.blocks)
    tree = {"encoder": jinterop.copy_cnn_encoder_weights(
        enc, {f"ResBlock_{i}": {} for i in range(n_down)}, dist),
        "decoder": jinterop.copy_cnn_decoder_weights(
            dec, {f"ResUpBlock_{i}": {} for i in range(n_up)})}
    _equal_and_forward(
        model, CNNVAE(latent_dim=16, in_channels=1, distribution=dist,
                      img_size=32),
        from_jax(_flatten_params(tree), dist),
        torch_interop.cnnvae_from_torch(enc, dec, dist),
        _images((2, 32, 32, 1)),
        lambda m, x: m.decode(m.encode(x)[0] if dist == "gaussian"
                              else torch.cat([torch.cos(m.encode(x)[0]),
                                              torch.sin(m.encode(x)[0])],
                                             -1)))


def test_cliffordar_state_dict():
    """q and k rows carried from the reference's interleaved RoPE pairs to
    the half-split basis (``rope_perm_t``), two heads."""
    kw = dict(latent_dim=8, image_size=32, in_channels=1,
              cnn_chs=[16, 32, 128], z_channels=128, encoder_vit_layers=1,
              decoder_vit_layers=2, patch_size=4)
    model = CliffordARVAE(**kw)
    sd = _synthetic(model, vit_ref)
    flat = _flatten_params(jinterop.copy_cliffordar_weights(sd, 2))
    _equal_and_forward(model, CliffordARVAE(**kw), from_jax(flat),
                       torch_interop.cliffordar_from_torch(sd, 2),
                       _images((2, 32, 32, 1)),
                       lambda m, x: m.encode_heads(x)[0])


@pytest.mark.parametrize("dist", ["gaussian", "clifford"])
def test_hybrid_state_dict(dist):
    model = HybridVAE(latent_dim=8, in_channels=1, distribution=dist,
                      encoder_chs=[8, 16, 16], img_size=32)
    sd = _synthetic(model, hybrid_ref)
    flat = _flatten_params(jinterop.copy_hybrid_vae_weights(sd, dist))
    _equal_and_forward(
        model, HybridVAE(latent_dim=8, in_channels=1, distribution=dist,
                         encoder_chs=[8, 16, 16], img_size=32),
        from_jax(flat, dist), torch_interop.hybridvae_from_torch(sd, dist),
        _images((2, 32, 32, 1)), lambda m, x: m.encoder(x)[0])
