"""The reference's torch state_dicts onto the port's modules (port of
``cliffordtpu/utils/torch_interop.py``).

The JAX module turns a state_dict of the reference models (numpy arrays,
``torch_state_dict_to_numpy``) into a flax param tree; here the same
``copy_*`` functions build that tree in numpy, and ``*_from_torch``
carries it onto the port's modules with ``nn/param_import.py::from_jax``,
so a reference checkpoint lands on the port as it lands on the JAX
package, bit for bit:

* Linear (out, in)              -> Dense kernel (in, out): ``.T``
* Conv2d (out, in, kh, kw)      -> Conv kernel (kh, kw, in, out)
* ConvTranspose2d (in, out, kh, kw) -> ConvTranspose kernel (kh, kw, in,
  out) after a spatial flip;
* q and k of every attention block: the output axis permuted from the
  reference's interleaved RoPE pairs (2i, 2i+1) to the half-split basis
  (i, i + hd/2) (``rope_perm_t``);
* the CNN encoder's fc input and the decoder's fc output permuted from
  torch's (C, H, W) flattening to the NHWC (H, W, C) one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cliffordtpu_torch.nn.param_convert import flatten
from cliffordtpu_torch.nn.param_import import from_jax


def linear_t(w):
    return np.asarray(w).T


def conv_t(w):
    return np.asarray(w).transpose(2, 3, 1, 0)


def convtranspose_t(w):
    return np.flip(np.asarray(w), (2, 3)).transpose(2, 3, 0, 1).copy()


def torch_state_dict_to_numpy(torch_module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy()
            for k, v in torch_module.state_dict().items()}


def _count(sd, fmt: str) -> int:
    i = 0
    while any(k.startswith(fmt.format(i)) for k in sd):
        i += 1
    return i


def _subdict(sd, prefix: str):
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _arr(a):
    return np.asarray(a)


def copy_mlp_weights(sd, distribution: str) -> dict:
    """Reference MLPVAE (``mnist/mlp_vae.py:26-47``) -> the flax tree:
    encoder.[0,2] -> enc1/2, decoder.[0,2,4] -> dec1/2/3, fc_mean, and
    fc_var (normal) or fc_scale (the spherical families)."""
    def dense(prefix):
        return {"kernel": linear_t(sd[f"{prefix}.weight"]),
                "bias": _arr(sd[f"{prefix}.bias"])}

    head = "fc_var" if distribution == "normal" else "fc_scale"
    return {"enc1": dense("encoder.0"), "enc2": dense("encoder.2"),
            "fc_mean": dense("fc_mean"), head: dense(head),
            "dec1": dense("decoder.0"), "dec2": dense("decoder.2"),
            "dec3": dense("decoder.4")}


def copy_cnn_encoder_weights(sd, distribution: str) -> dict:
    """Reference CNN ``Encoder`` (``cnn/models.py:42-97``) -> the flax
    ``conv_vae.Encoder`` tree: ResBlock_i {Conv_0 main, Conv_1 skip},
    Dense_0 mu, Dense_1 the second head."""
    new = {}
    for i in range(_count(sd, "blocks.{}.")):
        blk = {"Conv_0": {"kernel": conv_t(sd[f"blocks.{i}.conv.weight"]),
                          "bias": _arr(sd[f"blocks.{i}.conv.bias"])}}
        if f"blocks.{i}.skip.weight" in sd:  # Identity when in == out
            blk["Conv_1"] = {
                "kernel": conv_t(sd[f"blocks.{i}.skip.weight"]),
                "bias": _arr(sd[f"blocks.{i}.skip.bias"])}
        new[f"ResBlock_{i}"] = blk

    def flat_in_t(w):  # torch flattens (C, H, W), the NHWC model (H, W, C)
        out_dim = w.shape[0]
        return linear_t(np.asarray(w).reshape(out_dim, 512, 2, 2)
                        .transpose(0, 2, 3, 1).reshape(out_dim, -1))

    new["Dense_0"] = {"kernel": flat_in_t(sd["fc_mu.weight"]),
                      "bias": _arr(sd["fc_mu.bias"])}
    head = ("fc_log_var" if distribution == "gaussian"
            else "fc_concentration")
    new["Dense_1"] = {"kernel": flat_in_t(sd[f"{head}.weight"]),
                      "bias": _arr(sd[f"{head}.bias"])}
    return new


def copy_cnn_decoder_weights(sd) -> dict:
    """Reference CNN ``Decoder`` (``cnn/models.py:100-131``) -> the flax
    ``conv_vae.Decoder`` tree."""
    w = np.asarray(sd["fc.weight"])  # (512*2*2, latent), rows (C, H, W)
    w = w.reshape(512, 2, 2, w.shape[1]).transpose(1, 2, 0, 3).reshape(
        -1, w.shape[1])
    b = np.asarray(sd["fc.bias"]).reshape(512, 2, 2).transpose(
        1, 2, 0).reshape(-1)
    new = {"Dense_0": {"kernel": linear_t(w), "bias": b}}
    for i in range(_count(sd, "blocks.{}.")):
        blk = {"ConvTranspose_0": {
            "kernel": convtranspose_t(sd[f"blocks.{i}.conv.weight"]),
            "bias": _arr(sd[f"blocks.{i}.conv.bias"])}}
        if f"blocks.{i}.skip.weight" in sd:
            blk["Conv_0"] = {"kernel": conv_t(sd[f"blocks.{i}.skip.weight"]),
                             "bias": _arr(sd[f"blocks.{i}.skip.bias"])}
        new[f"ResUpBlock_{i}"] = blk
    new["ConvTranspose_0"] = {"kernel": convtranspose_t(sd["final.0.weight"]),
                              "bias": _arr(sd["final.0.bias"])}
    return new


def rope_perm_t(w, n_heads: int):
    """``linear_t``, then the q / k output axis permuted from the
    interleaved RoPE pairs (2i, 2i+1) to the half-split basis (i, i +
    hd/2), the same permutation for q and k, so q.k is unchanged."""
    k = linear_t(w)  # (in, out)
    hd = k.shape[1] // n_heads
    idx = np.arange(k.shape[1]).reshape(n_heads, hd)
    perm = np.concatenate([idx[:, 0::2], idx[:, 1::2]], axis=1).reshape(-1)
    return k[:, perm]


def copy_transformer_block_weights(sd, n_heads: int = 1) -> dict:
    """Reference ``TransformerBlock`` (``cnn/cliffordar_model.py:105-116``)
    -> the flax ``vit_vae.TransformerBlock`` tree (split projections)."""
    return {
        "RMSNorm_0": {"scale": _arr(sd["norm1.weight"])},
        "RMSNorm_1": {"scale": _arr(sd["norm2.weight"])},
        "Attention_0": {
            "Dense_0": {"kernel": rope_perm_t(sd["attn.wq.weight"], n_heads)},
            "Dense_1": {"kernel": rope_perm_t(sd["attn.wk.weight"], n_heads)},
            "Dense_2": {"kernel": linear_t(sd["attn.wv.weight"])},
            "Dense_3": {"kernel": linear_t(sd["attn.wo.weight"])},
        },
        "SwiGLU_0": {
            "Dense_0": {"kernel": linear_t(sd["ffn.w1.weight"])},
            "Dense_1": {"kernel": linear_t(sd["ffn.w3.weight"])},
            "Dense_2": {"kernel": linear_t(sd["ffn.w2.weight"])},
        },
    }


def _gn_p(sd, name):
    return {"scale": _arr(sd[f"{name}.weight"]),
            "bias": _arr(sd[f"{name}.bias"])}


def _with_bias(sd, name, kernel):
    p = {"kernel": kernel}
    if f"{name}.bias" in sd:
        p["bias"] = _arr(sd[f"{name}.bias"])
    return p


def _conv_p(sd, name):
    return _with_bias(sd, name, conv_t(sd[f"{name}.weight"]))


def _convT_p(sd, name):
    return _with_bias(sd, name, convtranspose_t(sd[f"{name}.weight"]))


def _dense_p(sd, name):
    return _with_bias(sd, name, linear_t(sd[f"{name}.weight"]))


def _res_down_block_p(sd, prefix):
    """``ResDownBlock`` / ``HybridResDownBlock``: [GN, SiLU, Conv3x3 s2,
    GN, SiLU, Conv3x3] + a Conv2x2-s2 shortcut."""
    return {"GroupNorm_0": _gn_p(sd, f"{prefix}block.0"),
            "Conv_0": _conv_p(sd, f"{prefix}block.2"),
            "GroupNorm_1": _gn_p(sd, f"{prefix}block.3"),
            "Conv_1": _conv_p(sd, f"{prefix}block.5"),
            "Conv_2": _conv_p(sd, f"{prefix}shortcut")}


def _up_block_p(sd, prefix, two_conv: bool):
    """The ViT ``ResUpBlock`` (``two_conv``: the two-conv ``block2``) or
    the ``HybridResUpBlock`` (one conv)."""
    p = {"GroupNorm_0": _gn_p(sd, f"{prefix}block.0"),
         "ConvTranspose_0": _convT_p(sd, f"{prefix}block.2"),
         "GroupNorm_1": _gn_p(sd, f"{prefix}block.3"),
         "Conv_0": _conv_p(sd, f"{prefix}block.5"),
         "ConvTranspose_1": _convT_p(sd, f"{prefix}shortcut"),
         "GroupNorm_2": _gn_p(sd, f"{prefix}block2.0"),
         "Conv_1": _conv_p(sd, f"{prefix}block2.2")}
    if two_conv:
        p["GroupNorm_3"] = _gn_p(sd, f"{prefix}block2.3")
        p["Conv_2"] = _conv_p(sd, f"{prefix}block2.5")
    return p


def copy_vit_encoder_weights(sd, n_heads: int) -> dict:
    """Reference ``ViTEncoder`` (``cliffordar_model.py:212-259``) -> the
    flax ``vit_vae.ViTEncoder`` tree."""
    new = {"Conv_0": _conv_p(sd, "conv_in"),
           "register_token": _arr(sd["register_token.weight"]),
           "RMSNorm_0": {"scale": _arr(sd["norm.weight"])},
           "Dense_0": {"kernel": linear_t(sd["output.weight"])}}
    for i in range(_count(sd, "patchify.0.net.{}.")):
        new[f"ResDownBlock_{i}"] = _res_down_block_p(
            sd, f"patchify.0.net.{i}.")
    for i in range(_count(sd, "layers.{}.")):
        new[f"TransformerBlock_{i}"] = copy_transformer_block_weights(
            _subdict(sd, f"layers.{i}."), n_heads)
    return new


def copy_vit_decoder_weights(sd, n_heads: int) -> dict:
    """Reference ``ViTDecoder`` (``cliffordar_model.py:264-316``) -> the
    flax ``vit_vae.ViTDecoder`` tree."""
    new = {"Conv_0": _conv_p(sd, "conv_in.1"),
           "register_token": _arr(sd["register_token.weight"]),
           "GroupNorm_0": _gn_p(sd, "conv_out.0"),
           "Conv_1": _conv_p(sd, "conv_out.2")}
    for i in range(_count(sd, "layers.{}.")):
        new[f"TransformerBlock_{i}"] = copy_transformer_block_weights(
            _subdict(sd, f"layers.{i}."), n_heads)
    for i in range(_count(sd, "unpatchify.1.net.{}.")):
        new[f"ResUpBlock_{i}"] = _up_block_p(
            sd, f"unpatchify.1.net.{i}.", two_conv=True)
    return new


def _sigmas(sd, new):
    if "log_sigma_0" in sd:
        new["log_sigma_0"] = _arr(sd["log_sigma_0"])
        new["log_sigma_1"] = _arr(sd["log_sigma_1"])
    return new


def copy_cliffordar_weights(sd, n_heads: int) -> dict:
    """Reference ``CliffordARVAE`` (``cliffordar_model.py:369-604``) -> the
    flax ``vit_vae.CliffordARVAE`` tree."""
    return _sigmas(sd, {
        "encoder_vit": copy_vit_encoder_weights(
            _subdict(sd, "encoder_vit."), n_heads),
        "quant_proj": _dense_p(sd, "quant_proj"),
        "post_quant_proj": {"kernel": linear_t(sd["post_quant_proj.weight"])},
        "decoder_vit": copy_vit_decoder_weights(
            _subdict(sd, "decoder_vit."), n_heads)})


def copy_hybrid_vae_weights(sd, distribution: str) -> dict:
    """Reference ``HybridVAE`` (``cliffordar_model.py:712-848``) -> the
    flax ``hybrid_vae.HybridVAE`` tree."""
    enc = {"input_conv": _conv_p(sd, "encoder.input_conv"),
           "fc_mu": _conv_p(sd, "encoder.fc_mu")}
    head = "fc_logvar" if distribution == "gaussian" else "fc_kappa"
    enc[head] = _conv_p(sd, f"encoder.{head}")
    for i in range(_count(sd, "encoder.down_blocks.{}.")):
        enc[f"down_{i}"] = _res_down_block_p(sd, f"encoder.down_blocks.{i}.")
    dec = {"input_proj": _dense_p(sd, "decoder.input_proj"),
           "GroupNorm_0": _gn_p(sd, "decoder.output_conv.0"),
           "output_conv": _conv_p(sd, "decoder.output_conv.2")}
    for i in range(_count(sd, "decoder.up_blocks.{}.")):
        dec[f"up_{i}"] = _up_block_p(sd, f"decoder.up_blocks.{i}.",
                                     two_conv=False)
    return _sigmas(sd, {"encoder": enc, "decoder": dec})


def _port(tree: dict, distribution: str = "clifford"
          ) -> Dict[str, torch.Tensor]:
    return from_jax(flatten(tree), distribution)


def mlpvae_from_torch(sd, distribution: str) -> Dict[str, torch.Tensor]:
    """A reference MLPVAE state_dict -> a state dict for the port's
    ``MLPVAE``."""
    return _port(copy_mlp_weights(sd, distribution), distribution)


def cnnvae_from_torch(encoder_sd, decoder_sd, distribution: str
                      ) -> Dict[str, torch.Tensor]:
    """The reference CNN ``Encoder`` and ``Decoder`` state_dicts -> a state
    dict for the port's ``CNNVAE``."""
    return _port({"encoder": copy_cnn_encoder_weights(encoder_sd,
                                                      distribution),
                  "decoder": copy_cnn_decoder_weights(decoder_sd)},
                 distribution)


def cliffordar_from_torch(sd, n_heads: int) -> Dict[str, torch.Tensor]:
    """A reference ``CliffordARVAE`` state_dict -> a state dict for the
    port's ``CliffordARVAE`` (split, unrolled layout; ``param_convert``
    converts to the fused one)."""
    return _port(copy_cliffordar_weights(sd, n_heads))


def hybridvae_from_torch(sd, distribution: str) -> Dict[str, torch.Tensor]:
    """A reference ``HybridVAE`` state_dict -> a state dict for the port's
    ``HybridVAE``."""
    return _port(copy_hybrid_vae_weights(sd, distribution), distribution)
