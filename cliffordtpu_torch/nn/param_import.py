"""Carry JAX ``CliffordARVAE``, ``CNNVAE``, ``HybridVAE`` or ``MLPVAE``
parameters, or a gradient tree of the same layout, into the port's
modules.

Input is the flat dict that ``cliffordtpu/serving.py::_flatten_params``
writes to ``params.npz`` (keys like
``"encoder_vit/ResDownBlock_0/Conv_0/kernel"``), as numpy arrays.  Rules:

* Dense kernel (in, out)             -> Linear weight (out, in): ``.T``
* Conv kernel HWIO                   -> Conv2d weight OIHW
* ConvTranspose kernel (kh, kw, in, out) -> ConvTranspose2d weight
  (in, out, kh, kw) after a spatial flip (torch's transposed convolution
  correlates with the flipped kernel; flax's ``transpose_kernel=False``
  does not)
* RMSNorm / GroupNorm ``scale``      -> ``weight``; ``bias`` as it is
* ``register_token``, ``log_sigma_0`` / ``log_sigma_1`` as they are

The ``CNNVAE`` modules flatten and unflatten their 2 x 2 x 512 feature map
in JAX's NHWC order (``nn/conv_vae.py``), so the encoder's heads and the
decoder's first Dense are plain Dense kernels here, with no permutation of
their rows or columns.  The encoder's second head, ``encoder/Dense_1``, is
``log_var`` (width d) for the gaussian latent and ``kappa`` (width 1) for
the others.  ``HybridVAE``'s heads are 1x1 convolutions: ``fc_mu`` and
``fc_logvar`` (gaussian) or ``fc_kappa`` (the others), whichever the tree
holds.  The widths of ``quant_proj``, ``post_quant_proj`` and the
decoder's first Dense follow the latent and are checked when the state
dict is loaded.

Every rule is a transpose, a flip or the identity, so it is linear and
maps ``jax.grad``'s tree onto the gradients of the port's parameters as it
maps the parameters themselves (``cliffordar_from_jax`` serves both).

q and k weights need no permutation: the port keeps JAX's half-split RoPE
basis.  Every key of the input must be used, so a tree of another layout
(``fused_proj``, ``scan_layers``) is refused instead of half loaded.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from cliffordtpu_torch.nn.mlp_vae import LAYERS


def _same(a):
    return a


def _dense(a):
    return a.T


def _conv(a):
    return a.transpose(3, 2, 0, 1)


def _conv_t(a):
    return np.flip(a, (0, 1)).transpose(2, 3, 0, 1)


# (port name, jax name, transform) under a common prefix
Rule = Tuple[str, str, Callable]


def _gn(port: str, jax: str) -> List[Rule]:
    return [(f"{port}.weight", f"{jax}/scale", _same),
            (f"{port}.bias", f"{jax}/bias", _same)]


def transformer_block_rules() -> List[Rule]:
    return [
        ("norm1.weight", "RMSNorm_0/scale", _same),
        ("attn.wq.weight", "Attention_0/Dense_0/kernel", _dense),
        ("attn.wk.weight", "Attention_0/Dense_1/kernel", _dense),
        ("attn.wv.weight", "Attention_0/Dense_2/kernel", _dense),
        ("attn.wo.weight", "Attention_0/Dense_3/kernel", _dense),
        ("norm2.weight", "RMSNorm_1/scale", _same),
        ("ffn.w1.weight", "SwiGLU_0/Dense_0/kernel", _dense),
        ("ffn.w3.weight", "SwiGLU_0/Dense_1/kernel", _dense),
        ("ffn.w2.weight", "SwiGLU_0/Dense_2/kernel", _dense),
    ]


def res_down_block_rules() -> List[Rule]:
    return [*_gn("norm1", "GroupNorm_0"),
            ("conv1.weight", "Conv_0/kernel", _conv),
            *_gn("norm2", "GroupNorm_1"),
            ("conv2.weight", "Conv_1/kernel", _conv),
            ("shortcut.weight", "Conv_2/kernel", _conv)]


def res_up_block_rules() -> List[Rule]:
    return [*_gn("norm1", "GroupNorm_0"),
            ("conv1.weight", "ConvTranspose_0/kernel", _conv_t),
            *_gn("norm2", "GroupNorm_1"),
            ("conv2.weight", "Conv_0/kernel", _conv),
            ("shortcut.weight", "ConvTranspose_1/kernel", _conv_t),
            *_gn("norm3", "GroupNorm_2"),
            ("conv3.weight", "Conv_1/kernel", _conv),
            *_gn("norm4", "GroupNorm_3"),
            ("conv4.weight", "Conv_2/kernel", _conv)]


def _nest(rules: List[Rule], port: str, jax: str) -> List[Rule]:
    return [(f"{port}.{p}", f"{jax}/{j}", f) for p, j, f in rules]


def _count(flat, prefix: str) -> int:
    i = 0
    while any(k.startswith(f"{prefix}_{i}/") for k in flat):
        i += 1
    return i


def _blocks(flat, jax_prefix: str) -> List[Rule]:
    n = _count(flat, f"{jax_prefix}TransformerBlock")
    return [r for i in range(n) for r in _nest(
        transformer_block_rules(), f"layers.{i}",
        f"{jax_prefix}TransformerBlock_{i}")]


def vit_encoder_rules(flat, jax_prefix: str = "") -> List[Rule]:
    n_down = _count(flat, f"{jax_prefix}ResDownBlock")
    return [
        ("conv_in.weight", f"{jax_prefix}Conv_0/kernel", _conv),
        *[r for i in range(n_down) for r in _nest(
            res_down_block_rules(), f"down.{i}",
            f"{jax_prefix}ResDownBlock_{i}")],
        ("register_token", f"{jax_prefix}register_token", _same),
        *_blocks(flat, jax_prefix),
        ("norm.weight", f"{jax_prefix}RMSNorm_0/scale", _same),
        ("output.weight", f"{jax_prefix}Dense_0/kernel", _dense),
    ]


def vit_decoder_rules(flat, jax_prefix: str = "") -> List[Rule]:
    n_up = _count(flat, f"{jax_prefix}ResUpBlock")
    return [
        ("conv_in.weight", f"{jax_prefix}Conv_0/kernel", _conv),
        ("register_token", f"{jax_prefix}register_token", _same),
        *_blocks(flat, jax_prefix),
        *[r for i in range(n_up) for r in _nest(
            res_up_block_rules(), f"up.{i}", f"{jax_prefix}ResUpBlock_{i}")],
        *_gn("norm_out", f"{jax_prefix}GroupNorm_0"),
        ("conv_out.weight", f"{jax_prefix}Conv_1/kernel", _conv),
    ]


def cliffordar_rules(flat) -> List[Rule]:
    return [
        *[(f"encoder_vit.{p}", j, f)
          for p, j, f in vit_encoder_rules(flat, "encoder_vit/")],
        ("quant_proj.weight", "quant_proj/kernel", _dense),
        ("quant_proj.bias", "quant_proj/bias", _same),
        ("post_quant_proj.weight", "post_quant_proj/kernel", _dense),
        *[(f"decoder_vit.{p}", j, f)
          for p, j, f in vit_decoder_rules(flat, "decoder_vit/")],
        *_sigma_rules(flat),
    ]


def _bias(port: str, jax: str, transform: Callable) -> List[Rule]:
    return [(f"{port}.weight", f"{jax}/kernel", transform),
            (f"{port}.bias", f"{jax}/bias", _same)]


def _sigma_rules(flat) -> List[Rule]:
    return [(k, k, _same) for k in ("log_sigma_0", "log_sigma_1")
            if k in flat]


def res_block_rules(flat, jax_prefix: str, up: bool) -> List[Rule]:
    """``ResBlock`` (``up=False``) or ``ResUpBlock``: the strided
    (transposed) convolution, and the 1x1 skip convolution when the block
    changes the channel count."""
    rules = (_bias("conv", "ConvTranspose_0", _conv_t) if up
             else _bias("conv", "Conv_0", _conv))
    skip = "Conv_0" if up else "Conv_1"
    if f"{jax_prefix}/{skip}/kernel" in flat:
        rules += _bias("skip", skip, _conv)
    return rules


def cnnvae_rules(flat, distribution: str = "clifford") -> List[Rule]:
    second_head = "log_var" if distribution == "gaussian" else "kappa"
    n_down = _count(flat, "encoder/ResBlock")
    n_up = _count(flat, "decoder/ResUpBlock")
    return [
        *[r for i in range(n_down) for r in _nest(
            res_block_rules(flat, f"encoder/ResBlock_{i}", up=False),
            f"encoder.blocks.{i}", f"encoder/ResBlock_{i}")],
        *_bias("encoder.mu", "encoder/Dense_0", _dense),
        *_bias(f"encoder.{second_head}", "encoder/Dense_1", _dense),
        *_bias("decoder.fc", "decoder/Dense_0", _dense),
        *[r for i in range(n_up) for r in _nest(
            res_block_rules(flat, f"decoder/ResUpBlock_{i}", up=True),
            f"decoder.blocks.{i}", f"decoder/ResUpBlock_{i}")],
        *_bias("decoder.conv_out", "decoder/ConvTranspose_0", _conv_t),
        *_sigma_rules(flat),
    ]


def hybrid_up_block_rules() -> List[Rule]:
    """``HybridResUpBlock``: one GroupNorm + convolution residual after the
    shortcut, where ``res_up_block_rules`` has two."""
    return [*_gn("norm1", "GroupNorm_0"),
            ("conv1.weight", "ConvTranspose_0/kernel", _conv_t),
            *_gn("norm2", "GroupNorm_1"),
            ("conv2.weight", "Conv_0/kernel", _conv),
            ("shortcut.weight", "ConvTranspose_1/kernel", _conv_t),
            *_gn("norm3", "GroupNorm_2"),
            ("conv3.weight", "Conv_1/kernel", _conv)]


def hybridvae_rules(flat) -> List[Rule]:
    heads = [h for h in ("fc_mu", "fc_logvar", "fc_kappa")
             if f"encoder/{h}/kernel" in flat]
    return [
        ("encoder.input_conv.weight", "encoder/input_conv/kernel", _conv),
        *[r for i in range(_count(flat, "encoder/down")) for r in _nest(
            res_down_block_rules(), f"encoder.down.{i}", f"encoder/down_{i}")],
        *[r for h in heads for r in _bias(f"encoder.{h}", f"encoder/{h}",
                                          _conv)],
        ("decoder.input_proj.weight", "decoder/input_proj/kernel", _dense),
        *[r for i in range(_count(flat, "decoder/up")) for r in _nest(
            hybrid_up_block_rules(), f"decoder.up.{i}", f"decoder/up_{i}")],
        *_gn("decoder.norm_out", "decoder/GroupNorm_0"),
        *_bias("decoder.output_conv", "decoder/output_conv", _conv),
        *_sigma_rules(flat),
    ]


def convert(flat: Dict[str, np.ndarray], rules: List[Rule]
            ) -> Dict[str, torch.Tensor]:
    """Apply ``rules`` to ``flat``; every key of ``flat`` must be used."""
    unused = set(flat) - {j for _, j, _ in rules}
    if unused:
        raise ValueError(f"JAX params not carried by the port: "
                         f"{sorted(unused)[:8]}")
    return {p: torch.tensor(np.ascontiguousarray(
                f(np.asarray(flat[j], dtype=np.float32))))
            for p, j, f in rules}


def cliffordar_from_jax(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``CliffordARVAE`` params (flat ``params.npz`` keys) -> a state
    dict for ``cliffordtpu_torch.nn.vit_vae.CliffordARVAE``; a flat JAX
    gradient tree -> the gradients of the port's parameters, by name."""
    return convert(flat, cliffordar_rules(flat))


def cnnvae_from_jax(flat: Dict[str, np.ndarray],
                    distribution: str = "clifford"
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``CNNVAE`` params (flat ``params.npz`` keys) of a model with the
    ``distribution`` latent -> a state dict for
    ``cliffordtpu_torch.nn.conv_vae.CNNVAE``; a flat JAX gradient tree ->
    the gradients of the port's parameters, by name."""
    return convert(flat, cnnvae_rules(flat, distribution))


def hybridvae_from_jax(flat: Dict[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``HybridVAE`` params (flat ``params.npz`` keys) -> a state dict
    for ``cliffordtpu_torch.nn.hybrid_vae.HybridVAE``; a flat JAX gradient
    tree -> the gradients of the port's parameters, by name."""
    return convert(flat, hybridvae_rules(flat))


def mlpvae_from_jax(flat: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``MLPVAE`` params (flat keys ``"enc1/kernel"``, ...) -> a state
    dict for ``cliffordtpu_torch.nn.mlp_vae.MLPVAE``: every Dense kernel
    transposed for ``nn.Linear``; ``fc_var`` (normal) or ``fc_scale``
    (the others), whichever the tree holds."""
    return convert(flat, [r for name in LAYERS if f"{name}/kernel" in flat
                          for r in _bias(name, name, _dense)])


def from_jax(flat: Dict[str, np.ndarray], distribution: str = "clifford"
             ) -> Dict[str, torch.Tensor]:
    """``mlpvae_from_jax``, ``hybridvae_from_jax``, ``cnnvae_from_jax`` or
    ``cliffordar_from_jax``, by keys that only that family's tree holds:
    ``enc1/kernel`` (``MLPVAE``), ``encoder/input_conv/kernel``
    (``HybridVAE``), ``encoder/ResBlock_0/Conv_0/kernel`` (``CNNVAE``),
    ``encoder_vit/...`` (``CliffordARVAE``)."""
    if "enc1/kernel" in flat:
        return mlpvae_from_jax(flat)
    if "encoder/input_conv/kernel" in flat:
        return hybridvae_from_jax(flat)
    if "encoder/ResBlock_0/Conv_0/kernel" in flat:
        return cnnvae_from_jax(flat, distribution)
    if any(k.startswith("encoder_vit/") for k in flat):
        return cliffordar_from_jax(flat)
    raise ValueError(f"a JAX tree of no ported family: "
                     f"{sorted(flat)[:8]}")
