"""InceptionV3 (FID variant) feature extractor (port of
``cliffordtpu/eval/inception.py``).

The torchvision graph as pytorch-fid runs it, with its three quirks:

* every 3x3/s1/p1 average pool uses ``count_include_pad=False``,
* the **last** InceptionE block (``Mixed_7c``) uses a *max* pool branch,
* inputs are bilinear-resized to 299x299 and mapped to ``2x - 1``.

Weights come from the same ``.npz`` as the JAX package reads: the torch
``state_dict()`` names (``Mixed_5b.branch1x1.conv.weight``,
``....bn.running_var``, ...), so one file serves both packages.
BatchNorm (eval mode, eps 1e-3) folds into a per-channel scale and shift
at load time (``load_inception_params``, as in JAX); the module then
multiplies the scale into the convolution's weight and adds the shift as
its bias, so each of the 94 layers is one cuDNN convolution and a ReLU.

There is deliberately NO fallback: callers that cannot provide weights
use the ``random_conv`` surrogate in ``eval/fid.py`` and label it so.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cliffordtpu_torch.device import resolve_device

BN_EPS = 1e-3
FEATURE_DIM = 2048
INPUT_SIZE = 299


def _conv_defs() -> Dict[str, Tuple[int, int, int, int]]:
    """Ordered ``name -> (cin, cout, kh, kw)`` for every conv in the net."""
    defs: Dict[str, Tuple[int, int, int, int]] = {}

    def add(name, cin, cout, kh, kw):
        defs[name] = (cin, cout, kh, kw)

    # stem
    add("Conv2d_1a_3x3", 3, 32, 3, 3)
    add("Conv2d_2a_3x3", 32, 32, 3, 3)
    add("Conv2d_2b_3x3", 32, 64, 3, 3)
    add("Conv2d_3b_1x1", 64, 80, 1, 1)
    add("Conv2d_4a_3x3", 80, 192, 3, 3)

    def block_a(p, cin, pool):
        add(f"{p}.branch1x1", cin, 64, 1, 1)
        add(f"{p}.branch5x5_1", cin, 48, 1, 1)
        add(f"{p}.branch5x5_2", 48, 64, 5, 5)
        add(f"{p}.branch3x3dbl_1", cin, 64, 1, 1)
        add(f"{p}.branch3x3dbl_2", 64, 96, 3, 3)
        add(f"{p}.branch3x3dbl_3", 96, 96, 3, 3)
        add(f"{p}.branch_pool", cin, pool, 1, 1)

    def block_b(p, cin):
        add(f"{p}.branch3x3", cin, 384, 3, 3)
        add(f"{p}.branch3x3dbl_1", cin, 64, 1, 1)
        add(f"{p}.branch3x3dbl_2", 64, 96, 3, 3)
        add(f"{p}.branch3x3dbl_3", 96, 96, 3, 3)

    def block_c(p, cin, c7):
        add(f"{p}.branch1x1", cin, 192, 1, 1)
        add(f"{p}.branch7x7_1", cin, c7, 1, 1)
        add(f"{p}.branch7x7_2", c7, c7, 1, 7)
        add(f"{p}.branch7x7_3", c7, 192, 7, 1)
        add(f"{p}.branch7x7dbl_1", cin, c7, 1, 1)
        add(f"{p}.branch7x7dbl_2", c7, c7, 7, 1)
        add(f"{p}.branch7x7dbl_3", c7, c7, 1, 7)
        add(f"{p}.branch7x7dbl_4", c7, c7, 7, 1)
        add(f"{p}.branch7x7dbl_5", c7, 192, 1, 7)
        add(f"{p}.branch_pool", cin, 192, 1, 1)

    def block_d(p, cin):
        add(f"{p}.branch3x3_1", cin, 192, 1, 1)
        add(f"{p}.branch3x3_2", 192, 320, 3, 3)
        add(f"{p}.branch7x7x3_1", cin, 192, 1, 1)
        add(f"{p}.branch7x7x3_2", 192, 192, 1, 7)
        add(f"{p}.branch7x7x3_3", 192, 192, 7, 1)
        add(f"{p}.branch7x7x3_4", 192, 192, 3, 3)

    def block_e(p, cin):
        add(f"{p}.branch1x1", cin, 320, 1, 1)
        add(f"{p}.branch3x3_1", cin, 384, 1, 1)
        add(f"{p}.branch3x3_2a", 384, 384, 1, 3)
        add(f"{p}.branch3x3_2b", 384, 384, 3, 1)
        add(f"{p}.branch3x3dbl_1", cin, 448, 1, 1)
        add(f"{p}.branch3x3dbl_2", 448, 384, 3, 3)
        add(f"{p}.branch3x3dbl_3a", 384, 384, 1, 3)
        add(f"{p}.branch3x3dbl_3b", 384, 384, 3, 1)
        add(f"{p}.branch_pool", cin, 192, 1, 1)

    block_a("Mixed_5b", 192, 32)
    block_a("Mixed_5c", 256, 64)
    block_a("Mixed_5d", 288, 64)
    block_b("Mixed_6a", 288)
    for name, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160),
                     ("Mixed_6d", 160), ("Mixed_6e", 192)]:
        block_c(name, 768, c7)
    block_d("Mixed_7a", 768)
    block_e("Mixed_7b", 1280)
    block_e("Mixed_7c", 2048)
    return defs


CONV_DEFS = _conv_defs()


def param_spec() -> Dict[str, Tuple[int, ...]]:
    """torch-state_dict key -> shape for every array the npz must hold."""
    spec: Dict[str, Tuple[int, ...]] = {}
    for name, (cin, cout, kh, kw) in CONV_DEFS.items():
        spec[f"{name}.conv.weight"] = (cout, cin, kh, kw)
        for bn_arr in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{name}.bn.{bn_arr}"] = (cout,)
    return spec


def load_inception_params(path: str
                          ) -> Dict[str, Tuple[np.ndarray, ...]]:
    """Load and fold an npz of torch-named arrays: ``name -> (weight
    (cout, cin, kh, kw), scale (cout,), shift (cout,))``, float32 numpy.
    Errors loudly on any missing key or shape mismatch; this extractor
    never degrades to a surrogate."""
    try:
        raw = np.load(path)
    except Exception as e:
        raise RuntimeError(
            f"cannot load InceptionV3 weights npz at {path!r}: {e}"
        ) from e
    params: Dict[str, Tuple[np.ndarray, ...]] = {}
    for name, (cin, cout, kh, kw) in CONV_DEFS.items():
        try:
            w = raw[f"{name}.conv.weight"]
            gamma = raw[f"{name}.bn.weight"]
            beta = raw[f"{name}.bn.bias"]
            mean = raw[f"{name}.bn.running_mean"]
            var = raw[f"{name}.bn.running_var"]
        except KeyError as e:
            raise RuntimeError(
                f"InceptionV3 npz {path!r} is missing array {e} "
                f"(expected torch state_dict naming; see "
                f"cliffordtpu_torch.eval.inception.param_spec())"
            ) from e
        if w.shape != (cout, cin, kh, kw):
            raise RuntimeError(
                f"{name}.conv.weight has shape {w.shape}, "
                f"expected {(cout, cin, kh, kw)}")
        scale = gamma / np.sqrt(var + BN_EPS)
        shift = beta - mean * scale
        params[name] = (np.asarray(w, np.float32),
                        np.asarray(scale, np.float32),
                        np.asarray(shift, np.float32))
    return params


def _max_pool(x, stride=2, pad=0):
    return F.max_pool2d(x, 3, stride, pad)


def _avg_pool_excl_pad(x):
    """3x3/s1/p1 average pool dividing border windows by their valid taps
    (pytorch-fid's ``count_include_pad=False``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionV3Features(nn.Module):
    """(B, 3, 299, 299) images in [0, 1] -> (B, 2048) pool3 features, NCHW,
    from the folded parameters of ``load_inception_params``."""

    def __init__(self, params: Dict[str, Tuple[np.ndarray, ...]], device=None):
        super().__init__()
        device = resolve_device(device)
        self.weights = nn.ParameterDict()
        self.biases = nn.ParameterDict()
        for name in CONV_DEFS:
            w, scale, shift = params[name]
            key = name.replace(".", "__")
            self.weights[key] = nn.Parameter(
                torch.from_numpy(w * scale[:, None, None, None]).to(device),
                requires_grad=False)
            self.biases[key] = nn.Parameter(
                torch.from_numpy(shift).to(device), requires_grad=False)

    def _bconv(self, x, name, stride=1, pad=None):
        """Conv (no bias) + folded BN + ReLU; ``pad`` (ph, pw) defaults to
        'same' for odd kernels, explicit where torchvision deviates (VALID
        stems, stride-2 reductions)."""
        key = name.replace(".", "__")
        w = self.weights[key]
        if pad is None:
            pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
        return F.relu(F.conv2d(x, w, self.biases[key], stride, pad))

    def _block_a(self, x, p):
        b1 = self._bconv(x, f"{p}.branch1x1")
        b5 = self._bconv(self._bconv(x, f"{p}.branch5x5_1"),
                         f"{p}.branch5x5_2")
        b3 = self._bconv(x, f"{p}.branch3x3dbl_1")
        b3 = self._bconv(b3, f"{p}.branch3x3dbl_2")
        b3 = self._bconv(b3, f"{p}.branch3x3dbl_3")
        bp = self._bconv(_avg_pool_excl_pad(x), f"{p}.branch_pool")
        return torch.cat([b1, b5, b3, bp], 1)

    def _block_b(self, x, p):
        b3 = self._bconv(x, f"{p}.branch3x3", stride=2, pad=(0, 0))
        bd = self._bconv(x, f"{p}.branch3x3dbl_1")
        bd = self._bconv(bd, f"{p}.branch3x3dbl_2")
        bd = self._bconv(bd, f"{p}.branch3x3dbl_3", stride=2, pad=(0, 0))
        return torch.cat([b3, bd, _max_pool(x)], 1)

    def _block_c(self, x, p):
        b1 = self._bconv(x, f"{p}.branch1x1")
        b7 = self._bconv(x, f"{p}.branch7x7_1")
        b7 = self._bconv(b7, f"{p}.branch7x7_2")
        b7 = self._bconv(b7, f"{p}.branch7x7_3")
        bd = self._bconv(x, f"{p}.branch7x7dbl_1")
        for i in (2, 3, 4, 5):
            bd = self._bconv(bd, f"{p}.branch7x7dbl_{i}")
        bp = self._bconv(_avg_pool_excl_pad(x), f"{p}.branch_pool")
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, x, p):
        b3 = self._bconv(x, f"{p}.branch3x3_1")
        b3 = self._bconv(b3, f"{p}.branch3x3_2", stride=2, pad=(0, 0))
        b7 = self._bconv(x, f"{p}.branch7x7x3_1")
        b7 = self._bconv(b7, f"{p}.branch7x7x3_2")
        b7 = self._bconv(b7, f"{p}.branch7x7x3_3")
        b7 = self._bconv(b7, f"{p}.branch7x7x3_4", stride=2, pad=(0, 0))
        return torch.cat([b3, b7, _max_pool(x)], 1)

    def _block_e(self, x, p, pool: str):
        b1 = self._bconv(x, f"{p}.branch1x1")
        b3 = self._bconv(x, f"{p}.branch3x3_1")
        b3 = torch.cat([self._bconv(b3, f"{p}.branch3x3_2a"),
                        self._bconv(b3, f"{p}.branch3x3_2b")], 1)
        bd = self._bconv(x, f"{p}.branch3x3dbl_1")
        bd = self._bconv(bd, f"{p}.branch3x3dbl_2")
        bd = torch.cat([self._bconv(bd, f"{p}.branch3x3dbl_3a"),
                        self._bconv(bd, f"{p}.branch3x3dbl_3b")], 1)
        pooled = (_max_pool(x, stride=1, pad=1) if pool == "max"
                  else _avg_pool_excl_pad(x))
        bp = self._bconv(pooled, f"{p}.branch_pool")
        return torch.cat([b1, b3, bd, bp], 1)

    @torch.inference_mode()
    def forward(self, images01: torch.Tensor) -> torch.Tensor:
        x = images01 * 2.0 - 1.0
        x = self._bconv(x, "Conv2d_1a_3x3", stride=2, pad=(0, 0))
        x = self._bconv(x, "Conv2d_2a_3x3", pad=(0, 0))
        x = self._bconv(x, "Conv2d_2b_3x3")
        x = _max_pool(x)
        x = self._bconv(x, "Conv2d_3b_1x1")
        x = self._bconv(x, "Conv2d_4a_3x3", pad=(0, 0))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(x, name)
        x = self._block_b(x, "Mixed_6a")
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(x, name)
        x = self._block_d(x, "Mixed_7a")
        x = self._block_e(x, "Mixed_7b", pool="avg")
        x = self._block_e(x, "Mixed_7c", pool="max")
        return x.mean(dim=(2, 3))


def preprocess(images01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1|3) NHWC images in [0, 1] -> (B, 3, 299, 299) NCHW as the
    JAX function feeds its net (torchmetrics(normalize=True) ->
    pytorch-fid): one channel repeated to three, quantised to uint8
    levels (round half to even, as ``jnp.round``), bilinear half-pixel
    resize (``align_corners=False``; every image of the repo is smaller
    than 299, so this only upsamples, where it is ``jax.image.resize``)."""
    x = images01.float()
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
    return F.interpolate(x.permute(0, 3, 1, 2), size=(INPUT_SIZE, INPUT_SIZE),
                         mode="bilinear", align_corners=False)


def inception_features(images01, net: InceptionV3Features, batch: int = 32
                       ) -> np.ndarray:
    """(N, H, W, 1|3) images in [0, 1] (numpy or a tensor) -> (N, 2048)
    features as numpy, ``batch`` images at a time on the net's device."""
    device = next(net.parameters()).device
    feats = []
    for s in range(0, len(images01), batch):
        x = torch.as_tensor(images01[s:s + batch], dtype=torch.float32,
                            device=device)
        feats.append(net(preprocess(x)).cpu().numpy())
    return np.concatenate(feats, 0)
