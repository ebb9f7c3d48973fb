"""Fréchet distance between prior decodes and the test set (port of
``cliffordtpu/eval/fid.py``).

The feature extractor is pluggable, as in the JAX package:

* ``"inception"`` loads the InceptionV3 npz that ``$CLIFFORDTPU_INCEPTION``
  names (the same file and variable as the JAX package; a true FID);
* ``"random_conv"`` is the fixed seed-42 random 4-layer conv net, its
  weights drawn as the JAX function draws them (``split`` and ``normal``
  of key 42), so the same images give the same features.  Its distances
  compare runs with one another; they are NOT on the Inception scale.
* ``"auto"`` takes ``"inception"`` when the variable is set, else
  ``"random_conv"``.  The returned ``fid_features`` names the extractor
  that ran; an unknown name or ``"inception"`` without a path raises.

Images, prior draws and features stay on the handle's device; the means,
covariances and the Fréchet distance are numpy float64 on the host, as in
the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval.adapters import to_numpy
from cliffordtpu_torch.eval.prior import sample_prior_z

RANDOM_CONV_KEY = (0, 42)  # jax.random.PRNGKey(42)


def _same_pads(size: int, k: int = 3, stride: int = 2):
    """(low, high) padding of ``padding="SAME"``: the total that keeps
    ceil(size / stride) outputs, the odd pixel at the high end (32 -> 16
    pads (0, 1), where a symmetric pad of 1 would shift every window)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _random_conv_features(images: torch.Tensor, key=RANDOM_CONV_KEY
                          ) -> torch.Tensor:
    """Fixed random conv features: 4x (conv3x3 stride 2 "SAME" +
    leaky_relu 0.2), then global mean and max pools concatenated -> 512.
    images: (B, H, W, 3) in [0, 1], NHWC as in JAX; the features keep
    JAX's channel order."""
    chans = [32, 64, 128, 256]
    x = (images * 2.0 - 1.0).permute(0, 3, 1, 2)
    k = key
    for ch in chans:
        k, sub = random.split_words(k)
        cin = x.shape[1]
        w = random.normal(sub, (3, 3, cin, ch), x.device) * (
            1.0 / np.sqrt(9 * cin))
        ph, pw = _same_pads(x.shape[2]), _same_pads(x.shape[3])
        x = F.conv2d(F.pad(x, (*pw, *ph)), w.permute(3, 2, 0, 1), stride=2)
        x = F.leaky_relu(x, 0.2)
    return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], -1)


def _sqrtm_psd(c: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition; finite on the
    rank-deficient covariances that small sample counts produce."""
    w, v = np.linalg.eigh((c + c.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0, None))) @ v.T


def _frechet(mu1, cov1, mu2, cov2) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^(1/2)) via symmetric eig."""
    diff = mu1 - mu2
    # sqrtm(C1 C2) trace == sum sqrt eig(C1^(1/2) C2 C1^(1/2))
    s1 = _sqrtm_psd(cov1)
    inner = s1 @ cov2 @ s1
    eigs = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sum(np.sqrt(np.clip(eigs, 0, None)))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


_INCEPTION_CACHE: dict = {}


def inception_net(device=None):
    """The InceptionV3 of ``$CLIFFORDTPU_INCEPTION`` on ``device`` (the
    card by default), loaded once per path and device; raises when the
    variable is unset."""
    from cliffordtpu_torch.eval.inception import (
        InceptionV3Features,
        load_inception_params,
    )

    path = os.environ.get("CLIFFORDTPU_INCEPTION")
    if not path:
        raise RuntimeError(
            "feature_extractor='inception' requires $CLIFFORDTPU_INCEPTION "
            "to point at an InceptionV3 state-dict npz (see "
            "cliffordtpu_torch/eval/inception.py)")
    device = resolve_device(device)
    if (path, device) not in _INCEPTION_CACHE:
        _INCEPTION_CACHE.clear()
        _INCEPTION_CACHE[path, device] = InceptionV3Features(
            load_inception_params(path), device)
    return _INCEPTION_CACHE[path, device]


def _get_features(images01, extractor: str, batch: int = 256, device=None
                  ) -> np.ndarray:
    """(N, H, W, 1|3) images in [0, 1] -> features (numpy), on ``device``
    (the card by default).  Unknown extractors and a missing inception
    path are hard errors, never a silent surrogate."""
    if extractor == "inception":
        from cliffordtpu_torch.eval.inception import inception_features

        return inception_features(images01, inception_net(device),
                                  batch=min(batch, 32))
    if extractor != "random_conv":
        raise ValueError(f"unknown feature extractor {extractor!r}")
    device = resolve_device(device)
    feats = []
    with torch.inference_mode():
        for s in range(0, len(images01), batch):
            x = torch.as_tensor(images01[s:s + batch], dtype=torch.float32,
                                device=device)
            if x.shape[-1] == 1:
                x = x.repeat(1, 1, 1, 3)
            feats.append(_random_conv_features(x).cpu().numpy())
    return np.concatenate(feats, 0)


def prior_decodes(handle, dist_name: str, latent_dim: int, n_samples: int,
                  batch_size: int, key, image_shape) -> np.ndarray:
    """``n_samples`` prior draws decoded to images in [0, 1] (numpy,
    (n, *image_shape)): batch s (at offset s) drawn with fold_in(key, s)
    on the handle's device, as ``compute_fid`` draws them."""
    l2n = getattr(handle.model, "l2_normalize", False)
    fakes, n_done = [], 0
    while n_done < n_samples:
        bs = min(batch_size, n_samples - n_done)
        z = sample_prior_z(random.fold_in_words(key, n_done), dist_name,
                           latent_dim, bs, l2_normalize=l2n,
                           num_tokens=handle.num_tokens,
                           device=handle.device)
        imgs = to_numpy(handle.to_image(handle.decode(z)))
        fakes.append(imgs.reshape(imgs.shape[0], *image_shape))
        n_done += bs
    return np.concatenate(fakes, 0)


def compute_fid(
    handle, x_test, dist_name: str, latent_dim: int,
    in_channels: int = 3, n_samples: int = 2048, batch_size: int = 256,
    key=None, feature_extractor: str = "auto",
) -> Dict:
    """FID(prior decodes, test set) with the JAX function's keys: prior
    batch s drawn with fold_in(key, s) (key (0, 0) by default).  See the
    module docstring on the features."""
    key = (0, 0) if key is None else key
    if feature_extractor == "auto":
        feature_extractor = (
            "inception" if os.environ.get("CLIFFORDTPU_INCEPTION")
            else "random_conv")
    real = np.clip(to_numpy(x_test[:n_samples]) * 0.5 + 0.5, 0, 1)
    fake = prior_decodes(handle, dist_name, latent_dim, n_samples,
                         batch_size, key, real.shape[1:])
    f_real = _get_features(real, feature_extractor, device=handle.device)
    f_fake = _get_features(fake, feature_extractor, device=handle.device)
    mu_r, cov_r = f_real.mean(0), np.cov(f_real, rowvar=False)
    mu_f, cov_f = f_fake.mean(0), np.cov(f_fake, rowvar=False)
    score = _frechet(mu_r, cov_r, mu_f, cov_f)
    return {"fid": score, "fid_features": feature_extractor}
