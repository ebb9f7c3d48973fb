"""The three inference entry points of a model (port of
``cliffordtpu/serving.py:125-153``), on the card by default.

``Serving`` holds one ``CliffordARVAE`` or ``HybridVAE`` (T tokens per
image, ``num_tokens``) or ``CNNVAE`` (T = 1), with any of their latents,
on one device and answers:

* ``encode_mu(x)``      images (B, H, W, C) -> means (B, T*d): the mean
                        angles of a clifford latent
* ``encode_z(key, x)``  images -> sampled latents (B, T*k): torus points,
                        k = 2d, for clifford; k = d otherwise
* ``decode(z)``         latents (B, T*k) -> images (B, H, W, C)

``CliffordARServing`` is the same class under its first name.

``load_params_npz`` reads a float32 ``params.npz`` in the JAX package's
flat format (``serving._flatten_params``); its bfloat16 and int8 storage
modes are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.nn.param_import import from_jax


def load_params_npz(path) -> Dict[str, np.ndarray]:
    """Flat ``"a/b/c"`` -> float32 array dict from a JAX ``params.npz``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    quantized = [k for k in flat if "::" in k]
    if quantized:
        raise NotImplementedError(
            f"quantized params.npz storage is not ported: {quantized[:4]}")
    return {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}


class Serving:
    """One model in eval mode on one device.

    ``device`` defaults to CUDA and raises when there is none; pass
    ``device="cpu"`` to run the plain versions of the kernels.  ``params``,
    when given, is a flat JAX param dict (``load_params_npz``) that replaces
    the model's own initialisation."""

    def __init__(self, model, params: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(from_jax(params, model.distribution))
        self.model = model.to(self.device).eval()

    def _input(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def encode_mu(self, x) -> torch.Tensor:
        mu, _ = self.model.encode_heads(self._input(x))
        return mu.reshape(mu.shape[0], -1)

    @torch.inference_mode()
    def encode_z(self, key, x,
                 sampler: Optional[str] = None) -> torch.Tensor:
        """Sampled latents.  ``key`` is the SAMPLING key: two uint32 words,
        used as ``CliffordPowerSphericalDistribution.sample`` uses its key.
        The JAX entry point takes the rng it passes to ``model.apply`` and
        derives this key inside with ``make_rng("sample")``; a caller
        holding only that rng gets the sampling key from JAX with
        ``model.apply(variables, rngs={"sample": rng},
        method=lambda m: m.make_rng("sample"))``.  ``sampler`` names the
        route of a clifford draw
        (``distributions/clifford_torus.py::SAMPLERS``) for this request;
        the default is the model's own.  The other latents have one route,
        and a ``sampler`` for them raises ``ValueError``."""
        return self.model.get_flat_latent(self._input(x), key, sampler)

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        return self.model.decode(self._input(z))


CliffordARServing = Serving
