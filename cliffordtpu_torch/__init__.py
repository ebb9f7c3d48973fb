"""PyTorch port of ``cliffordtpu`` for one NVIDIA H100.

The JAX package ``cliffordtpu`` stays the reference; this package mirrors
its module names (``ops/torus.py``, ``distributions/clifford_torus.py``,
``nn/vit_vae.py``, ``nn/conv_vae.py``, ``train/``, ``serving.py``) and keeps its public layouts: images
``(B, H, W, C)``, attention operands ``(B, S, H, hd)``, latents
``(B, T, d)``.  Every TPU (Pallas) kernel on a ported path has a
hand-written CUDA counterpart under ``csrc/``, built at first use by
``kernels/build.py`` and bound through a plain C ABI with ``ctypes``.

It never imports ``jax``, ``flax`` or ``cliffordtpu``.
"""

from cliffordtpu_torch.device import resolve_device

__all__ = ["resolve_device"]
