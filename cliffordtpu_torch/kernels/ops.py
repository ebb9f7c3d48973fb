"""The kernels that serving runs, as operators that ``torch.export`` sees.

A CUDA kernel of the port is launched through ctypes from ``data_ptr()``s,
which a traced graph cannot hold.  Each operator here is a
``torch.library.custom_op``: the graph records a call to it, its fake
implementation gives the output's shape, and its body runs eagerly, on the
host, when the program runs.

* ``attention_fwd(q, k, v, cos, sin)``: kernel A (``csrc/attention_fwd.cu``)
  for CUDA tensors, in the form the shape takes (the whole-sequence one
  where it fits, else the key-tiled one), ``attention_plain`` for CPU
  tensors.  ``attention.fused_attention`` calls it on both devices once its
  shape route has chosen the kernels; under autograd ``_FusedAttention``
  calls it in its whole-sequence forward and keeps its own backward (kernel
  B); the tiled form under autograd launches A itself, to keep the
  log-sum-exp for B.
* ``draw_latent(rng, mu, param2, ...)``: the latent draw of serving's
  ``encode_z`` (``distributions/reparam.py::draw_flat``) on the sampling
  key ``random.sample_key(rng)``, which flax's ``make_rng("sample")``
  derives from the rng of ``model.apply``.  An rng of four words carries
  the row range (row0, n_rows) after the key: the request's rows are rows
  row0.. of a global batch of n_rows (a replica of a data-parallel
  bundle), and the draw is those rows of the global draw.  The words are
  a tensor, not constants, so one exported program serves every replica.
  The key words are read on the
  host, and the powerspherical and vMF draws loop with host checks, as in
  the eager path; a clifford draw launches F, E or C on the card by its
  route, the plain versions on the CPU.  It has no autograd: training
  calls the models' ``reparam``.

The launch counts (``kernels.launch_counts``) count inside the bodies, so
a loaded program's launches count as the eager path's do.  Nothing falls
back: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cliffordtpu_torch.kernels import attention

__all__ = ["attention_fwd", "draw_latent", "NAMESPACE"]

NAMESPACE = "cliffordtpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::attention_fwd", mutates_args=())
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cos: Optional[torch.Tensor],
                  sin: Optional[torch.Tensor]) -> torch.Tensor:
    """The attention forward of a shape that ``attention.kernel_fits``
    holds: kernel A on CUDA (either form), its plain version on the
    CPU."""
    if q.device.type == "cpu":
        return attention.attention_plain(q, k, v, cos, sin)
    return attention._launch_fwd(q, k, v, cos, sin)


@attention_fwd.register_fake
def _(q, k, v, cos, sin):
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{NAMESPACE}::draw_latent", mutates_args=())
def draw_latent(rng: torch.Tensor, mu: torch.Tensor, param2: torch.Tensor,
                distribution: str, latent_dim: int, l2_normalize: bool,
                sampler: Optional[str], scale: float) -> torch.Tensor:
    """The flat latent (B, T*k) drawn from the encoder heads with the
    sampling key of ``rng`` (two uint32 words in an integer tensor, or
    four: the key, then row0 and n_rows)."""
    from cliffordtpu_torch import random
    from cliffordtpu_torch.distributions.reparam import draw_flat

    words = [int(w) for w in rng.reshape(-1).tolist()]
    key = random.sample_key(words[:2])
    rows = (words[2], words[3]) if len(words) == 4 else None
    return draw_flat(key, mu, param2, distribution, latent_dim,
                     l2_normalize, sampler, scale, rows)


@draw_latent.register_fake
def _(rng, mu, param2, distribution, latent_dim, l2_normalize, sampler,
      scale):
    width = math.prod(mu.shape[1:]) * (2 if distribution == "clifford"
                                       else 1)
    return mu.new_empty((mu.shape[0], width))
