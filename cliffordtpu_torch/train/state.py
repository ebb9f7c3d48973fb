"""Train state construction: the optimizer chain of the reference (port of
``cliffordtpu/train/state.py::make_optimizer`` / ``create_train_state``).

The reference chains ``optax.clip_by_global_norm(clip_norm)`` with
``optax.adam(lr)`` or ``optax.adamw(lr)``.  ``ClippedOptimizer`` is that
chain around ``torch.optim.Adam`` / ``torch.optim.AdamW``, which compute
the same update:

* the clip has optax's form, g if ||g|| < clip_norm else
  g * (clip_norm / ||g||); ``torch.nn.utils.clip_grad_norm_`` divides by
  ||g|| + 1e-6, which is another number;
* AdamW's weight decay is 1e-4, optax's default (torch's is 1e-2), on every
  parameter, norms and biases included, as optax applies it without a mask;
  betas (0.9, 0.999), eps 1e-8.

With ``sigma_lr_scale`` the learnable-beta parameters (those whose name
holds ``log_sigma``) form a second parameter group that trains at
``lr * sigma_lr_scale``, as the reference's ``optax.multi_transform``
does; the clip's norm is taken over both groups.

Not ported yet: gradient accumulation (``accum_steps``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from cliffordtpu_torch.device import resolve_device

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares over all tensors) (``optax.global_norm``), as a
    scalar tensor on their device."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


class ClippedOptimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), inner)``: ``step``
    scales the gradients in place by the clip factor, steps ``inner`` and
    returns the global gradient norm from before the clip.  Nothing in it
    waits for the device."""

    def __init__(self, inner: torch.optim.Optimizer, clip_norm: float = 1.0):
        self.inner = inner
        self.clip_norm = clip_norm

    def _grads(self):
        return [p.grad for group in self.inner.param_groups
                for p in group["params"] if p.grad is not None]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = self._grads()
        norm = global_norm(grads)
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        torch._foreach_mul_(grads, factor)
        self.inner.step()
        return norm


def _is_sigma(name: str) -> bool:
    return "log_sigma" in name


def make_optimizer(params, optimizer: str = "adam", lr: float = 1e-3,
                   clip_norm: float = 1.0,
                   sigma_lr_scale: Optional[float] = None
                   ) -> ClippedOptimizer:
    """Adam or AdamW at ``lr`` behind a global-norm clip.  ``params`` is an
    iterable of parameters or, as ``sigma_lr_scale`` needs it, of (name,
    parameter) pairs (``model.named_parameters()``).  The parameters must
    already lie on the device they train on: on CUDA the update is
    PyTorch's fused multi-tensor kernel."""
    params = list(params)
    if sigma_lr_scale is None:
        groups = [{"params": [p[1] if isinstance(p, tuple) else p
                              for p in params]}]
    else:
        if not all(isinstance(p, tuple) for p in params):
            raise ValueError("sigma_lr_scale needs (name, parameter) pairs")
        groups = [
            {"params": [p for n, p in params if not _is_sigma(n)]},
            {"params": [p for n, p in params if _is_sigma(n)],
             "lr": lr * sigma_lr_scale}]
    fused = all(p.device.type == "cuda" for g in groups for p in g["params"])
    if optimizer == "adam":
        inner = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 fused=fused)
    elif optimizer == "adamw":
        inner = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=ADAMW_WEIGHT_DECAY,
                                  fused=fused)
    else:
        raise ValueError(optimizer)
    return ClippedOptimizer(inner, clip_norm)


@dataclass
class TrainState:
    """A model in train mode on its device, and its optimizer."""

    model: nn.Module
    optimizer: ClippedOptimizer
    device: torch.device


def create_train_state(model: nn.Module, optimizer: str = "adam",
                       lr: float = 1e-3, clip_norm: float = 1.0,
                       sigma_lr_scale: Optional[float] = None,
                       accum_steps: int = 1, device=None) -> TrainState:
    """Move ``model`` (initialised from its own seed, or holding carried
    weights) to ``device`` and build its optimizer.  ``device`` defaults to
    CUDA and raises when there is none; pass ``device="cpu"`` to train with
    the plain versions of the kernels."""
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation is not ported")
    device = resolve_device(device)
    model = model.to(device).train()
    tx = make_optimizer(model.named_parameters(), optimizer, lr, clip_norm,
                        sigma_lr_scale)
    return TrainState(model=model, optimizer=tx, device=device)
