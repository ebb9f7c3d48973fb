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

``adam_fused`` / ``adamw_fused`` name the JAX package's flat-vector form
of the same chain (``fused_adam``); here they are the same optimizers, as
PyTorch's fused multi-tensor Adam(W) already updates every parameter in a
few launches on the card.

With ``sigma_lr_scale`` the learnable-beta parameters (those whose name
holds ``log_sigma``) form a second parameter group that trains at
``lr * sigma_lr_scale``, as the reference's ``optax.multi_transform``
does; the clip's norm is taken over both groups.

With ``accum_steps`` k > 1 the chain behaves as ``optax.MultiSteps``: the
gradients are averaged over k steps (a running mean), and the clip and
the update fire once per cycle, on the mean; the parameters and Adam's
step count do not move in between.

``LaneClippedOptimizer`` is the chain for T independent models held in
stacked parameters (a leading lane axis): Adam is elementwise, so one
update over the stacks is each lane's own, and the clip takes one norm
per lane, as ``jax.vmap`` of the chain does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn

from cliffordtpu_torch.device import resolve_device

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default
OPTIMIZERS = ("adam", "adamw", "adam_fused", "adamw_fused")


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares over all tensors) (``optax.global_norm``), as a
    scalar tensor on their device."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


def lane_norms(tensors) -> torch.Tensor:
    """``global_norm`` of each lane of tensors with a leading lane axis,
    lane by lane as one model's (T,)."""
    lanes = [t.unbind(0) for t in tensors]
    return torch.stack([global_norm(lane) for lane in zip(*lanes)])


class ClippedOptimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), inner)``, wrapped in
    ``optax.MultiSteps`` when ``accum_steps`` > 1: ``step`` scales the
    gradients in place by the clip factor, steps ``inner`` and returns the
    global norm of this step's gradients, from before the clip and the
    averaging.  Nothing in it waits for the device."""

    def __init__(self, inner: torch.optim.Optimizer, clip_norm: float = 1.0,
                 accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.inner = inner
        self.clip_norm = clip_norm
        self.accum_steps = accum_steps
        self.micro_step = 0  # steps into the current accumulation cycle
        self._acc: Optional[List[torch.Tensor]] = None

    def _params(self):
        return [p for group in self.inner.param_groups
                for p in group["params"] if p.grad is not None]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def _norm(self, grads) -> torch.Tensor:
        return global_norm(grads)

    def _scale(self, grads, factor: torch.Tensor):
        torch._foreach_mul_(grads, factor)

    def _clip_and_update(self, grads, norm):
        factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                             self.clip_norm / norm)
        self._scale(grads, factor)
        self.inner.step()

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = self._params()
        grads = [p.grad for p in params]
        norm = self._norm(grads)
        if self.accum_steps == 1:
            self._clip_and_update(grads, norm)
            return norm
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
        delta = torch._foreach_sub(grads, self._acc)
        torch._foreach_div_(delta, float(self.micro_step + 1))
        torch._foreach_add_(self._acc, delta)
        self.micro_step += 1
        if self.micro_step == self.accum_steps:
            torch._foreach_copy_(grads, self._acc)
            self._clip_and_update(grads, self._norm(grads))
            torch._foreach_zero_(self._acc)
            self.micro_step = 0
        return norm


class LaneClippedOptimizer(ClippedOptimizer):
    """The chain over parameters with a leading lane axis of T models:
    one clip norm and factor per lane; ``step`` returns the T norms."""

    def _norm(self, grads) -> torch.Tensor:
        return lane_norms(grads)

    def _scale(self, grads, factor: torch.Tensor):
        for g in grads:
            g.mul_(factor.reshape((-1,) + (1,) * (g.dim() - 1)))


def _is_sigma(name: str) -> bool:
    return "log_sigma" in name


def make_optimizer(params, optimizer: str = "adam", lr: float = 1e-3,
                   clip_norm: float = 1.0,
                   sigma_lr_scale: Optional[float] = None,
                   accum_steps: int = 1) -> ClippedOptimizer:
    """Adam or AdamW at ``lr`` behind a global-norm clip (``OPTIMIZERS``;
    the ``_fused`` names are the same optimizers).  ``params`` is an
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
    if optimizer not in OPTIMIZERS:
        raise ValueError(optimizer)
    if optimizer.startswith("adamw"):
        inner = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=ADAMW_WEIGHT_DECAY,
                                  fused=fused)
    else:
        inner = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 fused=fused)
    return ClippedOptimizer(inner, clip_norm, accum_steps)


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
    device = resolve_device(device)
    model = model.to(device).train()
    tx = make_optimizer(model.named_parameters(), optimizer, lr, clip_norm,
                        sigma_lr_scale, accum_steps)
    return TrainState(model=model, optimizer=tx, device=device)
