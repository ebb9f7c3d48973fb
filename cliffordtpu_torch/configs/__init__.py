"""Dataclass experiment configs (port of ``cliffordtpu/configs``), field
for field as the JAX package has them: their defaults are the runners'
argparse defaults (in ``cliffordtpu_torch/scripts``: ``MNISTConfig``
``mnist_clifpws.py``'s, ``VMFConfig`` ``mnist_vmf.py``'s,
``CNNSweepConfig`` ``fashion_train.py``'s; ``cifar10_train.py`` differs
in ``lr``, 3e-4, and its wandb project).

Per-distribution overrides live here as data.  Each config converts to
and from the runner argparse namespaces (``to_namespace``,
``from_namespace``), so the flags stay the single source of truth at the
CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class MNISTConfig:
    """``mnist/mnist_clifpws.py:708-749`` defaults."""

    d_dims: List[int] = dataclasses.field(
        default_factory=lambda: [2, 5, 10, 20, 40, 128, 256])
    h_dim: int = 128
    epochs: int = 500
    patience: int = 50
    warmup_epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    n_runs: int = 20
    no_wandb: bool = False
    wandb_project: str = "mnist-svae-experiments"
    outdir: str = "."
    seed: int = 0


@dataclasses.dataclass
class VMFConfig:
    """``mnist/mnist_vmf.py:502-521`` defaults."""

    d_dims: List[int] = dataclasses.field(
        default_factory=lambda: [2, 5, 10, 20, 40])
    h_dim: int = 128
    epochs: int = 1000
    patience: int = 50
    warmup_epochs: int = 100
    batch_size: int = 64
    lr: float = 3e-4
    n_runs: int = 1
    simple: bool = False
    no_wandb: bool = False
    wandb_project: str = "mnist-vmf"
    outdir: str = "."
    seed: int = 0


@dataclasses.dataclass
class CNNSweepConfig:
    """``cnn/fashion_train.py:1420-1513`` / ``cifar10_train.py:983-1031``."""

    epochs: int = 500
    warmup_epochs: int = 100
    batch_size: int = 256
    lr: float = 1e-3  # cifar10 default is 3e-4
    l2_norm: bool = True
    recon_loss: str = "l1"
    l1_weight: float = 1.0
    max_beta: float = 1.0
    min_beta: float = 0.1
    use_learnable_beta: bool = False
    patience: int = 50
    cycle_epochs: int = 250
    n_trials: int = 30
    exclude_class: int = -1
    latent_dims: List[int] = dataclasses.field(
        default_factory=lambda: [128, 256, 512, 1024, 2048, 4096])
    distributions: Optional[List[str]] = None
    start_trial: int = 1
    arch: str = "cnn"
    keep_ckpts: bool = False
    no_wandb: bool = False
    wandb_project: str = "clifford-experiments-CNN"
    outdir: str = "."
    seed: int = 0


# per-distribution lr overrides (data, not code)
DIST_LR_OVERRIDES = {"powerspherical": 1e-4}

# clifford kappa-floor schedule by latent dim (``cnn/models.py:157-166``)
CLIFFORD_KAPPA_FLOORS = [
    (256, 0.04),   # d < 256
    (512, 0.07),   # d <= 512
    (1024, 0.10),
    (2048, 0.13),
    (float("inf"), 0.16),
]


def to_namespace(cfg) -> argparse.Namespace:
    return argparse.Namespace(**dataclasses.asdict(cfg))


def from_namespace(cls, ns: argparse.Namespace):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(ns).items() if k in fields})
