"""Cross-cutting helpers (the port's own copy of what it needs from
``cliffordtpu/utils/__init__.py``): device name for logs, directories,
seeding, ``Timer``, the optional wandb logger, class names, the stable
hash of the runners' key folds, and the lazy pyplot of the plots."""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict

import numpy as np
import torch

from cliffordtpu_torch.device import resolve_device


def get_default_device(device=None) -> str:
    """The device an entry point runs on (``resolve_device``), named for
    logs: the card's name on CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def stable_hash(*parts) -> int:
    """Deterministic 32-bit digest (crc32) of the parts, stringified and
    joined by "-": a fold for keys that stays the same across processes,
    where Python's salted ``hash()`` would not."""
    return zlib.crc32("-".join(map(str, parts)).encode())


def set_global_seeds(seed: int):
    """Seed numpy (host shuffles, scikit-learn) and return the root key
    ``(0, seed)``, the words of ``jax.random.PRNGKey(seed)``.  Every draw
    of the port takes an explicit key, so there is no global torch
    generator to pin."""
    np.random.seed(seed)
    return (0, seed)


class Timer:
    """Wall-clock section timing dumped to *_timing.json."""

    def __init__(self):
        self.t0 = time.time()
        self.sections: Dict[str, float] = {}
        self._marks: Dict[str, float] = {}

    def start(self, name: str):
        self._marks[name] = time.time()

    def stop(self, name: str):
        if name in self._marks:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.time() - self._marks.pop(name))

    def total(self) -> float:
        return time.time() - self.t0

    def dump(self, path: str):
        out = dict(self.sections)
        out["total_seconds"] = self.total()
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        return out


class WandbLogger:
    """No-op-safe wandb wrapper: ``use`` is False with ``--no_wandb`` (and
    then wandb is never imported) or when wandb is not installed."""

    def __init__(self, args):
        self._wandb = None
        if not getattr(args, "no_wandb", True):
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                pass
        self.use = self._wandb is not None
        self.project = getattr(args, "wandb_project", None)
        self.run = None

    def start_run(self, name, args):
        if self.use:
            self.run = self._wandb.init(
                project=self.project, name=name, config=vars(args))

    def log_metrics(self, d):
        if self.use and self.run is not None:
            try:
                self.run.log(d)
            except Exception:
                pass

    def log_summary(self, d):
        if self.use and self.run is not None:
            try:
                self.run.summary.update(d)
            except Exception:
                pass

    def log_images(self, images):
        if self.use and self.run is not None:
            try:
                to_log = {}
                for k, v in images.items():
                    if isinstance(v, str) and os.path.exists(v):
                        to_log[k] = self._wandb.Image(v)
                    else:
                        to_log[k] = v
                self.run.log(to_log)
            except Exception:
                pass

    def finish_run(self):
        if self.use and self.run is not None:
            self.run.finish()


CLASS_NAMES = {
    "fashionmnist": [
        "T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
        "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot",
    ],
    "mnist": [str(i) for i in range(10)],
    "mnist32": [str(i) for i in range(10)],  # digit shard at CNN geometry
    "cifar10": [
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    ],
}


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a plot is
    drawn: the card has no matplotlib, so no module imports it at load."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
