"""Class-mean latent classifier (port of
``cliffordtpu/eval/class_means.py``).

Keeps the reference's divisor quirk: a class mean divides by min(count,
10), not count (``true_mean=True`` divides by the count); the cosine
classifier does not see the scale.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.vsa.ops import normalize_vectors


def compute_class_means(handle, x, y, max_per_class: int = 1000,
                        batch: int = 200, key=None,
                        true_mean: bool = False) -> Dict[int, torch.Tensor]:
    """label -> the sum of up to ``max_per_class`` posterior means of the
    class over min(count, 10) (unit vectors for powerspherical), each on
    the handle's device."""
    key = (0, 0) if key is None else key
    y = np.asarray(y)
    sums: Dict[int, np.ndarray] = {}
    counts: Dict[int, int] = {}
    for s in range(0, len(x), batch):
        mu = handle.latent_mu(x[s:s + batch], random.fold_in_words(key, s)
                              ).cpu().numpy()
        for i, label in enumerate(y[s:s + batch].tolist()):
            if label not in counts:
                counts[label] = 0
                sums[label] = np.zeros_like(mu[i])
            if counts[label] < max_per_class:
                sums[label] = sums[label] + mu[i]
                counts[label] += 1
    means = {}
    for label, total in sums.items():
        c = max(1, counts[label]) if true_mean else max(
            1, min(counts[label], 10))
        vec = torch.as_tensor(total / c, device=handle.device)
        if handle.distribution == "powerspherical":
            vec = normalize_vectors(vec)
        means[label] = vec
    return means


def evaluate_mean_vector_cosine(handle, x, y,
                                class_means: Dict[int, torch.Tensor],
                                batch: int = 200, key=None
                                ) -> Tuple[float, Dict[int, float]]:
    """Nearest class mean by cosine: (accuracy, per-class accuracy)."""
    key = (0, 1) if key is None else key
    labels_sorted = sorted(class_means)
    mean_matrix = normalize_vectors(
        torch.stack([class_means[k] for k in labels_sorted], 0))
    y = np.asarray(y)
    correct = total = 0
    per_class_correct = {k: 0 for k in labels_sorted}
    per_class_total = {k: 0 for k in labels_sorted}
    for s in range(0, len(x), batch):
        mu = handle.latent_mu(x[s:s + batch], random.fold_in_words(key, s))
        preds = (normalize_vectors(mu) @ mean_matrix.T).argmax(1).tolist()
        for yi, pi in zip(y[s:s + batch].tolist(), preds):
            per_class_total[yi] = per_class_total.get(yi, 0) + 1
            if yi == labels_sorted[pi]:
                per_class_correct[yi] = per_class_correct.get(yi, 0) + 1
                correct += 1
            total += 1
    per_class_acc = {
        k: per_class_correct.get(k, 0) / max(1, per_class_total.get(k, 0))
        for k in labels_sorted}
    return correct / max(1, total), per_class_acc
