"""Semi-supervised kNN on posterior means (port of
``cliffordtpu/eval/knn.py``).

Cosine for the spherical and torus families, euclidean otherwise.  The
"torch" backend is the counterpart of the JAX package's "jax" one: the
k largest similarities (``torch.topk``), a per-row count of the
neighbours' labels and its argmax, on the handle's device.  "sklearn"
is the reference's classifier; scikit-learn is imported only when it is
asked for.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.vsa.ops import normalize_vectors


def encode_dataset(handle, x, y, batch: int = 500, key=None):
    """(posterior means as numpy (N, D), labels): batch s from
    ``latent_mu`` with ``fold_in(key, s)``."""
    key = (0, 0) if key is None else key
    zs = [handle.latent_mu(x[s:s + batch], random.fold_in_words(key, s)
                           ).cpu().numpy() for s in range(0, len(x), batch)]
    return np.concatenate(zs, 0), np.asarray(y)


def knn_predict_torch(X_train, y_train, X_test, metric: str, k: int = 5,
                      n_classes: int = 10, device=None) -> np.ndarray:
    """The majority label of the k nearest training rows per test row."""
    Xtr = torch.as_tensor(X_train, device=device)
    Xte = torch.as_tensor(X_test, device=device)
    if metric == "cosine":
        sims = normalize_vectors(Xte) @ normalize_vectors(Xtr).T
    else:
        sims = -((Xte ** 2).sum(-1, keepdim=True) - 2 * Xte @ Xtr.T
                 + (Xtr ** 2).sum(-1)[None, :])
    idx = torch.topk(sims, k, dim=-1).indices
    votes = torch.as_tensor(y_train, device=device).long()[idx]
    counts = torch.zeros((votes.shape[0], n_classes), dtype=torch.int64,
                         device=device)
    counts.scatter_add_(1, votes, torch.ones_like(votes))
    return counts.argmax(-1).cpu().numpy()


def _macro_f1(y_pred, y_test) -> float:
    f1s = []
    for c in np.unique(y_test):
        tp = np.sum((y_pred == c) & (y_test == c))
        fp = np.sum((y_pred == c) & (y_test != c))
        fn = np.sum((y_pred != c) & (y_test == c))
        prec = tp / max(1, tp + fp)
        rec = tp / max(1, tp + fn)
        f1s.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))
    return float(np.mean(f1s))


def perform_knn_evaluation(handle, x_train, y_train, x_test, y_test,
                           n_samples_list: Sequence[int] = (100, 600, 1000),
                           backend: str = "sklearn",
                           rng: np.random.Generator | None = None,
                           key=None) -> Dict[str, float]:
    """knn_acc_<n> and knn_f1_<n> (macro) for a random subset of n
    training rows per n (``rng.choice`` without replacement), k = 5."""
    if backend not in ("sklearn", "torch"):
        raise ValueError(f"backend must be 'sklearn' or 'torch', got "
                         f"{backend!r}")
    rng = rng or np.random.default_rng()
    X_train_full, y_train_full = encode_dataset(handle, x_train, y_train,
                                                key=key)
    X_test, y_test = encode_dataset(handle, x_test, y_test, key=key)
    metric = ("cosine" if handle.distribution in
              ("powerspherical", "clifford") else "euclidean")
    results = {}
    for n_samples in n_samples_list:
        n_eff = min(n_samples, len(X_train_full))
        indices = rng.choice(len(X_train_full), n_eff, replace=False)
        Xs, ys = X_train_full[indices], y_train_full[indices]
        if backend == "sklearn":
            from sklearn.metrics import accuracy_score, f1_score
            from sklearn.neighbors import KNeighborsClassifier

            knn = KNeighborsClassifier(n_neighbors=5, metric=metric)
            knn.fit(Xs, ys)
            y_pred = knn.predict(X_test)
            acc = accuracy_score(y_test, y_pred)
            f1 = f1_score(y_test, y_pred, average="macro")
        else:
            y_pred = knn_predict_torch(Xs, ys, X_test, metric,
                                       device=handle.device)
            acc = float((y_pred == y_test).mean())
            f1 = _macro_f1(y_pred, y_test)
        results[f"knn_acc_{n_samples}"] = float(acc)
        results[f"knn_f1_{n_samples}"] = float(f1)
    return results
