"""Shared helpers of the standalone figure scripts (port of
``scripts/figures_common.py``): Schlegel-style heatmaps of HRR, unitary
and Clifford-torus vectors.

The vector inits and the d x k accuracy sweeps, each from the keys the
JAX helpers derive (``fold_in(PRNGKey(0), d)`` per dim, the trial keys
below it), drawn with the port's bit-exact ``random`` so the vectors are
JAX's.  The compute runs on ``device`` (default the card,
``resolve_device``); ``plot_heatmaps`` draws on the host with matplotlib,
imported when it is called.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval.binding import depth_curve
from cliffordtpu_torch.utils import pyplot
from cliffordtpu_torch.vsa.capacity import (
    test_binding_unbinding_pairs,
    test_bundle_capacity,
)
from cliffordtpu_torch.vsa.ops import (
    hrr_init,
    normalize_vectors,
    unitary_init,
)

DEFAULT_KEY = (0, 0)  # jax.random.PRNGKey(0)


def clifford_init(key, n: int, d: int, device=None) -> torch.Tensor:
    """Random torus vectors in R^{2d}: the reference's
    ``scripts/bundle_heatmap.py:16-29`` with its quirk of writing 1.0
    *radians* into the DC and Nyquist phase slots (the package's own
    ``angles_to_torus`` pins them to phase 0 instead), then the inverse
    complex FFT's real part."""
    angles = random.uniform(key, (n, d), device=device) * (2 * math.pi)
    freq_dim = 2 * d
    theta_s = torch.zeros((n, freq_dim), device=angles.device)
    theta_s[:, 0] = 1.0
    theta_s[:, 1:d] = angles[:, 1:]
    theta_s[:, -d + 1:] = -torch.flip(angles[:, 1:], (-1,))
    theta_s[:, freq_dim // 2] = 1.0  # freq_dim is even
    fv = torch.complex(torch.cos(theta_s), torch.sin(theta_s))
    return torch.fft.ifft(fv, dim=-1).real.float()


INIT_FNS = {
    "HRR": hrr_init,
    "Unitary": unitary_init,
    "Clifford": clifford_init,
}


def _capacity_heatmap(test_fn, init_fn, name, dims, k_range, n_items,
                      n_trials, key, device, **kw):
    key = DEFAULT_KEY if key is None else key
    device = resolve_device(device)
    acc = np.full((len(dims), len(k_range)), np.nan)
    for i, d in enumerate(dims):
        print(f"  {name} d={d}...")
        vk = random.fold_in_words(key, d)
        vectors = normalize_vectors(init_fn(vk, n_items, d, device=device))
        res = test_fn(
            d=vectors.shape[-1], n_items=n_items,
            k_range=[k for k in k_range if 2 * k <= n_items],
            n_trials=n_trials, item_memory=vectors, key=vk, **kw)
        for j, k in enumerate(k_range):
            if k in res["k"]:
                acc[i, j] = res["accuracy"][res["k"].index(k)]
    return acc


def run_bundle_heatmap(init_fn, name, dims, k_range, n_items=1000,
                       n_trials=20, key=None, device=None):
    """Bundle-capacity accuracy, (len(dims), len(k_range))."""
    return _capacity_heatmap(test_bundle_capacity, init_fn, name, dims,
                             k_range, n_items, n_trials, key, device)


def run_rolefiller_heatmap(init_fn, name, dims, k_range, n_items=1000,
                           n_trials=10, key=None, device=None):
    """Role-filler unbinding accuracy (roles from the item memory),
    (len(dims), len(k_range))."""
    return _capacity_heatmap(test_binding_unbinding_pairs, init_fn, name,
                             dims, k_range, n_items, n_trials, key, device,
                             bind_with_random=False)


def run_depth_heatmap(init_fn, name, dims, max_depth=40, n_trials=10,
                      key=None, device=None):
    """Mean cosine after binding depth m = 1 .. max_depth, per dim; returns
    (matrix (len(dims), max_depth), depths)."""
    key = DEFAULT_KEY if key is None else key
    device = resolve_device(device)
    depths = list(range(1, max_depth + 1))
    sim = np.full((len(dims), len(depths)), np.nan)
    for i, d in enumerate(dims):
        print(f"  {name} d={d}...")
        vk = random.fold_in_words(key, d)
        vecs = torch.stack([
            normalize_vectors(init_fn(random.fold_in_words(vk, t),
                                      max_depth + 1, d, device=device))
            for t in range(n_trials)
        ])
        sims = depth_curve(vecs[:, 0, :], vecs[:, 1:, :], "inv")
        sim[i] = sims.mean(0).cpu().numpy()
    return sim, depths


def plot_heatmaps(results, dims, x_vals, xlabel, title, cbar_label,
                  save_path):
    plt = pyplot()
    import matplotlib.colors as mcolors

    n = len(results)
    fig, axes = plt.subplots(1, n, figsize=(5 * n + 1, 4.5), sharey=True)
    if n == 1:
        axes = [axes]
    norm = mcolors.Normalize(vmin=0.0, vmax=1.0)
    for ax, (name, mat) in zip(axes, results.items()):
        masked = np.ma.masked_invalid(mat)
        ax.pcolormesh(np.arange(len(x_vals) + 1), np.arange(len(dims) + 1),
                      masked, cmap=plt.cm.jet, norm=norm, shading="flat")
        step = max(1, len(x_vals) // 12)
        ax.set_xticks(np.arange(0, len(x_vals), step) + 0.5)
        ax.set_xticklabels([x_vals[i] for i in range(0, len(x_vals), step)],
                           rotation=45, fontsize=7)
        ax.set_yticks(np.arange(len(dims)) + 0.5)
        ax.set_yticklabels(dims, fontsize=7)
        ax.set_xlabel(xlabel, fontsize=9)
        if ax is axes[0]:
            ax.set_ylabel("# dimensions", fontsize=9)
        ax.set_title(name, fontsize=11, fontweight="bold")
    fig.colorbar(plt.cm.ScalarMappable(norm=norm, cmap=plt.cm.jet),
                 ax=axes, shrink=0.8, label=cbar_label)
    fig.suptitle(title, fontsize=13, fontweight="bold")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close()
    print(f"saved to {save_path}")
    return save_path
