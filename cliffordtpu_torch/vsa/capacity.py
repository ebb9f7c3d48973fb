"""VSA capacity experiments (port of ``cliffordtpu/vsa/capacity.py``):
bundle capacity, role-filler capacity and the per-class similarity
matrix.

Every key is derived as the JAX functions derive theirs (``split``,
``fold_in``, ``permutation``, ``randint``), so with the same key and the
same item memory the curves come out the same.  A k's trials run as one
batch on the item memory's device (a tensor's own; else ``device``, the
card by default).  The returned dicts have the JAX
schema; ``plot=True`` draws the JAX package's figures under its file
names (``bundle_capacity.png``, ``role_filler_capacity.png``,
``bundle_similarity_matrix*.png``) into ``save_dir``, matplotlib imported
only then.

The names start with ``test_`` as the JAX ones do; they are evaluations,
not tests, and carry ``__test__ = False`` so pytest does not collect
them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.utils import pyplot as _plt
from cliffordtpu_torch.utils import stable_hash
from cliffordtpu_torch.vsa.ops import (
    bind,
    bundle,
    hrr_init,
    normalize_vectors,
    similarity,
    unbind,
    unitary_init,
)


def _prep_memory(key, item_memory, n_items, d, normalize, device):
    if item_memory is None:
        item_memory = hrr_init(key, n_items, d, device)
    else:
        item_memory = torch.as_tensor(item_memory, device=device)[:n_items]
    return normalize_vectors(item_memory) if normalize else item_memory


def _perms(keys, n, count, device):
    """The first ``count`` entries of ``permutation(key, n)`` per key,
    stacked (T, count)."""
    return torch.stack([random.permutation(k, n, device)[:count]
                        for k in keys])


def _curve_point(results, k, accs):
    results["k"].append(k)
    results["accuracy"].append(float(accs.mean()))
    results["std"].append(float(accs.std(unbiased=False)))


def _device(item_memory, device):
    """``device`` if given, else the item memory's when it is a tensor,
    else the card (``resolve_device``)."""
    if device is None and isinstance(item_memory, torch.Tensor):
        return item_memory.device
    return resolve_device(device)


def test_bundle_capacity(
    d: int = 1024,
    n_items: int = 1000,
    k_range=None,
    n_trials: int = 20,
    normalize: bool = True,
    plot: bool = False,
    save_dir: Optional[str] = None,
    item_memory=None,
    use_braiding: bool = False,  # unused, as in the JAX function
    bind_with_random: bool = False,  # unused, as in the JAX function
    baseline_d: Optional[int] = None,
    key=None,
    device=None,
) -> Dict:
    """Bundle retrieval capacity: per trial, 2k items of a permutation,
    the first k bundled against the next k; the share of the first k
    closer to their own bundle."""
    device = _device(item_memory, device)
    key = (0, 0) if key is None else key
    k_mem, key = random.split_words(key)
    item_memory = _prep_memory(k_mem, item_memory, n_items, d, normalize,
                               device)
    n_avail = item_memory.shape[0]
    if k_range is None:
        k_range = list(range(2, min(51, n_avail // 2), 2))
    results = {"k": [], "accuracy": [], "std": []}
    for k in k_range:
        actual_k = min(2 * k, n_avail) // 2
        if actual_k < 1:
            accs = torch.zeros(n_trials)
        else:
            keys = random.split_words(random.fold_in_words(key, k), n_trials)
            idx = _perms(keys, n_avail, 2 * actual_k, device)
            X = item_memory[idx[:, :actual_k]]  # (T, k, d)
            Xp = item_memory[idx[:, actual_k:]]
            s1 = similarity(X, bundle(X.transpose(0, 1))[:, None])
            s2 = similarity(X, bundle(Xp.transpose(0, 1))[:, None])
            accs = (s1 > s2).float().mean(-1)
        _curve_point(results, k, accs)
    if plot:
        _plot_capacity_curve(
            results, k_range, d, n_items, normalize, baseline_d=baseline_d,
            save_dir=save_dir, kind="bundle",
            key=random.fold_in_words(key, 999), n_trials=min(n_trials, 10),
            device=device)
    return results


def _role_filler_trials(keys, item_memory, roles_pool, k, unbind_method,
                        bind_with_random, use_braiding, normalize):
    """The accuracies of the trials of ``keys``: bind k role-filler pairs,
    bundle, recover every filler by the largest cosine over the memory."""
    n_items, d = item_memory.shape
    device = item_memory.device
    sub = [random.split_words(kk, 3) for kk in keys]
    if bind_with_random:
        idx = _perms([s[0] for s in sub], n_items, k, device)
        fillers = item_memory[idx]
        ridx = _perms([s[1] for s in sub], roles_pool.shape[0], k, device)
        roles = roles_pool[ridx]
        if normalize:
            roles = normalize_vectors(roles)
        target_idx = idx
    else:
        idx = _perms([s[0] for s in sub], n_items, 2 * k, device)
        roles = item_memory[idx[:, :k]]
        fillers = item_memory[idx[:, k:]]
        target_idx = idx[:, k:]
    pairs = bind(roles, fillers)  # (T, k, d)
    if use_braiding:
        perms = torch.stack([_perms(random.split_words(s[2], k), d, d,
                                    device) for s in sub])  # (T, k, d)
        braided = torch.gather(pairs, -1, perms)
        bundled = bundle(braided.transpose(0, 1))  # (T, d)
        unb_in = torch.gather(bundled[:, None].expand(-1, k, -1), -1,
                              torch.argsort(perms, -1))
    else:
        unb_in = bundle(pairs.transpose(0, 1))[:, None].expand(-1, k, -1)
    rec_n = normalize_vectors(unbind(unb_in, roles, method=unbind_method))
    sims = rec_n @ normalize_vectors(item_memory).T  # (T, k, n_items)
    return (sims.argmax(-1) == target_idx).float().mean(-1)


def test_binding_unbinding_pairs(
    d: int = 1024,
    n_items: int = 1000,
    k_range=None,
    n_trials: int = 20,
    normalize: bool = True,
    plot: bool = False,
    unbind_method: str = "inv",
    save_dir: Optional[str] = None,
    item_memory=None,
    use_braiding: bool = False,
    bind_with_random: bool = True,
    baseline_d: Optional[int] = None,
    key=None,
    device=None,
) -> Dict:
    """Role-filler binding capacity: with ``bind_with_random`` the roles
    are unitary vectors from a pool and the fillers items; otherwise both
    are items."""
    device = _device(item_memory, device)
    key = (0, 0) if key is None else key
    k_mem, k_pool, key = random.split_words(key, 3)
    item_memory = _prep_memory(k_mem, item_memory, n_items, d, normalize,
                               device)
    n_avail, dd = item_memory.shape
    if k_range is None:
        k_range = list(range(2, min(31, n_avail // 4), 2))
    max_k = max(k_range) if k_range else 2
    roles_pool = (unitary_init(k_pool, max(2 * max_k, 64), dd, device=device)
                  if bind_with_random
                  else torch.zeros((1, dd), device=device))
    results = {"k": [], "accuracy": [], "std": []}
    for k in k_range:
        keys = random.split_words(random.fold_in_words(key, k), n_trials)
        accs = _role_filler_trials(keys, item_memory, roles_pool, k,
                                   unbind_method, bind_with_random,
                                   use_braiding, normalize)
        _curve_point(results, k, accs)
    if plot:
        _plot_capacity_curve(
            results, k_range, d, n_items, normalize, baseline_d=baseline_d,
            save_dir=save_dir, kind="role_filler",
            key=random.fold_in_words(key, 998), n_trials=min(n_trials, 10),
            unbind_method=unbind_method, bind_with_random=bind_with_random,
            device=device)
    return results


def _plot_capacity_curve(results, k_range, d, n_items, normalize, *,
                         baseline_d, save_dir, kind, key, n_trials,
                         unbind_method="inv", bind_with_random=True,
                         device=None):
    """The learned latents' curve beside HRR and random-unitary baselines
    recomputed at ``baseline_d`` (default d), each from its own key."""
    bd = baseline_d if baseline_d is not None else d
    baselines = {}
    for bname, init_fn in (("HRR", hrr_init), ("unitary", unitary_init)):
        bkey = random.fold_in_words(key, stable_hash(bname) % 1000)
        bvecs = init_fn(bkey, n_items, bd, device=device)
        kw = dict(d=bd, n_items=n_items, k_range=k_range, n_trials=n_trials,
                  normalize=normalize, item_memory=bvecs, plot=False,
                  key=random.fold_in_words(bkey, 1))
        baselines[bname] = (
            test_bundle_capacity(**kw) if kind == "bundle"
            else test_binding_unbinding_pairs(
                unbind_method=unbind_method,
                bind_with_random=bind_with_random, **kw))
    plt = _plt()
    plt.figure(figsize=(8, 5))
    marker = "o" if kind == "bundle" else "s"
    plt.errorbar(results["k"], results["accuracy"], yerr=results["std"],
                 marker=marker, capsize=3, label="Learned Latents",
                 color="tab:blue", linewidth=2)
    for bname, label, m, color in (("HRR", "HRR (Random)", "^", "tab:gray"),
                                   ("unitary", "Random Unitary", "v",
                                    "tab:green")):
        plt.errorbar(baselines[bname]["k"], baselines[bname]["accuracy"],
                     yerr=baselines[bname]["std"], marker=m, capsize=3,
                     label=label, color=color, linestyle="--", alpha=0.8)
    if kind == "bundle":
        plt.xlabel("Number of Bundled Vectors ($k$)")
        plt.ylabel("Retrieval Accuracy")
        plt.title(f"Bundle Capacity ($d={bd}$, $N={n_items}$)")
        fname = "bundle_capacity.png"
    else:
        bind_label = " (Random Keys)" if bind_with_random else ""
        plt.xlabel("Number of Bundled Role-Filler Pairs ($k$)")
        plt.ylabel("Unbinding Accuracy")
        plt.title(f"Role-Filler Query Capacity{bind_label} "
                  f"($d={bd}$, $N={n_items}$)")
        fname = "role_filler_capacity.png"
    plt.legend()
    plt.grid(True, alpha=0.3)
    plt.ylim(0, 1.05)
    plt.tight_layout()
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        plt.savefig(os.path.join(save_dir, fname), dpi=300)
    plt.close()
    return baselines


def test_per_class_bundle_capacity_k_items(
    d: int = 1024,
    n_items: int = 1000,
    n_classes: int = 10,
    items_per_class: int = 2,
    n_trials: int = 1,
    normalize: bool = True,
    plot: bool = False,
    save_dir: Optional[str] = None,
    item_memory=None,
    labels=None,
    item_images=None,
    use_braiding: bool = False,
    per_class_braid: bool = False,
    class_names=None,
    key=None,
    device=None,
) -> Dict:
    """The cosine similarity matrix of the first ``items_per_class`` items
    of each class (labels drawn with ``randint`` when none are given),
    after an optional braiding per item or per class."""
    device = _device(item_memory, device)
    key = (0, 0) if key is None else key
    k_mem, k_lbl, k_braid = random.split_words(key, 3)
    if item_memory is None:
        item_memory = hrr_init(k_mem, n_items, d, device)
        labels = random.randint(k_lbl, (n_items,), 0, n_classes)
    else:
        item_memory = torch.as_tensor(item_memory, device=device)[:n_items]
        if labels is None:
            labels = random.randint(k_lbl, (item_memory.shape[0],), 0,
                                    n_classes)
        else:
            labels = labels[:item_memory.shape[0]]
    if normalize:
        item_memory = normalize_vectors(item_memory)
    labels = np.asarray(torch.as_tensor(labels).cpu())
    dd = item_memory.shape[-1]
    if use_braiding:
        if per_class_braid:
            class_perm = {int(c): random.permutation(
                random.fold_in_words(k_braid, int(c)), dd, device)
                for c in np.unique(labels)}
            perms = torch.stack([class_perm[int(c)] for c in labels])
        else:
            perms = _perms(random.split_words(k_braid, item_memory.shape[0]),
                           dd, dd, device)
        item_memory = torch.gather(item_memory, -1, perms)
    unique_classes = np.unique(labels)
    n_classes = min(n_classes, len(unique_classes))
    sel_idx, sel_labels = [], []
    for c in unique_classes[:n_classes]:
        cls_idx = np.where(labels == c)[0]
        if len(cls_idx) >= items_per_class:
            sel_idx.extend(cls_idx[:items_per_class].tolist())
            sel_labels.extend([int(c)] * items_per_class)
    if not sel_idx:
        return {"avg_similarity_matrix": None}
    bn = normalize_vectors(item_memory[torch.as_tensor(sel_idx,
                                                       device=device)])
    sim_matrix = (bn @ bn.T).cpu().numpy()
    if plot and save_dir:
        _plot_similarity_matrix(
            save_dir, sim_matrix, unique_classes[:n_classes], sel_idx,
            items_per_class, item_images, use_braiding, per_class_braid,
            class_names)
    return {
        "avg_similarity_matrix": sim_matrix,
        "std_similarity_matrix": np.zeros_like(sim_matrix),
        "n_bundles": len(sel_idx),
        "n_classes": n_classes,
        "items_per_class": items_per_class,
    }


def _plot_similarity_matrix(save_dir, sim_matrix, classes, sel_idx,
                            items_per_class, item_images, use_braiding,
                            per_class_braid, class_names):
    """The similarity matrix beside the chosen items' images."""
    from matplotlib.gridspec import GridSpec

    plt = _plt()
    n_classes = len(classes)
    os.makedirs(save_dir, exist_ok=True)
    fig = plt.figure(figsize=(16, 8))
    gs = GridSpec(1, 2, width_ratios=[1, 0.5], wspace=0.3)
    ax_sim = fig.add_subplot(gs[0])
    im = ax_sim.imshow(sim_matrix, cmap="viridis", aspect="auto")
    braid_label = (" (Per-Class Braiding)" if per_class_braid
                   else " (Random Braiding)" if use_braiding else "")
    ax_sim.set_title(
        f"Bundle Similarity Matrix{braid_label}\n"
        f"({items_per_class} Item per Class, {n_classes} Classes)",
        fontsize=14, fontweight="bold")
    tick_labels = []
    for c in classes:
        name = (class_names[int(c)] if class_names and
                int(c) < len(class_names) else str(int(c)))
        if items_per_class == 1:
            tick_labels.append(name)
        else:
            tick_labels.extend(
                f"{name}.{j + 1}" for j in range(items_per_class))
    ax_sim.set_xticks(range(len(tick_labels)))
    ax_sim.set_yticks(range(len(tick_labels)))
    ax_sim.set_xticklabels(tick_labels, rotation=90)
    ax_sim.set_yticklabels(tick_labels)
    ax_sim.set_xlabel("Bundle Index", fontsize=12)
    ax_sim.set_ylabel("Bundle Index", fontsize=12)
    plt.colorbar(im, ax=ax_sim, label="cosine similarity")
    ax_images = fig.add_subplot(gs[1])
    ax_images.axis("off")
    if item_images is not None and len(sel_idx) > 0:
        imgs = np.asarray(torch.as_tensor(item_images).cpu())
        # NHWC expected; NCHW tolerated
        if imgs.ndim == 4 and imgs.shape[1] in (1, 3) and \
                imgs.shape[1] < imgs.shape[-1]:
            imgs = imgs.transpose(0, 2, 3, 1)
        ih, iw, ic = imgs.shape[1:]
        canvas = np.ones((n_classes * ih, items_per_class * iw, ic)) * 0.5
        for pos, img_idx in enumerate(sel_idx):
            r, c0 = divmod(pos, items_per_class)
            canvas[r * ih:(r + 1) * ih, c0 * iw:(c0 + 1) * iw] = np.clip(
                imgs[img_idx] * 0.5 + 0.5, 0, 1)
        if ic == 1:
            ax_images.imshow(canvas[..., 0], cmap="gray")
        else:
            ax_images.imshow(canvas)
        ax_images.set_title(
            f"Images ({n_classes} Classes $\\times$ "
            f"{items_per_class} Items)", fontsize=12, fontweight="bold")
    fname = ("bundle_similarity_matrix_per_class_braid.png"
             if per_class_braid else
             "bundle_similarity_matrix_braid.png" if use_braiding else
             "bundle_similarity_matrix.png")
    plt.savefig(os.path.join(save_dir, fname), dpi=300)
    plt.close()


# evaluations named test_* as the JAX ones are, not pytest tests
test_bundle_capacity.__test__ = False
test_binding_unbinding_pairs.__test__ = False
test_per_class_bundle_capacity_k_items.__test__ = False
