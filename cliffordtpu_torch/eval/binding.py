"""Binding-depth and bind / bundle decode experiments (port of
``cliffordtpu/eval/binding.py``): the numbers of each from the keys the
JAX functions derive and, with an ``output_dir``, their plots under the
JAX package's file names (matplotlib is imported only then; without one
the plot paths come back None).

The depth curve binds a target to partners p_1 .. p_M and, for every
depth m, unbinds p_m .. p_1 again; the JAX package runs a masked loop of
M unbinds per depth, the port one batched unbind per step over the
depths still unbinding, which gives the same vectors.

The names start with ``test_`` as the JAX ones do; they are evaluations,
not tests, and carry ``__test__ = False``.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.eval.plots import _tile
from cliffordtpu_torch.utils import pyplot as _plt
from cliffordtpu_torch.utils import stable_hash
from cliffordtpu_torch.vsa.ops import (
    bind,
    hrr_init,
    normalize_vectors,
    similarity,
    unbind,
    unitary_init,
)


def depth_curve(targets: torch.Tensor, partners: torch.Tensor,
                unbind_method: str) -> torch.Tensor:
    """cos(unbind^m(bind^m(target, p_1..p_m)), target) for m = 1 .. M:
    targets (T, d), partners (T, M, d) -> (T, M)."""
    M = partners.shape[1]
    bounds, bound = [], targets
    for m in range(M):
        bound = bind(bound, partners[:, m])
        bounds.append(bound)
    rec = torch.stack(bounds, 1)  # depth j + 1 at index j
    for i in range(M):
        # step i unbinds partner j - i at every depth j >= i
        rec[:, i:] = unbind(rec[:, i:], partners[:, :M - i],
                            method=unbind_method)
    return similarity(rec, targets[:, None])


def _class_name(class_names, c) -> str:
    return (class_names[c] if class_names and c < len(class_names)
            else str(c))


def _baseline_curves(k_base, max_depth, d, n_trials, unbind_method, device):
    """The HRR and random-unitary partners' depth curves at the encoder dim
    d, each trial's M + 1 unit vectors from its own key: {name: (T, M)}."""
    curves = {}
    for bname, init_fn in (("HRR (Random)", hrr_init),
                           ("Random Unitary", unitary_init)):
        bkeys = random.split_words(
            random.fold_in_words(k_base, stable_hash(bname) % 97), n_trials)
        bvecs = torch.stack([normalize_vectors(
            init_fn(kk, max_depth + 1, d, device=device)) for kk in bkeys])
        curves[bname] = depth_curve(bvecs[:, 0], bvecs[:, 1:], unbind_method)
    return curves


def _plot_depth_curves(path, depths, self_sims, rand_sims, baselines, d):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    for sims, label, marker, color in (
            (self_sims, "Self-Binding", "o-", "tab:blue"),
            (rand_sims, "Random Latent Partners", "s-", "tab:orange")):
        means, stds = sims.mean(0), sims.std(0)
        ax.plot(depths, means, marker, markersize=5, label=label,
                color=color, linewidth=2)
        ax.fill_between(depths, means - stds, means + stds, alpha=0.15,
                        color=color)
    for (bname, sims), color, marker in zip(
            baselines.items(), ("tab:gray", "tab:green"), ("^", "v")):
        means, stds = sims.mean(0), sims.std(0)
        ax.plot(depths, means, marker=marker, markersize=5, label=bname,
                color=color, linestyle="--", alpha=0.8)
        ax.fill_between(depths, means - stds, means + stds, alpha=0.08,
                        color=color)
    ax.set_ylim(-0.1, 1.05)
    ax.set_xlabel("Binding Depth $m$")
    ax.set_ylabel("Cosine Similarity to Original")
    ax.set_title(f"Approximate Inverse Binding Depth ($d={d}$)")
    ax.legend()
    ax.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def recovery_canvas(handle, all_z, labels, max_depth, k_rec, unbind_method,
                    img_shape):
    """The decoded recovery grid: for the first example of up to three
    classes, the target and its recovery after m bind-unbind cycles with
    random latent partners (never itself), m every max_depth // 5.
    Returns (canvas, recovery depths, classes), or None without classes."""
    n = all_z.shape[0]
    depths = range(1, max_depth + 1)
    recon_every = max(1, max_depth // 5)
    recon_depths = [m for m in depths
                    if m % recon_every == 0 or m == max_depth]
    uniq = np.unique(labels)[:3]
    rows = []
    for r, u in enumerate(uniq):
        ex = int(np.where(labels == u)[0][0])
        target = all_z[ex]
        pp = random.permutation(random.fold_in_words(k_rec, r), n,
                                all_z.device)[:max_depth]
        parts = all_z[torch.where(pp == ex, (pp + 1) % n, pp)]
        row = [target]
        for m in recon_depths:
            rec = target
            for i in range(m):
                rec = bind(rec, parts[i])
            for i in range(m - 1, -1, -1):
                rec = unbind(rec, parts[i], method=unbind_method)
            row.append(rec)
        rows.append(torch.stack(row))
    if not rows:
        return None
    imgs = handle.decode_images(torch.cat(rows), img_shape)
    return _tile(imgs, len(rows), len(recon_depths) + 1), recon_depths, uniq


def _plot_recovery(path, canvas, recon_depths, uniq, img_shape):
    plt = _plt()
    ih, iw = img_shape[:2]
    n_rows, n_cols = canvas.shape[0] // ih, canvas.shape[1] // iw
    fig, ax = plt.subplots(figsize=(max(12, n_cols * 1.5),
                                    max(4, n_rows * 2)))
    if canvas.shape[-1] == 1:
        ax.imshow(canvas[..., 0], cmap="gray")
    else:
        ax.imshow(canvas)
    ax.set_xticks([iw * i + iw // 2 for i in range(n_cols)])
    ax.set_xticklabels(["original"] + [f"m={m}" for m in recon_depths],
                       fontsize=8)
    ax.set_yticks([ih * i + ih // 2 for i in range(n_rows)])
    ax.set_yticklabels([f"class {int(u)}" for u in uniq], fontsize=9)
    ax.set_title("Decoded Recovery After $m$ Sequential Bind-Unbind Cycles")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def test_self_binding(handle, x, y, output_dir: Optional[str] = None,
                      k_self_bind: int = 40, unbind_method: str = "*",
                      img_shape=(28, 28, 1), n_trials: int = 10,
                      key=None) -> Dict:
    """The binding-depth test on up to 200 sampled latents: n_trials
    targets bound to themselves (``self_k_sims``) and to random other
    latents (``k_sims``), depths 1 .. min(k_self_bind, n - 1);
    ``binding_k_self_similarity`` is the random-partner curve's last
    point.  With ``output_dir``: the curves beside HRR and random-unitary
    baselines at the encoder dim, and the decoded recovery grid."""
    key = (0, 0) if key is None else key
    k_enc, k_sel, k_base, k_rec = random.split_words(key, 4)
    all_z, all_labels = handle.collect_flat_z(x, y, k_enc, limit=200)
    if handle.distribution == "gaussian":
        all_z = normalize_vectors(all_z)
    n, dflat = all_z.shape
    max_depth = min(k_self_bind, n - 1)
    depths = list(range(1, max_depth + 1))
    dev = all_z.device
    targets = all_z[random.randint(k_sel, (n_trials,), 0, n, device=dev)]
    self_sims = depth_curve(
        targets, targets[:, None].expand(-1, max_depth, -1), unbind_method)
    pkeys = random.split_words(random.fold_in_words(k_sel, 1), n_trials)
    pidx = torch.stack([random.permutation(k, n, dev)[:max_depth]
                        for k in pkeys])
    rand_sims = depth_curve(targets, all_z[pidx], unbind_method)
    rand_means = rand_sims.mean(0)
    curve_path = recon_path = None
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        d = handle.latent_dim or dflat
        curve_path = os.path.join(
            output_dir, f"similarity_after_k_binds_{unbind_method}.png")
        baselines = _baseline_curves(k_base, max_depth, d, n_trials,
                                     unbind_method, dev)
        _plot_depth_curves(curve_path, depths, self_sims.cpu().numpy(),
                           rand_sims.cpu().numpy(),
                           {k: v.cpu().numpy() for k, v in baselines.items()},
                           d)
        try:
            grid = recovery_canvas(handle, all_z, all_labels, max_depth,
                                   k_rec, unbind_method, img_shape)
            if grid is not None:
                recon_path = os.path.join(
                    output_dir, f"recon_after_k_binds_{unbind_method}.png")
                _plot_recovery(recon_path, *grid, img_shape)
        except Exception:  # the grid degrades as the JAX function's does
            traceback.print_exc()
            recon_path = None
    return {
        "binding_k_self_similarity": (float(rand_means[-1])
                                      if len(rand_means) else 0.0),
        "similarity_after_k_binds_plot_path": curve_path,
        "recon_after_k_binds_plot_path": recon_path,
        "k_sims": rand_means.tolist(),
        "self_k_sims": self_sims.mean(0).tolist(),
        "k_values": depths,
    }


def _plot_vsa_operations(path, sims):
    plt = _plt()
    plt.figure(figsize=(10, 4))
    plt.subplot(1, 2, 1)
    plt.hist(sims, bins=20, alpha=0.8, edgecolor="black")
    plt.axvline(sims.mean(), color="red", linestyle="--",
                label=f"Mean: {sims.mean():.3f}")
    plt.xlabel("Cosine Similarity")
    plt.ylabel("Count")
    plt.title("Binding and Unbinding Performance")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.subplot(1, 2, 2)
    plt.plot(sims, "o-", alpha=0.8, markersize=5)
    plt.axhline(sims.mean(), color="red", linestyle="--", alpha=0.8)
    plt.xlabel("Test Index")
    plt.ylabel("Cosine Similarity")
    plt.title("Per-Test Cosine Similarity")
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def test_vsa_operations(handle, x, y, output_dir: Optional[str] = None,
                        n_test_pairs: int = 50, unbind_method: str = "*",
                        normalize: bool = True, key=None) -> Dict:
    """The mean cosine of unbind(bind(k, v), k) to v over posterior means:
    values the first m, keys drawn with ``randint``; with ``output_dir``
    their histogram."""
    key = (0, 0) if key is None else key
    k_enc, k_pick = random.split_words(key)
    z_all = handle.latent_mu(x[:n_test_pairs * 2], k_enc)
    if handle.distribution == "powerspherical" or normalize:
        z_all = normalize_vectors(z_all)
    n = z_all.shape[0]
    m = min(n_test_pairs, n // 2)
    keys_v = z_all[random.randint(k_pick, (m,), 0, n, device=z_all.device)]
    values = z_all[:m]
    sims = similarity(unbind(bind(keys_v, values), keys_v,
                             method=unbind_method), values).cpu().numpy()
    path = None
    if output_dir is not None and len(sims):
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"vsa_bind_unbind_{unbind_method}.png")
        _plot_vsa_operations(path, sims)
    return {"vsa_bind_unbind_similarity": (float(sims.mean()) if len(sims)
                                           else 0.0),
            "vsa_bind_unbind_plot": path}


def _plot_pairwise(path, canvas, pairs, img_shape, class_names):
    plt = _plt()
    ih, iw = img_shape[:2]
    n_rows, n_cols = len(pairs), 6
    fig, ax = plt.subplots(figsize=(n_cols * 1.6, max(6, n_rows * 1.1)))
    if canvas.shape[-1] == 1:
        ax.imshow(canvas[..., 0], cmap="gray")
    else:
        ax.imshow(canvas)
    ax.set_xticks([iw * i + iw // 2 for i in range(n_cols)])
    ax.set_xticklabels(["a", "b", "a (*) b", "bundle", "rec a", "rec b"],
                       fontsize=8)
    ax.set_yticks([ih * i + ih // 2 for i in range(n_rows)])
    ax.set_yticklabels([f"{_class_name(class_names, a)}-"
                        f"{_class_name(class_names, b)}" for a, b in pairs],
                       fontsize=7)
    ax.set_title("Pairwise Bind / Bundle / Unbind Decodes")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def test_pairwise_bind_bundle_decode(handle, x, y,
                                     output_dir: Optional[str] = None,
                                     img_shape=(32, 32, 1),
                                     unbind_method: str = "*",
                                     class_names=None, key=None) -> Dict:
    """For every pair of the first ten classes' first sampled latents:
    the mean cosine of each one recovered from their binding; with
    ``output_dir`` the decoded grid of a, b, their binding, their bundle
    (a + b) / sqrt(2) and both recoveries, one row per pair."""
    key = (0, 0) if key is None else key
    z_all, labels = handle.collect_flat_z(x, y, key, limit=400)
    reps = {}
    for c in np.unique(labels)[:10]:
        idx = np.where(labels == c)[0]
        if len(idx):
            reps[int(c)] = int(idx[0])
    classes = sorted(reps)
    pairs = [(a, b) for i, a in enumerate(classes) for b in classes[i + 1:]]
    if not pairs:
        return {"avg_unbind_similarity": 0.0, "plot_path": None}
    za = z_all[[reps[a] for a, _ in pairs]]
    zb = z_all[[reps[b] for _, b in pairs]]
    bound = bind(za, zb)
    rec_a = unbind(bound, zb, method=unbind_method)
    rec_b = unbind(bound, za, method=unbind_method)
    sims = 0.5 * (similarity(rec_a, za) + similarity(rec_b, zb))
    path = None
    if output_dir is not None:
        bundled = (za + zb) / np.sqrt(2.0)
        imgs = handle.decode_images(torch.stack(
            [za, zb, bound, bundled, rec_a, rec_b], 1).flatten(0, 1),
            img_shape)
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir,
                            f"pairwise_bind_bundle_{unbind_method}.png")
        _plot_pairwise(path, _tile(imgs, len(pairs), 6), pairs, img_shape,
                       class_names)
    return {"avg_unbind_similarity": float(sims.mean()), "plot_path": path}


def _plot_cross_class(path, imgs, titles, distribution):
    plt = _plt()
    fig, axes = plt.subplots(2, 4, figsize=(12, 6))
    for k in range(8):
        ax = axes[k // 4][k % 4]
        if imgs.shape[-1] == 1:
            ax.imshow(imgs[k][..., 0], cmap="gray")
        else:
            ax.imshow(np.clip(imgs[k], 0, 1))
        ax.set_title(titles[k], fontsize=9)
        ax.axis("off")
    fig.suptitle(f"Cross-Class Bind/Unbind ({distribution})",
                 fontsize=12, fontweight="bold")
    plt.tight_layout()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def test_cross_class_bind_unbind(handle, x, y,
                                 output_dir: Optional[str] = None,
                                 class_a: int = 6, class_b: int = 9,
                                 img_shape=(28, 28, 1), class_names=None,
                                 key=None) -> Dict:
    """The first sampled latents of two classes (unit vectors for a
    gaussian latent), bound and recovered by each unbinding ("*" and
    "†"); with ``output_dir`` the 2 x 4 grid of A, B, decode(bind),
    decode(bundle) over the four recoveries."""
    key = (0, 0) if key is None else key
    z_all, labels = handle.collect_flat_z(x, y, key, limit=400)
    ia = np.where(labels == class_a)[0]
    ib = np.where(labels == class_b)[0]
    if not len(ia) or not len(ib):
        return {"plot_path": None,
                "cross_class_bind_unbind_similarity": 0.0,
                "cross_class_bind_unbind_plot_path": None}
    za, zb = z_all[int(ia[0])], z_all[int(ib[0])]
    if handle.distribution == "gaussian":
        za = za / torch.clamp(torch.linalg.vector_norm(za), min=1e-12)
        zb = zb / torch.clamp(torch.linalg.vector_norm(zb), min=1e-12)
    bound = bind(za, zb)
    sims, recs = {}, []
    for method in ("*", "†"):
        rec_a = unbind(bound, zb, method=method)
        rec_b = unbind(bound, za, method=method)
        sims[f"sim_a_{method}"] = float(similarity(rec_a, za))
        sims[f"sim_b_{method}"] = float(similarity(rec_b, zb))
        recs += [rec_a, rec_b]
    sim_star = 0.5 * (sims["sim_a_*"] + sims["sim_b_*"])
    sim_dag = 0.5 * (sims["sim_a_†"] + sims["sim_b_†"])
    path = None
    if output_dir is not None:
        # a, b, bind, bundle, rec_a *, rec_b *, rec_a †, rec_b †
        imgs = handle.decode_images(torch.stack(
            [za, zb, bound, (za + zb) / np.sqrt(2.0), *recs]), img_shape)
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(
            output_dir, f"cross_class_bind_unbind_{class_a}v{class_b}.png")
        titles = [
            f"A (cls {_class_name(class_names, class_a)})",
            f"B (cls {_class_name(class_names, class_b)})",
            "decode bind(A,B)", "decode bundle(A,B)",
            f"rec A (* {sim_star:.3f})", f"rec B (* {sim_star:.3f})",
            f"rec A († {sim_dag:.3f})", f"rec B († {sim_dag:.3f})",
        ]
        _plot_cross_class(path, imgs, titles, handle.distribution)
    return {
        "plot_path": path,
        "cross_class_bind_unbind_similarity": 0.5 * (sim_star + sim_dag),
        "cross_class_bind_unbind_similarity_star": sim_star,
        "cross_class_bind_unbind_similarity_dag": sim_dag,
        "cross_class_bind_unbind_plot_path": path,
        **sims,
    }


# evaluations named test_* as the JAX ones are, not pytest tests
test_self_binding.__test__ = False
test_vsa_operations.__test__ = False
test_pairwise_bind_bundle_decode.__test__ = False
test_cross_class_bind_unbind.__test__ = False
