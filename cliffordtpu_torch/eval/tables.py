"""Comparison plots and LaTeX / CSV result tables (the port's copy of
``cliffordtpu/eval/tables.py``, which it may not import).  Host code
only: the output contract (file names, CSV header, booktabs layout, the
bold-best rule) is the JAX package's, byte for byte; matplotlib is
imported inside the function that draws."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from cliffordtpu_torch.utils import pyplot

COLORS = {
    "clifford": "#2196F3",
    "powerspherical": "#FF9800",
    "gaussian": "#4CAF50",
    "gaussian_nol2": "#9C27B0",
    "normal": "#4CAF50",
    "normal_nol2": "#9C27B0",
    "vmf": "#E91E63",
    "random_hrr": "#999999",
    "unitary": "#555555",
}
LABELS = {
    "clifford": "Clifford",
    "powerspherical": "PowerSpherical",
    "gaussian": "Gaussian (L2)",
    "gaussian_nol2": "Gaussian",
    "normal": "Gaussian (L2)",
    "normal_nol2": "Gaussian",
    "vmf": "vMF",
    "random_hrr": "random HRR (ref.)",
    "unitary": "unitary (ref.)",
}
LABELS_TEX = {
    "clifford": "$\\mathcal{C}$-VAE",
    "powerspherical": "$\\mathcal{S}$-VAE",
    "gaussian": "$\\mathcal{N}$-VAE (L2)",
    "gaussian_nol2": "$\\mathcal{N}$-VAE",
    "normal": "$\\mathcal{N}$-VAE (L2)",
    "normal_nol2": "$\\mathcal{N}$-VAE",
    "vmf": "vMF-VAE",
}
ORDER = ["random_hrr", "unitary", "gaussian_nol2", "gaussian",
         "normal_nol2", "normal", "vmf", "powerspherical", "clifford"]


def plot_cross_dist_comparison_dim(dim_results: Dict, latent_dim: int,
                                   dataset_name: str, output_dir: str):
    """3-panel bundle / self-binding / role-filler comparison at one d
    (``wandb_utils.py:848-928``)."""
    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for dist_name in ORDER:
        metrics = dim_results.get(dist_name)
        if metrics is None:
            continue
        ls = "--" if dist_name in ("random_hrr", "unitary") else "-"
        lw = 1 if dist_name in ("random_hrr", "unitary") else 2
        color = COLORS.get(dist_name, "black")
        label = LABELS.get(dist_name, dist_name)

        bc = metrics.get("bundle_cap")
        if bc and bc.get("k") and bc.get("accuracy"):
            axes[0].plot(bc["k"], bc["accuracy"], marker="o", markersize=5,
                         color=color, linestyle=ls, label=label, linewidth=lw)
        k_sims = metrics.get("self_binding_k_sims", [])
        k_vals = metrics.get("self_binding_k_values", [])
        if k_sims and k_vals:
            axes[1].plot(k_vals, k_sims, marker="o", markersize=5,
                         color=color, linestyle=ls, label=label, linewidth=lw)
        rf = metrics.get("role_filler")
        if rf and rf.get("k") and rf.get("accuracy"):
            axes[2].plot(rf["k"], rf["accuracy"], marker="s", markersize=5,
                         color=color, linestyle=ls, label=label, linewidth=lw)

    axes[0].set_xlabel("Number of Bundled Vectors ($k$)")
    axes[0].set_ylabel("Retrieval Accuracy")
    axes[0].set_title(f"Bundle Capacity ($d={latent_dim}$)")
    axes[0].set_ylim(0, 1.05)
    axes[1].set_xlabel("Number of Recursive Bind-Unbind Cycles ($m$)")
    axes[1].set_ylabel("Cosine Similarity to Original")
    axes[1].set_title(f"Invertible Self-Binding ($d={latent_dim}$)")
    axes[1].set_ylim(-0.1, 1.05)
    axes[2].set_xlabel("Number of Bundled Role-Filler Pairs ($k$)")
    axes[2].set_ylabel("Unbinding Accuracy")
    axes[2].set_title(f"Role-Filler Capacity ($d={latent_dim}$)")
    axes[2].set_ylim(0, 1.05)
    for ax in axes:
        ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
    fig.suptitle(f"{dataset_name} — VSA Comparison ($d={latent_dim}$)",
                 fontsize=13)
    plt.tight_layout()
    os.makedirs(output_dir, exist_ok=True)
    save_path = os.path.join(output_dir, f"vsa_comparison_d{latent_dim}.png")
    plt.savefig(save_path, dpi=300)
    plt.close()
    return save_path


def plot_across_dims_comparison(across_dim_results: Dict,
                                latent_dims_used: List[int],
                                dataset_name: str,
                                output_dir: str) -> Optional[str]:
    """LaTeX booktabs + CSV of kNN acc / macro-F1 / mean-cosine across dims,
    best-per-column bolded (``wandb_utils.py:931-1134``)."""
    dist_order = [d for d in ["gaussian_nol2", "gaussian", "normal_nol2",
                              "normal", "vmf", "powerspherical", "clifford"]
                  if d in across_dim_results
                  and across_dim_results[d].get("dims")]
    if not dist_order:
        return None

    # Align by dim VALUE, not position: merged sidecars can hold divergent
    # dims x trials shapes per dist (sliced invocations, deadline-truncated
    # sweeps), where the reference's positional alignment to the first
    # dist's dims list (``wandb_utils.py:958,986``) would misattribute
    # values across dims.  Multi-trial entries (dims repeats once per
    # trial) aggregate to mean +- sample std per (dist, dim).
    dims = sorted({int(d) for dn in dist_order
                   for d in across_dim_results[dn].get("dims", [])})
    if latent_dims_used:
        requested = [int(d) for d in latent_dims_used]
        dims = [d for d in dims if d in requested] or dims
    train_sizes = [100, 600, 1000]
    has_mean_cosine = any(
        len(across_dim_results[d].get("mean_cosine", [])) > 0
        for d in dist_order)
    metric_keys = {
        "knn": ["knn_100", "knn_600", "knn_1000"],
        "f1": ["f1_100", "f1_600", "f1_1000"],
    }
    os.makedirs(output_dir, exist_ok=True)

    def fmt_pct(v, scale_from=None):
        # scale decision rides on the mean so a <=1.0 std next to a
        # percentage-scaled mean can't mix scales in one cell
        ref = v if scale_from is None else scale_from
        return f"{v * 100:.1f}" if ref <= 1.0 else f"{v:.1f}"

    def _by_dim(dist_name, key):
        """{dim: (mean, sample std, n)} over that dist's trials at dim."""
        data = across_dim_results[dist_name]
        vals = list(data.get(key, []))
        groups: dict = {}
        for i, d in enumerate(data.get("dims", [])):
            v = vals[i] if i < len(vals) else float("nan")
            groups.setdefault(int(d), []).append(v)
        out = {}
        for d, vs in groups.items():
            arr = np.asarray(vs, dtype=float)
            ok = arr[~np.isnan(arr)]
            if ok.size == 0:
                out[d] = (float("nan"), float("nan"), 0)
            else:
                std = float(ok.std(ddof=1)) if ok.size > 1 else float("nan")
                out[d] = (float(ok.mean()), std, int(ok.size))
        return out

    # rows: (dist, metric, n_train, {dim: (mean, std, n)})
    rows = []
    for dist_name in dist_order:
        for m in ["knn", "f1"]:
            for n_train, kk in zip(train_sizes, metric_keys[m]):
                rows.append((dist_name, m, n_train, _by_dim(dist_name, kk)))
        if has_mean_cosine:
            rows.append((dist_name, "mean_cosine", None,
                         _by_dim(dist_name, "mean_cosine")))

    NAN_STAT = (float("nan"), float("nan"), 0)
    best_vals = defaultdict(lambda: (float("-inf"), None))
    for dist_name, m, n_train, stats in rows:
        for d, (mean, _, _) in stats.items():
            if np.isnan(mean):
                continue
            ck = (m, n_train, d)
            if mean > best_vals[ck][0]:
                best_vals[ck] = (mean, dist_name)
    best_dist = {k: d for k, (_, d) in best_vals.items()}

    n_dists = len(dist_order)
    dist_syms = [LABELS_TEX.get(d, d) for d in dist_order]
    lines = [
        "\\begin{table}[h]",
        "\\centering",
        f"\\caption{{Semi-supervised $k$-NN results on "
        f"{dataset_name.replace('_', ' ').title()} (CNN, across latent "
        f"dimensions).}}",
        f"\\label{{tab:{dataset_name}_cnn_knn}}",
    ]
    col_spec = "l" + ("|" + "c" * n_dists) * len(train_sizes)
    lines.append(f"\\begin{{tabular}}{{{col_spec}}}")
    lines.append("\\toprule")
    header1 = " "
    for n_train in train_sizes:
        header1 += f" & \\multicolumn{{{n_dists}}}{{c|}}{{{n_train}}}"
    lines.append(header1.rstrip("|") + " \\\\")
    header2 = "Method"
    for _ in train_sizes:
        for sym in dist_syms:
            header2 += f" & {sym}"
    lines.append(header2 + " \\\\")
    lines.append("\\midrule")

    def _lookup(dist_name, m, n_train, d):
        for dn, rm, rn, stats in rows:
            if dn == dist_name and rm == m and rn == n_train:
                return stats.get(d, NAN_STAT)
        return NAN_STAT

    def _cell(stat, bold):
        mean, std, n = stat
        if np.isnan(mean):
            return " & —"
        s = fmt_pct(mean)
        if n > 1 and not np.isnan(std):
            s += f" {{\\scriptsize$\\pm${fmt_pct(std, scale_from=mean)}}}"
        return f" & \\textbf{{{s}}}" if bold else f" & {s}"

    for m, m_label in [("knn", "Accuracy"), ("f1", "Macro F1")]:
        lines.append(
            f"\\multicolumn{{{1 + n_dists * len(train_sizes)}}}{{l}}"
            f"{{\\textit{{{m_label}}}}} \\\\")
        for d in dims:
            row_str = f"$d = {d}$"
            for n_train in train_sizes:
                for dist_name in dist_order:
                    row_str += _cell(
                        _lookup(dist_name, m, n_train, d),
                        best_dist.get((m, n_train, d)) == dist_name)
            lines.append(row_str + " \\\\")
        lines.append("\\addlinespace")

    if has_mean_cosine:
        lines.append(
            f"\\multicolumn{{{1 + n_dists * len(train_sizes)}}}{{l}}"
            "{\\textit{Mean Cosine Acc.}} \\\\")
        for d in dims:
            row_str = f"$d = {d}$"
            for n_train in train_sizes:
                for dist_name in dist_order:
                    row_str += _cell(
                        _lookup(dist_name, "mean_cosine", None, d),
                        best_dist.get(("mean_cosine", None, d)) == dist_name)
            lines.append(row_str + " \\\\")
        lines.append("\\addlinespace")

    lines += ["\\bottomrule", "\\end{tabular}", "\\end{table}"]
    tex_path = os.path.join(output_dir, f"{dataset_name}_results.tex")
    with open(tex_path, "w") as f:
        f.write("\n".join(lines))
    print(f"latex table saved to {tex_path}")

    # CSV: the main file keeps the reference schema exactly — ONE row per
    # (method, metric, n_train) with one value column per dim
    # (``wandb_utils.py:1095-1110``), so positional/one-row-per-metric
    # consumers parse it unchanged.  Multi-trial sweeps emit the
    # `<metric>_std` / `<metric>_n` rows into a sibling
    # ``{dataset}_results_stats.csv`` (same header) so mean+-std still
    # round-trips without polluting the reference-shaped file.
    header = "method,metric,n_train," + ",".join(f"d={d}" for d in dims)
    csv_lines = [header]
    stats_lines = [header]
    for dist_name, m, n_train, stats in rows:
        label = LABELS.get(dist_name, dist_name)
        n_str = str(n_train) if n_train else "—"
        means = [stats.get(d, NAN_STAT)[0] for d in dims]
        csv_lines.append(f"{label},{m},{n_str}," + ",".join(
            f"{v:.4f}" if not np.isnan(v) else "" for v in means))
        if any(stats.get(d, NAN_STAT)[2] > 1 for d in dims):
            stds = [stats.get(d, NAN_STAT)[1] for d in dims]
            ns = [stats.get(d, NAN_STAT)[2] for d in dims]
            stats_lines.append(f"{label},{m}_std,{n_str}," + ",".join(
                f"{v:.4f}" if not np.isnan(v) else "" for v in stds))
            stats_lines.append(f"{label},{m}_n,{n_str}," + ",".join(
                str(n) for n in ns))
    csv_path = os.path.join(output_dir, f"{dataset_name}_results.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(csv_lines))
    print(f"csv saved to {csv_path}")
    if len(stats_lines) > 1:
        stats_path = os.path.join(
            output_dir, f"{dataset_name}_results_stats.csv")
        with open(stats_path, "w") as f:
            f.write("\n".join(stats_lines))
        print(f"trial stats saved to {stats_path}")
    return tex_path
