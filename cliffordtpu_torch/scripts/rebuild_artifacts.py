"""Rebuild the unified sweep artifacts from per-experiment result dirs
(port of ``scripts/rebuild_artifacts.py``).

Re-derives the merge sidecars from each experiment's ``metrics.json`` /
``vsa_raw.json`` and regenerates the unified CSV, the per-dim cross-dist
comparison figures and the across-dims LaTeX / CSV: one artifact set for
a tree whose sweep ran in slices.  The random-HRR and unitary reference
curves are recomputed per dim with the port's ``vsa`` at the runner's
keys (``fold_in(PRNGKey(seed), dim)``), on ``--device`` (default the
card); the rest is host work.

    python -m cliffordtpu_torch.scripts.rebuild_artifacts \\
        --outdir artifacts/real_digits_cnn --dataset mnist32
"""

from __future__ import annotations

import argparse
import json
import os
import re

from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval.tables import (
    plot_across_dims_comparison,
    plot_cross_dist_comparison_dim,
)
from cliffordtpu_torch.runners.cnn_runner import (
    ACROSS_KEYS,
    format_table,
    reference_curves,
    results_rows,
    trial_entry,
    write_results_csv,
)
from cliffordtpu_torch.utils.artifacts import (
    merge_across_dims,
    merge_json_write,
)
EXP_RE = re.compile(r"^(?P<ds>.+)-(?P<dist>[a-z_0-9]+)-d(?P<dim>\d+)-"
                    r"(?P<recon>[a-z0-9]+?)(?:-trial(?P<trial>\d+))?$")


def scan_experiments(results_dir: str, dataset: str):
    """Yield (dist, dim, trial, metrics, vsa_raw) for each complete exp."""
    for name in sorted(os.listdir(results_dir)):
        m = EXP_RE.match(name)
        if not m or m.group("ds") != dataset:
            continue
        exp_dir = os.path.join(results_dir, name)
        mpath = os.path.join(exp_dir, "metrics.json")
        if not os.path.exists(mpath):
            print(f"skipping {name}: no metrics.json")
            continue
        with open(mpath) as f:
            metrics = json.load(f)
        vsa = {}
        vpath = os.path.join(exp_dir, "vsa_raw.json")
        if os.path.exists(vpath):
            with open(vpath) as f:
                vsa = json.load(f)
        yield (m.group("dist"), int(m.group("dim")),
               int(m.group("trial") or 1), metrics, vsa)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--dataset", default="mnist32")
    ap.add_argument("--vsa_trials", type=int, default=5,
                    help="trials for the recomputed random/unitary baselines")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the recomputed baselines; "
                         "default the GPU (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.chdir(args.outdir)
    results_dir = "results"
    dataset = args.dataset

    trial_metrics: dict = {}
    dim_results: dict = {}
    across: dict = {}
    for dist, dim, trial, metrics, vsa in scan_experiments(results_dir,
                                                           dataset):
        print(f"found {dataset}-{dist}-d{dim} trial {trial}")
        trial_metrics.setdefault(f"{dim}|{dist}", []).append(
            trial_entry(metrics))
        star = vsa.get("self_binding_star", {})
        dim_results.setdefault(dim, {})[dist] = {
            "bundle_cap": vsa.get("bundle_cap", {}),
            "role_filler": vsa.get("role_filler", {}),
            "self_binding_k_sims": star.get("k_sims", []),
            "self_binding_k_values": star.get("k_values", []),
            "knn_acc": metrics.get("knn_acc_1000", 0.0),
            "mean_cosine": metrics.get("mean_vector_cosine_acc", 0.0),
        }
        a = across.setdefault(dist, {
            "knn_100": [], "knn_600": [], "knn_1000": [], "f1_100": [],
            "f1_600": [], "f1_1000": [], "mean_cosine": [], "dims": []})
        for kk, mk in ACROSS_KEYS:
            a[kk].append(metrics.get(mk, 0.0))
        a["mean_cosine"].append(metrics.get("mean_vector_cosine_acc", 0.0))
        a["dims"].append(dim)

    if not trial_metrics:
        print("no experiments found; nothing to rebuild")
        return 1

    comp_dir = f"results/comparisons/{dataset}"
    os.makedirs(comp_dir, exist_ok=True)
    root_key = (0, args.seed)  # jax.random.PRNGKey(seed)

    for dim, dists in sorted(dim_results.items()):
        dists.update(reference_curves(root_key, dim, args.vsa_trials,
                                      device))
        merged = merge_json_write(f"{comp_dir}/dim{dim}_data.json", dists)
        path = plot_cross_dist_comparison_dim(merged, dim, dataset, comp_dir)
        print(f"rebuilt {path}")

    across_merged = merge_across_dims(f"{comp_dir}/across_dims_data.json",
                                      across)
    dims_union = sorted({d for v in across_merged.values()
                         for d in v.get("dims", [])})
    path = plot_across_dims_comparison(across_merged, dims_union, dataset,
                                       comp_dir)
    print(f"rebuilt {path}")

    merged_trials = merge_json_write(f"{dataset}_trial_metrics.json",
                                     trial_metrics)
    all_trials = {}
    for key, trials in merged_trials.items():
        ldim, dist = key.split("|", 1)
        all_trials[(int(ldim), dist)] = trials
    rows = results_rows(all_trials)
    csv_name = f"{dataset}_results.csv"
    write_results_csv(rows, csv_name)
    print(f"\n{format_table(rows)}\nrebuilt {csv_name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
