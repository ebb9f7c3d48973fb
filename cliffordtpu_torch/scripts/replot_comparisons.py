"""Regenerate the cross-distribution comparison plots from saved
``vsa_raw.json`` files (port of ``scripts/replot_comparisons.py``).

Scans a results directory, groups the trials by (dataset, dist, d),
averages their curves over trials and draws ``vsa_comparison_d{d}.png``
per latent dim through ``eval.tables.plot_cross_dist_comparison_dim``.
Host work only (JSON, numpy, matplotlib); no device is touched.

    python -m cliffordtpu_torch.scripts.replot_comparisons \\
        --results_dir results --dataset mnist --out results/comparisons/mnist
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict

import numpy as np

from cliffordtpu_torch.eval.tables import plot_cross_dist_comparison_dim

_NAME_RE = re.compile(
    r"^(?P<dataset>[a-z0-9]+)-(?P<dist>[a-z_0-9]+)-d(?P<d>\d+)-"
    r"(?P<loss>[a-z0-9]+)(-trial(?P<trial>\d+))?$")


def _avg_curves(entries, key):
    """Average {'k': [...], 'accuracy': [...]} dicts across trials."""
    ks = None
    accs = []
    for e in entries:
        cur = e.get(key) or {}
        if not cur.get("k"):
            continue
        if ks is None:
            ks = cur["k"]
        if cur["k"] == ks:
            accs.append(cur["accuracy"])
    if ks is None or not accs:
        return None
    return {"k": ks, "accuracy": np.mean(accs, axis=0).tolist()}


def _avg_sims(entries, key):
    vals = None
    sims = []
    for e in entries:
        cur = e.get(key) or {}
        if not cur.get("k_values"):
            continue
        if vals is None:
            vals = cur["k_values"]
        if cur["k_values"] == vals:
            sims.append(cur["k_sims"])
    if vals is None or not sims:
        return [], []
    return np.mean(sims, axis=0).tolist(), vals


def grouped_results(results_dir, dataset=None):
    """{d: {dist: [vsa_raw, ...]}} of the experiments under
    ``results_dir`` (of ``dataset`` only, where given), and the dataset
    prefix last seen."""
    grouped = defaultdict(lambda: defaultdict(list))
    dataset_seen = None
    for name in sorted(os.listdir(results_dir)):
        m = _NAME_RE.match(name)
        if not m:
            continue
        if dataset and m.group("dataset") != dataset:
            continue
        path = os.path.join(results_dir, name, "vsa_raw.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            raw = json.load(f)
        dataset_seen = m.group("dataset")
        grouped[int(m.group("d"))][m.group("dist")].append(raw)
    return grouped, dataset_seen


def averaged_dim_results(by_dist):
    """One dim's trials averaged per dist, in the plotter's layout."""
    dim_results = {}
    for dist, entries in by_dist.items():
        sims, vals = _avg_sims(entries, "self_binding_star")
        dim_results[dist] = {
            "bundle_cap": _avg_curves(entries, "bundle_cap"),
            "role_filler": _avg_curves(entries, "role_filler"),
            "self_binding_k_sims": sims,
            "self_binding_k_values": vals,
        }
    return dim_results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results_dir", default="results")
    p.add_argument("--dataset", default=None,
                   help="filter to one dataset prefix (e.g. mnist)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    grouped, dataset_seen = grouped_results(args.results_dir, args.dataset)
    if not grouped:
        print("no vsa_raw.json found")
        return 1

    out_dir = args.out or os.path.join(
        args.results_dir, "comparisons", dataset_seen or "dataset")
    for d, by_dist in sorted(grouped.items()):
        path = plot_cross_dist_comparison_dim(
            averaged_dim_results(by_dist), d, dataset_seen or "dataset",
            out_dir)
        print(f"d={d}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
