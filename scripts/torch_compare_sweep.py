#!/usr/bin/env python3
"""Hold one MNIST sweep against another, trial by trial: the port's
``mnist_clifpws`` sidecar (``mnist_vae_trial_metrics.json``) against the
JAX package's, and the vMF runner's trials against one reference trial.

    python3 scripts/torch_compare_sweep.py \\
        artifacts/torch_h100/across_dims_mnist/mnist_vae_trial_metrics.json \\
        artifacts/across_dims_mnist/mnist_vae_trial_metrics.json \\
        [--vmf PORT_VMF_DIR artifacts/real_digits_vmf] [--json OUT]
    python3 scripts/torch_compare_sweep.py --cnn PORT_ROOT artifacts

The bar, per (d, family) cell held by both sidecars: Welch's two-sample
t-test of the trial values of each primary metric (``acc_1000``, ``mvc``,
``ll``), Holm's step-down correction over all those tests at a
family-wise alpha of 0.01; a cell fails where any of its primary tests
is rejected.  For all eleven metrics of every cell it reports the
difference of the means (first minus second) with its 95% Welch
interval; where both samples have zero variance it compares the values
themselves (a test of two constants is undefined).  One line per test.

``--vmf`` reads the trials ``results/mnist-vmf-d{d}-l1-trial{n}/
metrics.json`` of two runner outdirs and reports where each metric of
the second's single trial falls against the first's trials' 99%
prediction interval, mean ± t(0.995, n-1) · s · sqrt(1 + 1/n) (where
every trial gives one value, the values themselves are compared).

``--cnn`` holds the CNN runners' sweep (``scripts/torch_sweep_cnn.sh``:
``PORT_ROOT/real_digits_{cnn,hybrid,vit}/results/mnist32-{dist}-d128-
l1-trial{n}/metrics.json``) against the JAX runs of one trial per cell
(``REF_ROOT/real_digits_{arch}_tpu/mnist32_trial_metrics.json``).  The
bar: per (arch, family) cell and primary metric (``knn_acc_1000``,
``mvc``, ``best_loss``) the prediction-interval test t = (x_JAX -
mean_port) / (s_port · sqrt(1 + 1/N)), two-sided p from t with N - 1
degrees of freedom; Holm over all those tests at a family-wise alpha of
0.01; a cell fails where any of its tests is rejected.  The other six
CSV metrics are reported as differences, without a gate.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys

import numpy as np
from scipy import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIMARY = ("acc_1000", "mvc", "ll")
METRICS = ("acc_100", "f1_100", "acc_600", "f1_600", "acc_1000", "f1_1000",
           "mvc", "ll", "entropy", "recon", "kl")
ALPHA = 0.01


def welch(a, b, conf=0.95):
    """(difference of the means a - b, interval half-width at ``conf``,
    p-value of Welch's t-test); p is None where both variances are 0."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    diff = float(a.mean() - b.mean())
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    se = math.sqrt(va + vb)
    if se == 0.0:
        return diff, 0.0, None
    dof = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    half = float(stats.t.ppf(0.5 + conf / 2, dof) * se)
    p = float(stats.ttest_ind(a, b, equal_var=False).pvalue)
    return diff, half, p


def holm(pvalues, alpha=ALPHA):
    """Holm's step-down rejections for a list of p-values."""
    order = sorted(range(len(pvalues)), key=lambda i: pvalues[i])
    reject = [False] * len(pvalues)
    m = len(pvalues)
    for rank, i in enumerate(order):
        if pvalues[i] > alpha / (m - rank):
            break
        reject[i] = True
    return reject


def _cell_key(key):
    d, dist = key.split("|", 1)
    return int(d), dist


def compare_sweeps(port, ref):
    """Every (cell, metric) test of the two sidecars: dicts with the cell,
    the metric, n, means, difference, interval, p and the verdict."""
    cells = sorted(set(port) & set(ref), key=_cell_key)
    rows = []
    for cell in cells:
        for metric in METRICS:
            a, b = port[cell].get(metric, []), ref[cell].get(metric, [])
            if not a or not b:
                continue
            diff, half, p = welch(a, b)
            rows.append(dict(cell=cell, metric=metric, n=(len(a), len(b)),
                             port_mean=float(np.mean(a)),
                             ref_mean=float(np.mean(b)), diff=diff,
                             ci95=(diff - half, diff + half), p=p,
                             primary=metric in PRIMARY,
                             constants_equal=(None if p is not None else
                                              bool(np.isclose(
                                                  a[0], b[0], rtol=1e-4,
                                                  atol=0)))))
    primary = [r for r in rows if r["primary"] and r["p"] is not None]
    for r, rej in zip(primary, holm([r["p"] for r in primary])):
        r["holm_reject"] = rej
    return rows


def trial_metrics(outdir, d):
    """The runner's per-trial metrics of the vMF cell at d, by trial."""
    out = []
    for path in glob.glob(os.path.join(outdir, "results",
                                       f"mnist-vmf-d{d}-l1-trial*",
                                       "metrics.json")):
        trial = int(re.search(r"trial(\d+)", path).group(1))
        with open(path) as f:
            out.append((trial, json.load(f)))
    return [m for _, m in sorted(out, key=lambda tm: tm[0])]


def prediction_intervals(trials, reference, level=0.99):
    """Each metric of the one ``reference`` trial against the ``trials``'
    prediction interval at ``level``."""
    rows = []
    for metric in reference:
        vals = [t[metric] for t in trials if metric in t]
        if len(vals) < 2 or not isinstance(reference[metric], (int, float)):
            continue
        v = np.asarray(vals, float)
        half = float(stats.t.ppf(0.5 + level / 2, len(v) - 1)
                     * v.std(ddof=1) * math.sqrt(1 + 1 / len(v)))
        lo, hi = float(v.mean() - half), float(v.mean() + half)
        ref = float(reference[metric])
        # trials that all give one value: compare the values themselves
        inside = (lo <= ref <= hi if half > 0 else
                  bool(np.isclose(ref, v[0], rtol=1e-4, atol=0)))
        rows.append(dict(metric=metric, n=len(v), mean=float(v.mean()),
                         interval=(lo, hi), reference=ref, inside=inside))
    return rows


CNN_ARCHES = ("cnn", "hybrid", "vit")
CNN_FAMILIES = ("clifford", "gaussian", "gaussian_nol2", "powerspherical")
CNN_PRIMARY = ("knn_acc_1000", "mvc", "best_loss")
CNN_REPORTED = ("knn_acc_100", "knn_acc_600", "knn_f1_100", "knn_f1_600",
                "knn_f1_1000", "fid")
CNN_D = 128


def cnn_port_trials(root, arch, dist, d=CNN_D):
    """The per-trial CSV records of one port cell, by trial."""
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch.runners.cnn_runner import trial_entry

    out = []
    for path in glob.glob(os.path.join(
            root, f"real_digits_{arch}", "results",
            f"mnist32-{dist}-d{d}-l1-trial*", "metrics.json")):
        trial = int(re.search(r"trial(\d+)", path).group(1))
        with open(path) as f:
            out.append((trial, trial_entry(json.load(f))))
    return [m for _, m in sorted(out, key=lambda tm: tm[0])]


def prediction_test(vals, x):
    """(t, two-sided p) of one value ``x`` against the trials ``vals``:
    t = (x - mean) / (s · sqrt(1 + 1/n)) with n - 1 degrees of freedom.
    Where the trials give one value, the values themselves are compared:
    p 1 where x equals it (1e-4 relative), else 0, and t None."""
    v = np.asarray(vals, float)
    s = v.std(ddof=1)
    if s == 0.0:
        return None, float(np.isclose(x, v[0], rtol=1e-4, atol=0))
    t = float((x - v.mean()) / (s * math.sqrt(1 + 1 / len(v))))
    return t, float(2 * stats.t.sf(abs(t), len(v) - 1))


def compare_cnn(port_root, ref_root):
    """Every (arch, family, metric) line of the CNN check, the primary
    ones with Holm's verdict."""
    rows = []
    for arch in CNN_ARCHES:
        with open(os.path.join(ref_root, f"real_digits_{arch}_tpu",
                               "mnist32_trial_metrics.json")) as f:
            ref = json.load(f)
        for dist in CNN_FAMILIES:
            trials = cnn_port_trials(port_root, arch, dist)
            jax_trials = ref.get(f"{CNN_D}|{dist}", [])
            if len(trials) < 2 or len(jax_trials) != 1:
                sys.exit(f"--cnn {arch} {dist}: {len(trials)} port trials "
                         f"against {len(jax_trials)} JAX trials")
            for metric in CNN_PRIMARY + CNN_REPORTED:
                vals = [t[metric] for t in trials
                        if not math.isnan(t[metric])]
                x = float(jax_trials[0][metric])
                t, p = (prediction_test(vals, x)
                        if metric in CNN_PRIMARY else (None, None))
                rows.append(dict(
                    arch=arch, dist=dist, metric=metric, n=len(vals),
                    port_mean=float(np.mean(vals)),
                    port_sd=float(np.std(vals, ddof=1)), jax=x,
                    diff=float(np.mean(vals) - x), t=t, p=p,
                    primary=metric in CNN_PRIMARY))
    primary = [r for r in rows if r["primary"]]
    for r, rej in zip(primary, holm([r["p"] for r in primary])):
        r["holm_reject"] = rej
    return rows


def print_cnn(rows):
    """One line per test, the 3 x 4 table, the verdict; the failed cells."""
    for r in rows:
        verdict = (f"t={r['t'] if r['t'] is None else round(r['t'], 3)} "
                   f"p={r['p']:.3g} "
                   f"{'REJECTED' if r['holm_reject'] else 'kept'}"
                   if r["primary"] else "(reported)")
        print(f"{r['arch']:>6} {r['dist']:>14} {r['metric']:>12} "
              f"n={r['n']} port {r['port_mean']:.4f} ± {r['port_sd']:.4f} "
              f"jax {r['jax']:.4f} diff {r['diff']:+.4f} {verdict}")
    print("| arch | " + " | ".join(CNN_FAMILIES) + " |")
    print("| --- |" + " --- |" * len(CNN_FAMILIES))
    for arch in CNN_ARCHES:
        cells = []
        for dist in CNN_FAMILIES:
            prim = {r["metric"]: r for r in rows if r["arch"] == arch
                    and r["dist"] == dist and r["primary"]}
            k, m, b = (prim[x] for x in CNN_PRIMARY)
            cells.append(
                f"{100 * k['port_mean']:.1f} ± {100 * k['port_sd']:.1f} / "
                f"{100 * m['port_mean']:.1f} ± {100 * m['port_sd']:.1f} / "
                f"{b['port_mean']:.2f} ± {b['port_sd']:.2f} (JAX "
                f"{100 * k['jax']:.1f} / {100 * m['jax']:.1f} / "
                f"{b['jax']:.2f}); p ≥ {min(r['p'] for r in prim.values()):.2g}")
        print(f"| {arch} | " + " | ".join(cells) + " |")
    primary = [r for r in rows if r["primary"]]
    failed = sorted({f"{r['arch']}|{r['dist']}" for r in primary
                     if r["holm_reject"]})
    print(f"cells {len(CNN_ARCHES) * len(CNN_FAMILIES)}, primary tests "
          f"{len(primary)}, Holm at alpha {ALPHA}: {len(failed)} cells "
          f"fail: {failed}; smallest p "
          f"{min(r['p'] for r in primary):.3g}")
    return failed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("port", nargs="?", help="the sidecar held to the bar")
    p.add_argument("reference", nargs="?",
                   help="the sidecar it is held against")
    p.add_argument("--cnn", nargs=2, metavar=("PORT_ROOT", "REF_ROOT"),
                   help="the CNN runners' sweep against the JAX runs")
    p.add_argument("--vmf", nargs=2, metavar=("PORT_DIR", "REF_DIR"),
                   help="two mnist_vmf outdirs: trials vs one trial")
    p.add_argument("--vmf_d", type=int, default=5)
    p.add_argument("--json", help="write every line's numbers here")
    args = p.parse_args(argv)
    if args.cnn:
        rows = compare_cnn(*args.cnn)
        failed = print_cnn(rows)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"tests": rows, "failed_cells": failed,
                           "alpha": ALPHA}, f, indent=1)
        return 0
    if not (args.port and args.reference):
        p.error("give PORT and REFERENCE sidecars, or --cnn")
    with open(args.port) as f:
        port = json.load(f)
    with open(args.reference) as f:
        ref = json.load(f)
    rows = compare_sweeps(port, ref)
    for r in rows:
        if r["p"] is None:
            verdict = ("both constant, equal" if r["constants_equal"]
                       else "both constant, DIFFERENT")
        elif r["primary"]:
            verdict = (f"p={r['p']:.3g} "
                       f"{'REJECTED' if r['holm_reject'] else 'kept'}")
        else:
            verdict = f"p={r['p']:.3g} (reported)"
        print(f"{r['cell']:>22} {r['metric']:>8} n={r['n'][0]}/{r['n'][1]}"
              f" port {r['port_mean']:.4f} ref {r['ref_mean']:.4f}"
              f" diff {r['diff']:+.4f} [{r['ci95'][0]:+.4f},"
              f" {r['ci95'][1]:+.4f}] {verdict}")
    primary = [r for r in rows if r["primary"] and r["p"] is not None]
    failed = sorted({r["cell"] for r in primary if r["holm_reject"]}
                    | {r["cell"] for r in rows if r["primary"]
                       and r["p"] is None and not r["constants_equal"]},
                    key=_cell_key)
    print(f"cells {len({r['cell'] for r in rows})}, primary tests "
          f"{len(primary)}, Holm at alpha {ALPHA}: "
          f"{len(failed)} cells fail: {failed}")
    vmf = []
    if args.vmf:
        trials = trial_metrics(args.vmf[0], args.vmf_d)
        reference = trial_metrics(args.vmf[1], args.vmf_d)
        if len(reference) != 1 or len(trials) < 2:
            sys.exit(f"--vmf: {len(trials)} trials against "
                     f"{len(reference)} reference trials")
        vmf = prediction_intervals(trials, reference[0])
        for r in vmf:
            print(f"vmf d{args.vmf_d} {r['metric']:>22} n={r['n']} mean "
                  f"{r['mean']:.4f} 99% PI [{r['interval'][0]:.4f}, "
                  f"{r['interval'][1]:.4f}] ref {r['reference']:.4f} "
                  f"{'inside' if r['inside'] else 'OUTSIDE'}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tests": rows, "failed_cells": failed, "alpha": ALPHA,
                       "vmf": vmf}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
