"""MNIST experiment runner: clifford / powerspherical / gaussian sweep of the
``MLPVAE`` (port of ``scripts/mnist_clifpws.py``: the same flags,
defaults, keys and artifacts; what it shares with the vMF runner lives in
``cliffordtpu_torch/runners/mnist_runner.py``).

    CLIFFORDTPU_DATA_DIR=$PWD/tests/data python -m \\
        cliffordtpu_torch.scripts.mnist_clifpws --d_dims 5 --n_runs 2 \\
        --epochs 2 --vmap_trials --no_wandb --outdir /tmp/out

runs on the card; ``--device cpu`` runs the plain versions of the kernels
on the CPU.  Writes, relative to ``--outdir``:
``visualizations/d_{d}/{dist}/*``,
``results/mnist-{dist}-d{d}-l1-trial{n}/{vsa_raw,metrics}.json``, the
per-trial sidecar ``mnist_vae_trial_metrics.json`` (merged per (d,
family), so a sweep sliced by ``--d_dims`` into one outdir adds up),
``mnist_vae_results.csv``, ``results/comparisons/mnist/`` and the merged
``mnist_clifpws_timing.json``.  ``--scan_epochs`` is accepted and changes
nothing.  The battery's kNN runs the "torch" backend (the card has no
scikit-learn); the drawing halves of the plots import matplotlib when
called, inside ``safe_eval``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from cliffordtpu_torch import random
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval import ModelHandle
from cliffordtpu_torch.eval.binding import (
    test_cross_class_bind_unbind,
    test_pairwise_bind_bundle_decode,
    test_self_binding,
)
from cliffordtpu_torch.eval.class_means import (
    compute_class_means,
    evaluate_mean_vector_cosine,
)
from cliffordtpu_torch.eval.knn import perform_knn_evaluation
from cliffordtpu_torch.eval.plots import (
    plot_clifford_manifold_visualization,
    plot_gaussian_manifold_visualization,
    plot_interpolations,
    plot_latent_space,
    plot_powerspherical_manifold_visualization,
    plot_reconstructions,
)
from cliffordtpu_torch.eval.tables import plot_across_dims_comparison
from cliffordtpu_torch.nn.losses import compute_test_metrics
from cliffordtpu_torch.nn.mlp_vae import MLPVAE
from cliffordtpu_torch.runners.cnn_runner import run_eval_child
from cliffordtpu_torch.runners.mnist_runner import (
    KNN_SAMPLES,
    NAN_METRICS,
    batches,
    child_argv,
    load_mnist,
    mean_std,
    merge_child_battery,
    print_results,
    train_lanes,
    train_trial,
    write_trial,
)
from cliffordtpu_torch.runners.safety import (
    EMPTY_BINDING,
    EMPTY_CURVE,
    safe_eval,
)
from cliffordtpu_torch.utils import (
    WandbLogger,
    ensure_dir,
    get_default_device,
    stable_hash,
)
from cliffordtpu_torch.utils.artifacts import load_json, merge_json_write
from cliffordtpu_torch.vsa.capacity import (
    test_binding_unbinding_pairs as vsa_binding_unbinding,
    test_bundle_capacity as vsa_bundle_capacity,
    test_per_class_bundle_capacity_k_items,
)

DISTRIBUTIONS = ["normal", "normal_nol2", "powerspherical", "clifford"]
SIDECAR = "mnist_vae_trial_metrics.json"
TIMING = "mnist_clifpws_timing.json"


def run_key(seed: int, mdim: int, r: int, dist: str):
    """``fold_in(fold_in(PRNGKey(seed), d * 1000 + r), stable_hash(dist) %
    100_000)`` as two words."""
    return random.fold_in_words(
        random.fold_in_words((0, seed), mdim * 1000 + r),
        stable_hash(dist) % 100_000)


def run(args):
    # --distributions subsets the reference's fixed family list
    dists = getattr(args, "distributions", None) or DISTRIBUTIONS
    for d in dists:
        if d not in DISTRIBUTIONS:
            raise SystemExit(f"unknown distribution {d!r}; "
                             f"choose from {DISTRIBUTIONS}")

    script_start_time = time.time()
    timing_results = {}
    device = resolve_device(getattr(args, "device", None))
    os.chdir(ensure_dir(args.outdir))
    print(f"Using device: {get_default_device(device)}")

    data = load_mnist(args, getattr(args, "require_real", False))
    if data["source"] == "synthetic":
        print("WARNING: no real MNIST found — using the synthetic fallback "
              "(cliffordtpu_torch/data/loaders.py)")
    timing_results["data_source"] = data["source"]
    x_all, y_all = data["x_all"], data["y_all"]
    x_train, y_train = data["x_train"], data["y_train"]
    x_test, y_test = data["x_test"], data["y_test"]
    logger = WandbLogger(args)

    for mdim in args.d_dims:
        print(f"\n{'=' * 30}\n==d = {mdim} ==\n{'=' * 30}")
        agg_results = {d: {s: [] for s in KNN_SAMPLES} for d in dists}
        agg_f1 = {d: {s: [] for s in KNN_SAMPLES} for d in dists}
        agg_metrics = {d: {"ll": [], "entropy": [], "recon": [], "kl": []}
                       for d in dists}
        agg_mvc = {d: [] for d in dists}

        for dist in dists:
            model_z_dim = mdim + 1 if dist == "powerspherical" else mdim
            if dist == "clifford" and mdim < 2:
                continue
            print(f"\n--- Testing {dist.upper()}-VAE with d={mdim} "
                  f"(model z_dim={model_z_dim}, lr={args.lr}) ---")
            l2_norm = dist == "normal"
            model_dist = "normal" if dist == "normal_nol2" else dist

            def make_model(seed):
                return MLPVAE(args.h_dim, model_z_dim, model_dist, l2_norm,
                              seed=seed)

            # batched-trial training: all n_runs lanes advance together
            # (each lane's results those of its sequential fit)
            lanes = None
            if getattr(args, "vmap_trials", False) and args.n_runs > 1:
                lanes = train_lanes(
                    args, make_model,
                    [run_key(args.seed, mdim, r, dist)
                     for r in range(args.n_runs)], data, logger, device)

            for run_i in range(args.n_runs):
                print(f"\n--- Run {run_i + 1}/{args.n_runs} ---")
                run_start_time = time.time()
                rkey = run_key(args.seed, mdim, run_i, dist)
                if logger.use:
                    logger.start_run(f"{dist}-d{mdim}-run{run_i + 1}", args)

                state, history, train_time = train_trial(
                    args, make_model, rkey, data, logger, device, lanes,
                    run_i)
                model = state.model
                best_val_loss = history["best_val"]
                print(f"training time for {dist}-d{mdim}-run{run_i + 1}: "
                      f"{train_time:.2f}s "
                      f"({len(history['train_loss'])} epochs)")

                eval_start_time = time.time()
                vis_dir = ensure_dir(f"visualizations/d_{mdim}/{dist}")
                # sweep mode (--full_eval_runs N): the heavy VSA battery
                # + plot stages run on the first N runs per (dim, dist)
                # only — in-process via hstage(), in subprocess mode via
                # eval_checkpoint --table_only
                heavy_ok = run_i < getattr(args, "full_eval_runs", 10**9)
                did_sub, sub_metrics, sub_vsa = False, {}, {}
                train_only = getattr(args, "train_only", False)
                if train_only:
                    did_sub = True  # route every stage() to its default
                elif getattr(args, "eval_subprocess", False):
                    did_sub, sub_metrics, sub_vsa = run_eval_child(
                        state, vis_dir, child_argv(
                            args, vis_dir, distribution=model_dist,
                            latent_dim=model_z_dim, l2_normalize=l2_norm,
                            table_only=not heavy_ok))

                def stage(label, fn, default=None):
                    if did_sub:
                        return default
                    return safe_eval(label, fn, default)

                def hstage(label, fn, default=None):
                    if not heavy_ok:
                        return default
                    return stage(label, fn, default)

                handle = ModelHandle(model)
                ekey = random.fold_in_words(rkey, 2)

                test_metrics = NAN_METRICS if train_only else safe_eval(
                    "compute_test_metrics",
                    lambda: compute_test_metrics(
                        ekey, model, batches(x_test, y_test, 512)),
                    default=NAN_METRICS)
                for mname in ["ll", "entropy", "recon", "kl"]:
                    agg_metrics[dist][mname].append(test_metrics[mname])
                print(f"  LL: {test_metrics['ll']:.2f}, "
                      f"L[q]: {test_metrics['entropy']:.2f}, "
                      f"RE: {test_metrics['recon']:.2f}, "
                      f"KL: {test_metrics['kl']:.2f}")

                knn_results = stage(
                    "knn_evaluation",
                    lambda: perform_knn_evaluation(
                        handle, x_train, y_train, x_test, y_test,
                        [s for s in KNN_SAMPLES if s <= len(x_train)],
                        backend="torch", key=ekey),
                    default={})
                if not did_sub:
                    for s in KNN_SAMPLES:
                        if f"knn_acc_{s}" in knn_results:
                            agg_results[dist][s].append(
                                knn_results[f"knn_acc_{s}"])
                            agg_f1[dist][s].append(
                                knn_results[f"knn_f1_{s}"])

                deconv_dir = ensure_dir(f"{vis_dir}/deconv")
                x_sub, y_sub = x_test[:1000], y_test[:1000]

                fourier_pseudo = hstage(
                    "self_binding(*)",
                    lambda: test_self_binding(
                        handle, x_sub, y_sub, vis_dir, unbind_method="*",
                        key=ekey),
                    default=dict(EMPTY_BINDING))
                fourier_deconv = hstage(
                    "self_binding(†)",
                    lambda: test_self_binding(
                        handle, x_sub, y_sub, deconv_dir, unbind_method="†",
                        key=ekey),
                    default=dict(EMPTY_BINDING))

                # item memory of posterior means (reference :364-376)
                n_mem = min(500, len(x_test))
                item_memory = hstage(
                    "item_memory",
                    lambda: handle.latent_mu(x_test[:n_mem], ekey))
                item_labels = y_test[:n_mem]
                item_images = data["images_test"][:n_mem]

                if heavy_ok and not did_sub:
                    print(f"running VSA battery ({dist})...")
                hstage("per_class_bundle",
                       lambda: test_per_class_bundle_capacity_k_items(
                           d=item_memory.shape[-1], n_items=n_mem,
                           n_classes=10, items_per_class=1, n_trials=2,
                           plot=True, save_dir=vis_dir,
                           item_memory=item_memory, labels=item_labels,
                           item_images=item_images * 2 - 1,
                           class_names=[str(i) for i in range(10)],
                           key=ekey))

                bundle_cap_raw = hstage(
                    "bundle_capacity",
                    lambda: vsa_bundle_capacity(
                        d=item_memory.shape[-1], n_items=n_mem,
                        k_range=list(range(5, 51, 5)),
                        n_trials=args.vsa_trials, plot=True,
                        save_dir=vis_dir, item_memory=item_memory, key=ekey),
                    default=dict(EMPTY_CURVE))

                rf_results = {}
                for ubmethod, rf_name in [
                    ("*", "role_filler_no_random_keys"),
                    ("†", "role_filler_no_random_keys_deconv"),
                ]:
                    save_d = deconv_dir if ubmethod == "†" else vis_dir
                    rf_res = hstage(
                        f"role_filler({ubmethod})",
                        lambda ub=ubmethod, sd=save_d: vsa_binding_unbinding(
                            d=item_memory.shape[-1], n_items=n_mem,
                            k_range=list(range(2, 21, 2)),
                            n_trials=args.vsa_trials, plot=True,
                            unbind_method=ub, save_dir=sd,
                            item_memory=item_memory, bind_with_random=False,
                            key=ekey),
                        default=dict(EMPTY_CURVE))
                    rf_results[rf_name] = rf_res
                    default_plot = os.path.join(save_d,
                                                "role_filler_capacity.png")
                    if os.path.exists(default_plot):
                        os.rename(default_plot,
                                  os.path.join(save_d, f"{rf_name}.png"))
                role_filler_raw = rf_results.get(
                    "role_filler_no_random_keys", {})

                hstage("pairwise_bind_bundle",
                       lambda: test_pairwise_bind_bundle_decode(
                           handle, x_sub, y_sub, vis_dir,
                           img_shape=(28, 28, 1),
                           class_names=[str(i) for i in range(10)],
                           key=ekey))
                hstage("cross_class_bind_unbind",
                       lambda: test_cross_class_bind_unbind(
                           handle, x_sub, y_sub, vis_dir,
                           img_shape=(28, 28, 1), class_a=6, class_b=9,
                           key=ekey))

                hstage("reconstructions", lambda: plot_reconstructions(
                    handle, x_test, os.path.join(vis_dir,
                                                 "reconstructions.png"),
                    key=ekey))
                hstage("interpolations", lambda: plot_interpolations(
                    handle, x_test, y_test,
                    os.path.join(vis_dir, "interpolations.png"), key=ekey))
                hstage("tsne", lambda: plot_latent_space(
                    handle, x_test, y_test, os.path.join(vis_dir, "tsne.png"),
                    n_plot=min(1000, len(x_test)), key=ekey))

                mean_vector_acc = stage(
                    "mean_vector_cosine",
                    lambda: evaluate_mean_vector_cosine(
                        handle, x_test, y_test,
                        compute_class_means(
                            handle, x_all[:5000], y_all[:5000],
                            max_per_class=1000, key=ekey),
                        key=ekey)[0],
                    default=0.0)
                if not did_sub:
                    print(f"  mean vector cosine acc: "
                          f"{mean_vector_acc:.4f}")
                    agg_mvc[dist].append(float(mean_vector_acc))

                if did_sub:
                    knn_results = {k: v for k, v in sub_metrics.items()
                                   if k.startswith("knn_")}
                    for s in KNN_SAMPLES:
                        if f"knn_acc_{s}" in knn_results:
                            agg_results[dist][s].append(
                                knn_results[f"knn_acc_{s}"])
                            agg_f1[dist][s].append(
                                knn_results[f"knn_f1_{s}"])
                    mean_vector_acc = sub_metrics.get(
                        "mean_vector_cosine_acc", 0.0)
                    agg_mvc[dist].append(float(mean_vector_acc))
                    (bundle_cap_raw, role_filler_raw, fourier_pseudo,
                     fourier_deconv) = merge_child_battery(sub_vsa)

                # per-trial dumps (reference :493-527)
                dist_out = {"normal": "gaussian",
                            "normal_nol2": "gaussian_nol2"}.get(dist, dist)
                write_trial(
                    f"results/mnist-{dist_out}-d{mdim}-l1-trial{run_i + 1}",
                    bundle_cap=bundle_cap_raw, role_filler=role_filler_raw,
                    star=fourier_pseudo, dagger=fourier_deconv,
                    knn_results=knn_results,
                    mean_vector_acc=mean_vector_acc,
                    test_metrics=test_metrics, best_val_loss=best_val_loss)

                if dist == "clifford" and mdim >= 2:
                    hstage("clifford_manifold",
                           lambda: plot_clifford_manifold_visualization(
                               handle, vis_dir, n_grid=16, dims=(0, 1)))
                elif dist == "powerspherical" and mdim >= 2:
                    hstage("ps_manifold",
                           lambda: plot_powerspherical_manifold_visualization(
                               handle, vis_dir, n_samples=1000,
                               dims=(0, 1), key=ekey))
                elif dist == "normal" and mdim >= 2:
                    hstage("gaussian_manifold",
                           lambda: plot_gaussian_manifold_visualization(
                               handle, vis_dir, n_samples=1000,
                               dims=(0, 1), key=ekey))

                if logger.use:
                    logger.log_summary({
                        **{k: v for k, v in knn_results.items()
                           if k.startswith("knn_")},
                        "final_val_loss": best_val_loss,
                        "mean_vector_cosine_acc": float(mean_vector_acc),
                        "test/ll": test_metrics["ll"],
                        "test/entropy": test_metrics["entropy"],
                        "test/recon": test_metrics["recon"],
                        "test/kl": test_metrics["kl"],
                    })
                    logger.finish_run()

                eval_time = time.time() - eval_start_time
                run_time = time.time() - run_start_time
                timing_results[f"{dist}_d{mdim}_run{run_i + 1}"] = {
                    "train_time_s": train_time,
                    "eval_time_s": eval_time,
                    "total_run_time_s": run_time,
                }
                print(f"eval time: {eval_time:.2f}s, "
                      f"total run time: {run_time:.2f}s")
            del lanes

        # this dim's raw per-trial aggregates into the merge-on-write
        # sidecar, so sliced invocations aggregate into one CSV
        sidecar_update = {}
        for dist in dists:
            entry = {"mvc": [float(v) for v in agg_mvc[dist]]}
            for s in KNN_SAMPLES:
                entry[f"acc_{s}"] = [float(v) for v in agg_results[dist][s]]
                entry[f"f1_{s}"] = [float(v) for v in agg_f1[dist][s]]
            for metric in ["ll", "entropy", "recon", "kl"]:
                entry[metric] = [float(v) for v in agg_metrics[dist][metric]]
            sidecar_update[f"{mdim}|{dist}"] = entry
        merge_json_write(SIDECAR, sidecar_update)
        # the CSV and the across-dims table after EVERY dim, so a run cut
        # by a deadline leaves tables of all completed dims
        _regenerate_summary_tables(quiet=True)

    _regenerate_summary_tables()

    # merge-on-write timing (sliced runs accumulate, totals add up)
    timing_results["total_script_time_s"] = time.time() - script_start_time
    prior_total = load_json(TIMING).get("total_script_time_s", 0.0)
    if isinstance(prior_total, (int, float)):
        timing_results["total_script_time_s"] += prior_total
    merge_json_write(TIMING, timing_results)
    print(f"\ntotal script execution time: "
          f"{timing_results['total_script_time_s']:.2f}s")


def _fmt(vals, pct=True) -> str:
    if not vals:
        return "N/A"
    scale = 100 if pct else 1
    prec = 1 if pct else 2
    if len(vals) > 1:
        return mean_std(vals, scale, prec)
    return f"{vals[0] * scale:.{prec}f}"


def summary_rows(merged_trials):
    """The rows of ``mnist_vae_results.csv`` from the merged sidecar: per
    d, each family's (in ``DISTRIBUTIONS``' order) mean ± std over trials,
    kNN and mean-vector cosine in percent."""
    all_dims = sorted({int(k.split("|")[0]) for k in merged_trials})
    dist_cols = [d for d in DISTRIBUTIONS
                 if any(k.split("|", 1)[1] == d for k in merged_trials)]
    rows = []
    for mdim in all_dims:
        row = {"d": mdim}
        for dist in dist_cols:
            D = dist.upper()
            e = merged_trials.get(f"{mdim}|{dist}", {})
            for s in KNN_SAMPLES:
                row[f"{D}_acc_{s}"] = _fmt(e.get(f"acc_{s}", []))
                row[f"{D}_f1_{s}"] = _fmt(e.get(f"f1_{s}", []))
            row[f"{D}_mvc"] = _fmt(e.get("mvc", []))
            for metric in ["ll", "entropy", "recon", "kl"]:
                row[f"{D}_{metric}"] = _fmt(e.get(metric, []), pct=False)
        rows.append(row)
    return rows, all_dims


def across_dims(merged_trials):
    """The across-dims table's input from the merged sidecar: per family,
    one entry per (d, trial) in d order."""
    across = {}
    for key, e in merged_trials.items():
        mdim_s, dist = key.split("|", 1)
        a = across.setdefault(dist, {
            "knn_100": [], "knn_600": [], "knn_1000": [],
            "f1_100": [], "f1_600": [], "f1_1000": [],
            "mean_cosine": [], "dims": []})
        n = max([len(e.get(f"acc_{s}", [])) for s in KNN_SAMPLES]
                + [len(e.get("mvc", []))] + [0])
        for i in range(n):
            for s in KNN_SAMPLES:
                acc = e.get(f"acc_{s}", [])
                f1 = e.get(f"f1_{s}", [])
                a[f"knn_{s}"].append(acc[i] if i < len(acc) else float("nan"))
                a[f"f1_{s}"].append(f1[i] if i < len(f1) else float("nan"))
            mvc = e.get("mvc", [])
            a["mean_cosine"].append(mvc[i] if i < len(mvc) else float("nan"))
            a["dims"].append(int(mdim_s))
    for dist in across:  # stable dim order
        order = np.argsort(np.array(across[dist]["dims"]), kind="stable")
        for k in across[dist]:
            across[dist][k] = [across[dist][k][i] for i in order]
    return across


def _regenerate_summary_tables(quiet=False):
    """``mnist_vae_results.csv`` and the across-dims table
    (``results/comparisons/mnist/``) from the merged sidecar in the
    current directory (reference :659-692)."""
    merged_trials = load_json(SIDECAR)
    rows, all_dims = summary_rows(merged_trials)
    if rows:
        print_results(rows, "mnist_vae_results.csv",
                      None if quiet else "all metrics")
        # the paper's headline table (``utils/wandb_utils.py:931-1134``)
        try:
            path = plot_across_dims_comparison(
                across_dims(merged_trials), all_dims, "mnist",
                "results/comparisons/mnist")
            if path and not quiet:
                print(f"saved across-dims comparison to {path}")
        except Exception as e:
            print(f"warning: across-dims comparison failed: {e}")
    elif not quiet:
        print("no results were generated.")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Run VAE experiments on MNIST, contrasting "
                    "clifford/gaussian/powerspherical")
    parser.add_argument("--d_dims", type=int, nargs="+",
                        default=[2, 5, 10, 20, 40, 128, 256])
    parser.add_argument("--h_dim", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--patience", type=int, default=50)
    parser.add_argument("--warmup_epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--n_runs", type=int, default=20)
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str,
                        default="mnist-svae-experiments")
    # extensions over the reference CLI (defaults preserve its behavior)
    parser.add_argument("--outdir", type=str, default=".")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--require_real", action="store_true",
                        help="abort instead of training on the synthetic "
                             "fallback when no real dataset files are found")
    parser.add_argument("--limit_train", type=int, default=None,
                        help="cap train set size (smoke tests)")
    parser.add_argument("--limit_test", type=int, default=None)
    parser.add_argument("--vsa_trials", type=int, default=20)
    parser.add_argument("--eval_subprocess", action="store_true",
                        help="run the VSA/kNN battery in the port's "
                             "eval_checkpoint in a fresh process, on the "
                             "same device")
    parser.add_argument("--scan_epochs", action="store_true",
                        help="accepted as in JAX; no effect here: the epoch "
                             "runs the same per-step loop either way")
    parser.add_argument("--vmap_trials", action="store_true",
                        help="train all n_runs trials of each "
                             "(distribution, d) cell SIMULTANEOUSLY with "
                             "fit_trials (per-trial results equal the "
                             "sequential path; the reference trains its 20 "
                             "runs one by one)")
    parser.add_argument("--full_eval_runs", type=int, default=10**9,
                        help="run the heavy VSA battery / plot stages on "
                             "only the first N runs per (dim, dist); all "
                             "runs keep the table-feeding eval (test "
                             "metrics, knn, mean-vector cosine).  Default: "
                             "all runs full")
    parser.add_argument("--train_only", action="store_true",
                        help="skip the eval battery entirely (timing/perf "
                             "studies); metrics columns come out NaN")
    parser.add_argument("--distributions", type=str, nargs="+", default=None,
                        help="subset of the latent families to run "
                             f"(default: all of {DISTRIBUTIONS}; an "
                             "extension — the reference always runs all)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the GPU (raises without "
                             "one), 'cpu' runs the plain versions of the "
                             "kernels")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
