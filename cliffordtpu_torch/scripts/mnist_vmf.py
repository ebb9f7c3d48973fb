"""vMF-VAE MNIST runner (port of ``scripts/mnist_vmf.py``: the same flags,
defaults, keys and artifacts; what it shares with the clifford /
powerspherical / gaussian runner lives in
``cliffordtpu_torch/runners/mnist_runner.py``).

    CLIFFORDTPU_DATA_DIR=$PWD/tests/data python -m \\
        cliffordtpu_torch.scripts.mnist_vmf --d_dims 5 --n_runs 2 \\
        --epochs 2 --vmap_trials --no_wandb --outdir /tmp/out

runs on the card; ``--device cpu`` runs on the CPU.  The vMF runner's own
rules: z_dim = d + 1 (vMF in R^{d+1}), lr 3e-4 and batch 64 by default,
run keys ``fold_in(PRNGKey(seed), d * 1000 + r)``, test metrics at batch
1024, four role-filler variants, ``--simple`` skips the battery and the
per-trial dumps.  Writes ``visualizations/d_{d}/vmf/*``,
``results/mnist-vmf-d{d}-l1-trial{n}/{vsa_raw,metrics}.json``,
``mnist_vmf_results.csv`` (this invocation's dims) and
``mnist_vmf_timing.json`` (overwritten) relative to ``--outdir``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

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
    plot_interpolations,
    plot_latent_space,
    plot_reconstructions,
)
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
from cliffordtpu_torch.utils import WandbLogger, ensure_dir, \
    get_default_device
from cliffordtpu_torch.vsa.capacity import (
    test_binding_unbinding_pairs as vsa_binding_unbinding,
    test_bundle_capacity as vsa_bundle_capacity,
)


def run_key(seed: int, d_manifold: int, r: int):
    """``fold_in(PRNGKey(seed), d * 1000 + r)`` as two words."""
    return random.fold_in_words((0, seed), d_manifold * 1000 + r)


def results_row(d_manifold, agg_results, agg_f1, agg_mvc, agg_metrics):
    """One row of ``mnist_vmf_results.csv``: mean ± std over the trials
    (kNN and mean-vector cosine in percent), "N/A" where none ran."""
    row = {"d": d_manifold}
    for n in KNN_SAMPLES:
        accs, f1s = agg_results[n], agg_f1[n]
        row[f"vMF_acc_{n}"] = mean_std(accs, 100, 1) if accs else "N/A"
        row[f"vMF_f1_{n}"] = mean_std(f1s, 100, 1) if f1s else "N/A"
    row["vMF_mvc"] = mean_std(agg_mvc, 100, 1) if agg_mvc else "N/A"
    for m in ["ll", "entropy", "recon", "kl"]:
        vals = agg_metrics[m]
        row[f"vMF_{m}"] = mean_std(vals, 1, 2) if vals else "N/A"
    return row


def run(args):
    script_start_time = time.time()
    timing_results = {}
    device = resolve_device(getattr(args, "device", None))
    os.chdir(ensure_dir(args.outdir))
    print(f"using device: {get_default_device(device)}")

    data = load_mnist(args)
    if data["source"] == "synthetic":
        print("WARNING: synthetic MNIST fallback in use")
    x_train, y_train = data["x_train"], data["y_train"]
    x_test, y_test = data["x_test"], data["y_test"]
    logger = WandbLogger(args)
    final_results = []

    for d_manifold in args.d_dims:
        print(f"\n{'=' * 30}\n== vmf d={d_manifold} ==\n{'=' * 30}")
        model_z_dim = d_manifold + 1  # vmf in R^(d+1)
        agg_results = {s: [] for s in KNN_SAMPLES}
        agg_f1 = {s: [] for s in KNN_SAMPLES}
        agg_metrics = {"ll": [], "entropy": [], "recon": [], "kl": []}
        agg_mvc = []

        def make_model(seed):
            return MLPVAE(args.h_dim, model_z_dim, "vmf", seed=seed)

        # batched-trial training (see mnist_clifpws --vmap_trials)
        lanes = None
        if getattr(args, "vmap_trials", False) and args.n_runs > 1:
            lanes = train_lanes(
                args, make_model, [run_key(args.seed, d_manifold, r)
                                   for r in range(args.n_runs)],
                data, logger, device)

        for run_idx in range(args.n_runs):
            print(f"\n--- run {run_idx + 1}/{args.n_runs} ---")
            run_start_time = time.time()
            rkey = run_key(args.seed, d_manifold, run_idx)
            if logger.use:
                logger.start_run(f"vmf-d{d_manifold}-run{run_idx + 1}", args)

            state, history, train_time = train_trial(
                args, make_model, rkey, data, logger, device, lanes, run_idx)
            model = state.model
            best_val_loss = history["best_val"]
            print(f"training time: {train_time:.2f}s")

            eval_start_time = time.time()
            vis_dir = ensure_dir(f"visualizations/d_{d_manifold}/vmf")
            did_sub, sub_metrics, sub_vsa = False, {}, {}
            if getattr(args, "eval_subprocess", False) and not args.simple:
                did_sub, sub_metrics, sub_vsa = run_eval_child(
                    state, vis_dir, child_argv(
                        args, vis_dir, distribution="vmf",
                        latent_dim=model_z_dim, l2_normalize=False))

            def stage(label, fn, default=None):
                if did_sub:
                    return default
                return safe_eval(label, fn, default)

            handle = ModelHandle(model)
            ekey = random.fold_in_words(rkey, 2)

            test_metrics = safe_eval(
                "compute_test_metrics",
                lambda: compute_test_metrics(
                    ekey, model, batches(x_test, y_test, 1024)),
                default=NAN_METRICS)
            for m in ["ll", "entropy", "recon", "kl"]:
                agg_metrics[m].append(test_metrics[m])
            print(f"  LL={test_metrics['ll']:.2f}  "
                  f"L[q]={test_metrics['entropy']:.2f}  "
                  f"RE={test_metrics['recon']:.2f}  "
                  f"KL={test_metrics['kl']:.2f}")

            knn_results = stage(
                "knn_evaluation",
                lambda: perform_knn_evaluation(
                    handle, x_train, y_train, x_test, y_test,
                    [s for s in KNN_SAMPLES if s <= len(x_train)],
                    backend="torch", key=ekey),
                default={})
            if did_sub:
                knn_results = {k: v for k, v in sub_metrics.items()
                               if k.startswith("knn_")}
            for n in KNN_SAMPLES:
                if f"knn_acc_{n}" in knn_results:
                    agg_results[n].append(knn_results[f"knn_acc_{n}"])
                    agg_f1[n].append(knn_results[f"knn_f1_{n}"])

            if not args.simple:
                deconv_dir = ensure_dir(f"{vis_dir}/deconv")
                x_sub, y_sub = x_test[:500], y_test[:500]

                self_bind = stage(
                    "self_binding(*)",
                    lambda: test_self_binding(
                        handle, x_sub, y_sub, vis_dir, unbind_method="*",
                        key=ekey),
                    default=dict(EMPTY_BINDING))
                self_bind_deconv = stage(
                    "self_binding(†)",
                    lambda: test_self_binding(
                        handle, x_sub, y_sub, deconv_dir, unbind_method="†",
                        key=ekey),
                    default=dict(EMPTY_BINDING))

                n_mem = min(500, len(x_test))
                item_memory = stage(
                    "item_memory",
                    lambda: handle.latent_mu(x_test[:n_mem], ekey))

                bundle_cap_raw = stage(
                    "bundle_capacity",
                    lambda: vsa_bundle_capacity(
                        d=item_memory.shape[-1], n_items=n_mem,
                        k_range=list(range(5, 51, 5)),
                        n_trials=args.vsa_trials, plot=True,
                        save_dir=vis_dir, item_memory=item_memory, key=ekey),
                    default=dict(EMPTY_CURVE))

                rf_variants = [
                    (True, "*", vis_dir, "role_filler_capacity"),
                    (False, "*", vis_dir, "role_filler_no_random_keys"),
                    (True, "†", deconv_dir, "role_filler_capacity_deconv"),
                    (False, "†", deconv_dir,
                     "role_filler_no_random_keys_deconv"),
                ]
                rf_results = {}
                for bind_rand, ubmethod, save_d, rf_name in rf_variants:
                    rf_res = stage(
                        f"role_filler({rf_name})",
                        lambda ub=ubmethod, sd=save_d, br=bind_rand:
                            vsa_binding_unbinding(
                                d=item_memory.shape[-1], n_items=n_mem,
                                k_range=list(range(2, 21, 2)),
                                n_trials=args.vsa_trials, plot=True,
                                unbind_method=ub, save_dir=sd,
                                item_memory=item_memory,
                                bind_with_random=br, key=ekey),
                        default=dict(EMPTY_CURVE))
                    rf_results[rf_name] = rf_res
                    default_plot = os.path.join(save_d,
                                                "role_filler_capacity.png")
                    if (os.path.exists(default_plot)
                            and rf_name != "role_filler_capacity"):
                        os.rename(default_plot,
                                  os.path.join(save_d, f"{rf_name}.png"))

                stage("pairwise_bind_bundle",
                      lambda: test_pairwise_bind_bundle_decode(
                          handle, x_sub, y_sub, vis_dir,
                          img_shape=(28, 28, 1),
                          class_names=[str(i) for i in range(10)],
                          key=ekey))
                stage("cross_class_bind_unbind",
                      lambda: test_cross_class_bind_unbind(
                          handle, x_sub, y_sub, vis_dir,
                          img_shape=(28, 28, 1), class_a=6, class_b=9,
                          key=ekey))

                stage("reconstructions", lambda: plot_reconstructions(
                    handle, x_test,
                    os.path.join(vis_dir, "reconstructions.png"), key=ekey))
                stage("interpolations", lambda: plot_interpolations(
                    handle, x_test, y_test,
                    os.path.join(vis_dir, "interpolations.png"), key=ekey))
                stage("tsne", lambda: plot_latent_space(
                    handle, x_test, y_test,
                    os.path.join(vis_dir, "tsne.png"),
                    n_plot=min(1000, len(x_test)), key=ekey))

                mean_vector_acc = stage(
                    "mean_vector_cosine",
                    lambda: evaluate_mean_vector_cosine(
                        handle, x_test, y_test,
                        compute_class_means(
                            handle, x_train[:5000], y_train[:5000],
                            max_per_class=1000, key=ekey),
                        key=ekey)[0],
                    default=0.0)
                if not did_sub:
                    print(f"  mean vector cosine acc: "
                          f"{mean_vector_acc:.4f}")
                    agg_mvc.append(float(mean_vector_acc))

                if did_sub:
                    (bundle_cap_raw, role_filler, self_bind,
                     self_bind_deconv) = merge_child_battery(sub_vsa)
                    rf_results = {"role_filler_no_random_keys": role_filler}
                    mean_vector_acc = sub_metrics.get(
                        "mean_vector_cosine_acc", 0.0)
                    agg_mvc.append(float(mean_vector_acc))
                write_trial(
                    f"results/mnist-vmf-d{d_manifold}-l1-trial{run_idx + 1}",
                    bundle_cap=bundle_cap_raw,
                    role_filler=rf_results.get("role_filler_no_random_keys",
                                               {}),
                    star=self_bind, dagger=self_bind_deconv,
                    knn_results=knn_results,
                    mean_vector_acc=mean_vector_acc,
                    test_metrics=test_metrics, best_val_loss=best_val_loss)

            if logger.use:
                logger.log_summary({
                    **{k: v for k, v in knn_results.items()
                       if k.startswith("knn_")},
                    "test/ll": test_metrics["ll"],
                    "test/entropy": test_metrics["entropy"],
                    "test/recon": test_metrics["recon"],
                    "test/kl": test_metrics["kl"],
                })
                logger.finish_run()

            eval_time = time.time() - eval_start_time
            run_time = time.time() - run_start_time
            timing_results[f"vmf_d{d_manifold}_run{run_idx + 1}"] = {
                "train_time_s": train_time,
                "eval_time_s": eval_time,
                "total_run_time_s": run_time,
            }
            print(f"eval time: {eval_time:.2f}s, total: {run_time:.2f}s")
        del lanes

        final_results.append(results_row(d_manifold, agg_results, agg_f1,
                                         agg_mvc, agg_metrics))

    if final_results:
        print_results(final_results, "mnist_vmf_results.csv")

    timing_results["total_script_time_s"] = time.time() - script_start_time
    with open("mnist_vmf_timing.json", "w") as f:
        json.dump(timing_results, f, indent=2)
    print(f"\ntotal script time: {timing_results['total_script_time_s']:.2f}s")


def build_parser():
    parser = argparse.ArgumentParser(
        description="vMF-VAE on MNIST — minimal table runner")
    parser.add_argument("--d_dims", type=int, nargs="+",
                        default=[2, 5, 10, 20, 40])
    parser.add_argument("--h_dim", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--patience", type=int, default=50)
    parser.add_argument("--warmup_epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--n_runs", type=int, default=1)
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str, default="mnist-vmf")
    parser.add_argument("--simple", action="store_true")
    # extensions (defaults preserve reference behavior)
    parser.add_argument("--outdir", type=str, default=".")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit_train", type=int, default=None)
    parser.add_argument("--limit_test", type=int, default=None)
    parser.add_argument("--vsa_trials", type=int, default=20)
    parser.add_argument("--eval_subprocess", action="store_true")
    parser.add_argument("--scan_epochs", action="store_true",
                        help="accepted as in JAX; no effect here")
    parser.add_argument("--vmap_trials", action="store_true",
                        help="train all n_runs trials simultaneously with "
                             "fit_trials (see mnist_clifpws)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the GPU (raises without "
                             "one), 'cpu' runs on the CPU")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
