"""Standalone checkpoint evaluator (port of ``scripts/eval_checkpoint.py``):
the full eval battery on a model saved by the port's ``save_checkpoint``,
in a process of its own.

    python -m cliffordtpu_torch.scripts.eval_checkpoint --ckpt DIR \\
        --arch cnn --distribution clifford --latent_dim 4096 --outdir DIR

It runs on the card unless ``--device`` names another device (``--device
cpu``).  The CNN runner's ``--eval_subprocess`` delegates its battery
here.  Writes the runners' ``{metrics,vsa_raw}.json`` and plots, and
prints the kernels' launch counts as its last line.  A JAX
(orbax) checkpoint is refused with a pointer to ``state_from_jax``, which
carries one that the JAX package has restored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_model(arch: str, distribution: str, latent_dim: int,
                in_channels: int, img_size: int, l2_normalize: bool = False,
                scan_layers: bool = False, fused_proj: bool = False):
    """The JAX script's model per arch; ``scan_layers`` and ``fused_proj``
    give the ViT's layer-stacked and fused-projection layouts."""
    from cliffordtpu_torch.nn.conv_vae import CNNVAE
    from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
    from cliffordtpu_torch.nn.mlp_vae import MLPVAE
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    if arch == "mlp":
        return MLPVAE(128, latent_dim, distribution, l2_normalize)
    if arch == "cnn":
        return CNNVAE(latent_dim=latent_dim, in_channels=in_channels,
                      distribution=distribution, img_size=img_size,
                      l2_normalize=l2_normalize)
    if arch == "hybrid":
        return HybridVAE(latent_dim=max(4, latent_dim // 16),
                         in_channels=in_channels, distribution=distribution,
                         img_size=img_size, l2_normalize=l2_normalize)
    if arch == "vit":
        return CliffordARVAE(latent_dim=latent_dim, image_size=img_size,
                             in_channels=in_channels,
                             distribution=distribution,
                             l2_normalize=l2_normalize,
                             scan_layers=scan_layers, fused_proj=fused_proj)
    raise ValueError(arch)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True,
                   help="dir containing best_model.ckpt (save_checkpoint)")
    p.add_argument("--arch", required=True,
                   choices=["mlp", "cnn", "vit", "hybrid"])
    p.add_argument("--distribution", required=True)
    p.add_argument("--latent_dim", type=int, required=True)
    p.add_argument("--dataset", default="fashionmnist")
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--scan_layers", action="store_true",
                   help="the checkpoint's ViT is layer-stacked")
    p.add_argument("--fused_proj", action="store_true",
                   help="fused wqkv / w13 ViT projections (a checkpoint of "
                        "the other layout is converted)")
    p.add_argument("--outdir", required=True)
    p.add_argument("--vsa_trials", type=int, default=20)
    p.add_argument("--fid_samples", type=int, default=2048)
    p.add_argument("--limit_train", type=int, default=None)
    p.add_argument("--limit_test", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_plots", action="store_true")
    p.add_argument("--table_only", action="store_true",
                   help="run ONLY the across-dims-table feed (kNN + "
                        "mean-vector cosine): skip the VSA battery, "
                        "self-binding, FID, and plots")
    p.add_argument("--l2_normalize", action="store_true")
    p.add_argument("--rf_no_random_keys", action="store_true",
                   help="role-filler with roles drawn from the item memory "
                        "(the MNIST runners' variant) instead of random "
                        "unitary keys")
    # item-memory protocol: must match the calling runner's in-process
    # battery or the VSA metrics are not comparable
    p.add_argument("--item_memory", choices=["sampled", "means"],
                   default="sampled",
                   help="'sampled': flat sampled latents, n=1000, baselines "
                        "at the raw latent dim (CNN runners); 'means': "
                        "posterior means, n=500 (MNIST runners)")
    p.add_argument("--n_mem", type=int, default=None,
                   help="item-memory size cap (default: 1000 for sampled, "
                        "500 for means)")
    p.add_argument("--per_class_trials", type=int, default=None,
                   help="trials for the per-class bundle test (default: 1 "
                        "for sampled, 2 for means)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without "
                        "one), 'cpu' runs the plain versions of the "
                        "kernels")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.fused_proj and args.arch != "vit":
        p.error("--fused_proj only applies to --arch vit")

    from cliffordtpu_torch.data import load_dataset
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
    from cliffordtpu_torch.eval.fid import compute_fid
    from cliffordtpu_torch.eval.knn import perform_knn_evaluation
    from cliffordtpu_torch.eval.plots import plot_reconstructions
    from cliffordtpu_torch.kernels import launch_counts
    from cliffordtpu_torch.runners.safety import (
        EMPTY_BINDING,
        EMPTY_CURVE,
        safe_eval,
    )
    from cliffordtpu_torch.train.checkpoint import (
        load_checkpoint,
        load_model_state,
    )
    from cliffordtpu_torch.utils import CLASS_NAMES, ensure_dir
    from cliffordtpu_torch.utils.artifacts import jsonable
    from cliffordtpu_torch.vsa.capacity import (
        test_binding_unbinding_pairs,
        test_bundle_capacity,
        test_per_class_bundle_capacity_k_items,
    )

    device = resolve_device(args.device)
    in_channels = 3 if args.dataset == "cifar10" else 1
    img_shape = (args.img_size, args.img_size, in_channels)
    model = build_model(args.arch, args.distribution, args.latent_dim,
                        in_channels, args.img_size, args.l2_normalize,
                        scan_layers=args.scan_layers,
                        fused_proj=args.fused_proj)
    ckpt = load_checkpoint(args.ckpt)
    if ckpt is None:
        print(f"error: no checkpoint in {args.ckpt}", file=sys.stderr)
        return 2
    load_model_state(model, ckpt)
    handle = ModelHandle(model.to(device).eval())
    ds = load_dataset(args.dataset, n_train=args.limit_train,
                      n_test=args.limit_test)
    if args.arch == "mlp":
        x_train = ds["x_train"].reshape(len(ds["x_train"]), -1)
        x_test = ds["x_test"].reshape(len(ds["x_test"]), -1)
    else:
        x_train, x_test = ds["x_train"], ds["x_test"]
    y_train, y_test = ds["y_train"], ds["y_test"]
    # image-shaped test set: compute_fid and the per-class test's image
    # panel take images; the mlp arch keeps x_test flat for the rest
    x_test_img = x_test.reshape(len(x_test), args.img_size, args.img_size,
                                in_channels)
    class_names = CLASS_NAMES.get(args.dataset)

    outdir = ensure_dir(args.outdir)
    key = (0, args.seed)  # jax.random.PRNGKey(seed)

    use_means = args.item_memory == "means"
    n_mem = min(args.n_mem or (500 if use_means else 1000), len(x_test))
    per_class_trials = args.per_class_trials or (2 if use_means else 1)
    if args.table_only:
        item_memory, item_labels = None, None  # battery inputs, skipped
        baseline_d = per_class_d = 0
    elif use_means:
        item_memory = handle.latent_mu(x_test[:n_mem], key)
        item_labels = y_test[:n_mem]
        # means protocol: baselines live at the memory's own dimension
        baseline_d = int(item_memory.shape[-1])
        per_class_d = int(item_memory.shape[-1])
    else:
        item_memory, item_labels = handle.collect_flat_z(
            x_test, y_test, key, limit=n_mem)
        baseline_d = handle.latent_dim
        per_class_d = handle.latent_dim

    def heavy(label, fn, default=None):
        """Heavy battery stage: skipped entirely under --table_only."""
        if args.table_only:
            return default
        return safe_eval(label, fn, default)

    fourier_star = heavy(
        "self_binding(*)",
        lambda: test_self_binding(handle, x_test[:500], y_test[:500],
                                  outdir, unbind_method="*",
                                  img_shape=img_shape, key=key),
        default=dict(EMPTY_BINDING))
    deconv_dir = ensure_dir(os.path.join(outdir, "deconv"))
    fourier_perp = heavy(
        "self_binding(†)",
        lambda: test_self_binding(handle, x_test[:500], y_test[:500],
                                  deconv_dir, unbind_method="†",
                                  img_shape=img_shape, key=key),
        default=dict(EMPTY_BINDING))
    bundle_cap = heavy(
        "bundle_capacity",
        lambda: test_bundle_capacity(
            d=item_memory.shape[-1], n_items=n_mem,
            n_trials=args.vsa_trials, plot=not args.skip_plots,
            save_dir=outdir, item_memory=item_memory,
            baseline_d=baseline_d, key=key),
        default=dict(EMPTY_CURVE))
    role_filler = heavy(
        "role_filler",
        lambda: test_binding_unbinding_pairs(
            d=item_memory.shape[-1], n_items=n_mem,
            n_trials=args.vsa_trials, plot=not args.skip_plots,
            save_dir=outdir, item_memory=item_memory,
            bind_with_random=not args.rf_no_random_keys,
            baseline_d=baseline_d, key=key),
        default=dict(EMPTY_CURVE))
    heavy("per_class", lambda: test_per_class_bundle_capacity_k_items(
        d=per_class_d, n_items=n_mem, n_classes=10, items_per_class=1,
        n_trials=per_class_trials,
        plot=not args.skip_plots, save_dir=outdir, item_memory=item_memory,
        labels=item_labels,
        item_images=(x_test_img[:n_mem] * 2 - 1 if use_means
                     else x_test_img[:n_mem]),
        class_names=class_names, key=key))
    heavy("pairwise", lambda: test_pairwise_bind_bundle_decode(
        handle, x_test[:500], y_test[:500], outdir, img_shape=img_shape,
        class_names=class_names, key=key))
    heavy("cross_class", lambda: test_cross_class_bind_unbind(
        handle, x_test[:500], y_test[:500], outdir, img_shape=img_shape,
        class_a=5, class_b=6, key=key))
    knn = safe_eval("knn", lambda: perform_knn_evaluation(
        handle, x_train, y_train, x_test, y_test,
        [s for s in (100, 600, 1000) if s <= len(x_train)],
        backend="torch", key=key), default={})
    mvc = safe_eval("mean_vector_cosine", lambda: evaluate_mean_vector_cosine(
        handle, x_test, y_test,
        compute_class_means(handle, x_train[:5000], y_train[:5000], key=key),
        key=key)[0], default=0.0)
    fid_res = heavy("fid", lambda: compute_fid(
        handle, x_test_img, handle.distribution, handle.latent_dim,
        in_channels=in_channels,
        n_samples=min(args.fid_samples, len(x_test)), key=key),
        default={"fid": float("nan"),
                 "fid_features": ("table_only_skipped" if args.table_only
                                  else "failed")})
    if not args.skip_plots:
        heavy("reconstructions", lambda: plot_reconstructions(
            handle, x_test, os.path.join(outdir, "reconstructions.png"),
            img_shape=img_shape, key=key))

    summary = {
        **{k: v for k, v in knn.items() if k.startswith("knn_")},
        "mean_vector_cosine_acc": float(mvc),
        "generation_fid": fid_res["fid"],
        "fid_features": fid_res["fid_features"],
    }
    raw_vsa = {
        "bundle_cap": bundle_cap,
        "role_filler": role_filler,
        "self_binding_star": {
            "k_values": fourier_star.get("k_values", []),
            "k_sims": fourier_star.get("k_sims", []),
        },
        "self_binding_dagger": {
            "k_values": fourier_perp.get("k_values", []),
            "k_sims": fourier_perp.get("k_sims", []),
        },
    }
    with open(os.path.join(outdir, "metrics.json"), "w") as f:
        json.dump(jsonable(summary), f, indent=2)
    with open(os.path.join(outdir, "vsa_raw.json"), "w") as f:
        json.dump(jsonable(raw_vsa), f)
    print(f"wrote {outdir}/metrics.json and vsa_raw.json")
    print(f"kernel launches: {json.dumps(launch_counts())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
