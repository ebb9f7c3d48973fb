"""CIFAR-10 CNN VAE sweep (port of ``scripts/cifar10_train.py``: CNN
only, the slimmer eval without decoded bundles and interpolations; the
engine shared with the fashion runner).

    python -m cliffordtpu_torch.scripts.cifar10_train --latent_dims 4096 \\
        --distributions clifford --epochs 1 --no_wandb

runs on the card; ``--device cpu`` runs on the CPU.  ``--mesh`` and
``--mesh_mode`` train on a ("data", "model") mesh (``torchrun
--nproc_per_node N`` for N cards, none needed at a world of 1) as the
fashion runner does."""

from __future__ import annotations

import argparse

from cliffordtpu_torch.runners.cnn_runner import run_cnn_experiments


def build_parser():
    p = argparse.ArgumentParser(
        description="cifar-10 VAE experiments with cliffordAR S-VAE + "
                    "baselines")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--require_real", action="store_true",
                   help="abort instead of training on the synthetic "
                        "fallback when no real dataset files are found")
    p.add_argument("--warmup_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--no-l2_norm", dest="l2_norm", action="store_false")
    p.set_defaults(l2_norm=True)
    p.add_argument("--recon_loss", type=str, default="l1",
                   choices=["mse", "l1"])
    p.add_argument("--l1_weight", type=float, default=1.0)
    p.add_argument("--max_beta", type=float, default=1.0)
    p.add_argument("--min_beta", type=float, default=0.1)
    p.add_argument("--use_learnable_beta", action="store_true")
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--keep_ckpts", action="store_true")
    p.add_argument("--wandb_project", type=str,
                   default="clifford-experiments-CNN-cifar10")
    p.add_argument("--patience", type=int, default=50)
    p.add_argument("--cycle_epochs", type=int, default=250)
    p.add_argument("--n_trials", type=int, default=30)
    p.add_argument("--exclude_class", type=int, default=-1)
    p.add_argument("--latent_dims", type=int, nargs="+",
                   default=[128, 256, 512, 1024, 2048, 4096])
    p.add_argument("--distributions", type=str, nargs="+", default=None)
    p.add_argument("--start_trial", type=int, default=1)
    # extensions (defaults preserve reference behavior)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit_train", type=int, default=None)
    p.add_argument("--limit_test", type=int, default=None)
    p.add_argument("--vsa_trials", type=int, default=20)
    p.add_argument("--iwae_samples", type=int, default=0,
                   help="if > 0, also report an IWAE-K test log-likelihood "
                        "bound")
    p.add_argument("--fid_samples", type=int, default=2048)
    p.add_argument("--eval_subprocess", action="store_true",
                   help="run the eval battery in the port's eval_checkpoint "
                        "in a fresh process, on the same device")
    p.add_argument("--mesh", type=str, default=None,
                   help="train on a (data, model) mesh: dp | N | NxM "
                        "(one rank per process; torchrun for more than 1)")
    p.add_argument("--mesh_mode", type=str, default="replicated",
                   choices=["replicated", "fsdp"],
                   help="replicated (DDP) or fsdp (FSDP2) over the data "
                        "axis")
    p.add_argument("--scan_layers", dest="scan_layers_model",
                   action="store_true",
                   help="layer-stacked ViT blocks (identical math; another "
                        "param tree)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate (average) gradients over N microbatch "
                        "steps before each optimizer update (effective "
                        "batch = N x batch_size; optax.MultiSteps)")
    p.add_argument("--scan_epochs", action="store_true",
                   help="accepted as in JAX; no effect here: the epoch runs "
                        "the same per-step loop either way")
    p.add_argument("--force_trial_suffix", action="store_true",
                   help="always append -trial{n} to artifact names")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the GPU (raises without "
                        "one), 'cpu' runs the plain versions of the "
                        "kernels")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.distributions is None:
        args.distributions = ["clifford", "powerspherical", "gaussian"]
    args.arch = "cnn"  # the cifar10 runner is CNN-only
    run_cnn_experiments(args, "cifar10", "cifar10_train", full_eval=False)


if __name__ == "__main__":
    main()
