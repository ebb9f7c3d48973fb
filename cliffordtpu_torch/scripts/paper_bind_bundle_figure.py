"""Side-by-side pairwise bind / bundle figure from two trained
checkpoints, clifford against gaussian (port of
``scripts/paper_bind_bundle_figure.py``).

The checkpoints are the port's ``best_model.ckpt`` files that the runners
keep with ``--keep_ckpts`` (pass the experiment directory that holds
one).  Each model scores ``eval.binding.test_pairwise_bind_bundle_decode``
on the card (``--device cpu`` on the CPU); its grid is drawn into a
temporary directory and the two panels side by side on the host.

    python -m cliffordtpu_torch.scripts.paper_bind_bundle_figure \\
        --clifford_ckpt results/fashionmnist-clifford-d256-l1 \\
        --gaussian_ckpt results/fashionmnist-gaussian-d256-l1
"""

from __future__ import annotations

import argparse
import os
import tempfile

from cliffordtpu_torch.data import load_dataset
from cliffordtpu_torch.device import resolve_device
from cliffordtpu_torch.eval import ModelHandle
from cliffordtpu_torch.eval.binding import test_pairwise_bind_bundle_decode
from cliffordtpu_torch.nn.conv_vae import CNNVAE
from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
from cliffordtpu_torch.train.checkpoint import load_checkpoint
from cliffordtpu_torch.utils import CLASS_NAMES, pyplot

FASHIONMNIST_CLASSES = CLASS_NAMES["fashionmnist"]
CIFAR_CLASSES = CLASS_NAMES["cifar10"]


def load_model(ckpt_dir, distribution, latent_dim, arch, dataset,
               device=None):
    in_ch = 3 if dataset == "cifar10" else 1
    if arch == "hybrid":
        model = HybridVAE(latent_dim=latent_dim, in_channels=in_ch,
                          distribution=distribution, img_size=32)
    elif arch == "cnn":
        model = CNNVAE(latent_dim=latent_dim, in_channels=in_ch,
                       distribution=distribution, img_size=32)
    else:
        raise ValueError(f"unsupported arch: {arch}")
    ckpt = load_checkpoint(ckpt_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    model.load_state_dict(ckpt["model"])
    return ModelHandle(model.to(resolve_device(device)).eval())


def run_pairwise(handle, x, y, class_names, img_shape):
    """(the drawn grid as an image array or None, the mean cosine of the
    recovered latents)."""
    with tempfile.TemporaryDirectory() as tmpdir:
        result = test_pairwise_bind_bundle_decode(
            handle, x, y, tmpdir, img_shape=img_shape,
            class_names=class_names, key=(0, 0))
        path = result.get("plot_path")
        avg_sim = result.get("avg_unbind_similarity", 0.0)
        if path and os.path.exists(path):
            import matplotlib.image as mpimg

            return mpimg.imread(path), avg_sim
    return None, avg_sim


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--clifford_ckpt", required=True)
    parser.add_argument("--gaussian_ckpt", required=True)
    parser.add_argument("--dataset", default="fashionmnist",
                        choices=["fashionmnist", "cifar10"])
    parser.add_argument("--latent_dim", type=int, default=256)
    parser.add_argument("--arch", default="cnn", choices=["cnn", "hybrid"])
    parser.add_argument("--output", default="bind_bundle_comparison.png")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the GPU (raises "
                             "without one)")
    return parser


def panels(args):
    """[(label, image or None, mean unbind cosine)] of the two models."""
    ds = load_dataset(args.dataset, n_test=500)
    class_names = (FASHIONMNIST_CLASSES if args.dataset == "fashionmnist"
                   else CIFAR_CLASSES)
    in_ch = 3 if args.dataset == "cifar10" else 1
    img_shape = (32, 32, in_ch)
    out = []
    for label, ckpt, dist in [
        ("Clifford", args.clifford_ckpt, "clifford"),
        ("Gaussian", args.gaussian_ckpt, "gaussian"),
    ]:
        handle = load_model(ckpt, dist, args.latent_dim, args.arch,
                            args.dataset, args.device)
        img, sim = run_pairwise(handle, ds["x_test"], ds["y_test"],
                                class_names, img_shape)
        out.append((label, img, sim))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    result = panels(args)
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(16, 10))
    for ax, (label, img, sim) in zip(axes, result):
        if img is not None:
            ax.imshow(img)
        ax.set_title(f"{label} (avg unbind sim {sim:.3f})", fontsize=13)
        ax.axis("off")
    plt.suptitle("Pairwise Bind / Bundle / Unbind — Clifford vs Gaussian")
    plt.tight_layout()
    plt.savefig(args.output, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"saved to {args.output}")
    return result


if __name__ == "__main__":
    main()
