"""Export a checkpoint to a serving bundle (port of
``scripts/export_model.py``): ``manifest.json``, ``params.npz`` in the JAX
package's flat format and storage modes, and one ``torch.export``
program per function and platform (encode_mu / encode_z / decode, batch
symbolic), which ``cliffordtpu_torch.serving.load_serving`` runs without
the model code.  See ``cliffordtpu_torch/serving.py``.

    python -m cliffordtpu_torch.scripts.export_model \\
        --ckpt results/fashionmnist-clifford-d16-l1 --arch vit \\
        --distribution clifford --latent_dim 16 --img_size 32 \\
        --outdir serving/fashion_vit_d16

The checkpoint is one that the port's ``save_checkpoint`` wrote (the
runners' ``--keep_ckpts``).  Exporting runs on the card unless
``--device`` names another device; ``--platforms`` names the devices whose
programs the bundle holds (default ``cuda,cpu``).  ``--scan_layers``
and ``--fused_proj`` name the ViT's layouts (a checkpoint of the other
projection layout is converted); ``--data_parallel N`` writes a bundle
that splits each request's rows over N replicas (``load_serving``'s
``devices``).  ``--native`` also writes, for each of ``--platforms``, one
AOTInductor package per function at the fixed batch ``--native_batch``
(``<fn>.native.<platform>.pt2``) and the manifest's ``native`` section,
which the Python-free host ``cliffordtpu_torch/native/serve.cc`` serves
(``export_serving(native=True)``); it refuses ``--data_parallel`` > 1.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir (contains best_model.ckpt)")
    p.add_argument("--arch", required=True,
                   choices=["mlp", "cnn", "vit", "hybrid"])
    p.add_argument("--distribution", required=True)
    p.add_argument("--latent_dim", type=int, required=True)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--in_channels", type=int, default=1)
    p.add_argument("--l2_normalize", action="store_true")
    p.add_argument("--scan_layers", action="store_true",
                   help="the checkpoint's ViT is layer-stacked")
    p.add_argument("--fused_proj", action="store_true",
                   help="fused wqkv / w13 ViT projections")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated torch devices to export for")
    p.add_argument("--data_parallel", type=int, default=None,
                   help="N replicas, each request's rows split over them "
                        "(the symbolic batch a multiple of N)")
    p.add_argument("--params_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="storage format of params.npz (bfloat16 halves, "
                        "int8 quarters the artifact; weight-only, programs "
                        "unchanged, dequantized at load)")
    p.add_argument("--native", action="store_true",
                   help="also write AOTInductor packages at the fixed "
                        "--native_batch for the C++ serving host "
                        "(cliffordtpu_torch/native/serve.cc)")
    p.add_argument("--native_batch", type=int, default=8)
    p.add_argument("--outdir", required=True)
    p.add_argument("--device", default=None,
                   help="torch device that loads the checkpoint; default "
                        "the GPU (raises without one)")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.fused_proj and args.arch != "vit":
        p.error("--fused_proj only applies to --arch vit")

    from cliffordtpu_torch.device import resolve_device
    from cliffordtpu_torch.scripts.eval_checkpoint import build_model
    from cliffordtpu_torch.serving import export_serving
    from cliffordtpu_torch.train.checkpoint import (
        load_checkpoint,
        load_model_state,
    )

    device = resolve_device(args.device)
    model = build_model(args.arch, args.distribution, args.latent_dim,
                        args.in_channels, args.img_size, args.l2_normalize,
                        scan_layers=args.scan_layers,
                        fused_proj=args.fused_proj)
    ckpt = load_checkpoint(args.ckpt)
    if ckpt is None:
        print(f"error: no checkpoint in {args.ckpt}", file=sys.stderr)
        return 2
    load_model_state(model, ckpt)
    model.to(device)

    img_shape = (args.img_size, args.img_size, args.in_channels)
    res = export_serving(model, None, img_shape, out_dir=args.outdir,
                         platforms=tuple(args.platforms.split(",")),
                         data_parallel=args.data_parallel,
                         params_dtype=args.params_dtype,
                         native=args.native,
                         native_platforms=tuple(args.platforms.split(",")),
                         native_batch=args.native_batch)
    mani = res["manifest"]
    print(json.dumps({
        "outdir": args.outdir,
        "model_class": mani["model_class"],
        "distribution": mani["distribution"],
        "flat_z_dim": mani["flat_z_dim"],
        "platforms": mani["platforms"],
        "batch": {k: v["batch"] for k, v in mani["functions"].items()},
        **({"native_batch": mani["native"]["batch"],
            "native_compile_s": res["native_compile_s"]}
           if args.native else {}),
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
