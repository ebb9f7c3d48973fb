#!/usr/bin/env python3
"""Check and time CUDA kernels of the PyTorch port at given shapes, on one
GPU.

    python3 scripts/torch_kernel_times.py [--shapes 64x4096,4096x16]
                                          [--kernels attention_fwd,torus_fwd]
                                          [--attention 64x68x8x64]
                                          [--root OTHER_CHECKOUT]
                                          [--tiled | --whole]

For every kernel named it runs ``chip_smoke.py``'s own case for that kernel
(the kernel held against its plain PyTorch version, then the device times
of the kernel, the plain version and the library forms, and the bound) and
prints its result as one JSON line.  The torus-family kernels run at every
shape R x d: ``torus_fwd``, ``torus_bwd`` (without the concentration
epilogue), ``sampler_bwd`` (with it), ``sampler_keyed`` and ``sampler_rng``
(one kappa per row).  ``attention_fwd`` and ``attention_bwd`` run in
float32, then bfloat16, at every ``--attention`` shape B x S x H x hd
(default the flagship's: B 64, S 68, 8 heads of 64), with the 2-D RoPE
tables of S - 4 patch tokens and 4 registers (S - 4 a square), or without
RoPE after ``/norope``.  ``--tiled`` times A and B in their key-tiled
forms whatever form the route gives the shape (A with its log-sum-exp, as
under autograd; B from it); ``--whole`` times them in their
whole-sequence forms, where the block fits an SM, whatever the route
gives.
The first line names the card and its power limit as ``nvidia-smi`` gives
them.

``--root`` takes the package from another checkout of this repository (an
earlier commit unpacked into a git-ignored directory), so that two versions
of a kernel are timed in one call on one card; the cases and the timing
code stay this checkout's, so name only kernels that the other checkout
has.  Exits non-zero when an output disagrees.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

ATTENTION = {"attention_fwd": chip_smoke.attention_case,
             "attention_bwd": chip_smoke.attention_bwd_case}
KERNELS = (*ATTENTION, "torus_fwd", "torus_bwd", "sampler_bwd",
           "sampler_keyed", "sampler_rng")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="64x4096,4096x16",
                    help="comma-separated R x d (rows x latent dim)")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--attention", default="64x68x8x64",
                    help="comma-separated B x S x H x hd[/norope]")
    ap.add_argument("--root", default=ROOT,
                    help="checkout to import cliffordtpu_torch from")
    form = ap.add_mutually_exclusive_group()
    form.add_argument("--tiled", action="store_true",
                      help="time A and B in their key-tiled forms")
    form.add_argument("--whole", action="store_true",
                      help="time A and B in their whole-sequence forms")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.ops import rope
    from cliffordtpu_torch.ops import torus as ops_torus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "root": os.path.abspath(args.root),
                      "build_s": build.build_all()}), flush=True)
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(0)
    cases = {
        "torus_fwd": lambda R, d: chip_smoke.torus_fwd_case(
            torus, ops_torus, R, d, gen),
        "torus_bwd": lambda R, d: chip_smoke.torus_bwd_case(
            torus, sampler, ops_torus, R, d, False, gen),
        "sampler_bwd": lambda R, d: chip_smoke.torus_bwd_case(
            torus, sampler, ops_torus, R, d, True, gen),
        "sampler_keyed": lambda R, d: chip_smoke.sampler_case(
            sampler, "keyed", R, d, True, gen),
        "sampler_rng": lambda R, d: chip_smoke.sampler_case(
            sampler, "rng", R, d, True, gen),
    }
    names = args.kernels.split(",")
    for spec in args.attention.split(","):
        shape, _, opt = spec.partition("/")
        B, S, H, hd = (int(s) for s in shape.split("x"))
        for name in (n for n in names if n in ATTENTION):
            for dtype in (torch.float32, torch.bfloat16):
                form = {"tiled": args.tiled}
                if args.whole:
                    size = (attention.smem_bytes if name == "attention_fwd"
                            else attention.bwd_smem_bytes)
                    if size(S, hd, dtype) > attention._SMEM_MAX:
                        continue
                    form = {"whole": True}
                case = ATTENTION[name](attention, rope, B, S, H, hd, dtype,
                                       opt != "norope", gen, **form)
                print(json.dumps({"kernel": name, **case}), flush=True)
    for shape in args.shapes.split(","):
        R, d = (int(s) for s in shape.split("x"))
        for name in names:
            if name not in ATTENTION:
                print(json.dumps({"kernel": name, **cases[name](R, d)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
