#!/usr/bin/env python3
"""Where a serving request's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_serving.py [--out-dir profiles]
        [--config flagship32|cnn4096]

Builds the flagship32 ``CliffordARVAE`` (``default_config(32)``) or, with
``--config cnn4096``, the ``CNNVAE`` at latent 4096 (``encode_z`` then once
per sampler route), seeded random weights, in float32 and in bfloat16
compute, warms each entry point up, then traces 5 batch-64 requests of each
with ``torch.profiler``.  For each (dtype, entry point) it prints one JSON line: the request's wall
time (host clock, ends in a synchronise), the device's busy time (union of
kernel intervals) and idle share, the launches per request of the port's
kernels and its dense attention calls, and device time by kernel class
(attention kernel, sampler and torus forward kernels, GEMM, convolution,
norm, other).  The full per-kernel table goes to
``<out-dir>/profile_<config>_<dtype>_<entry>.txt``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
REQUESTS = 5  # traced per (dtype, entry point), after 3 warm-up calls
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("attention_kernel", ("attention_fwd_",)),
    ("sampler_kernel", ("sample_embed_",)),
    ("torus_fwd_kernel", ("torus_fwd_",)),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "implicit", "winograd",
              "nchw", "nhwc")),
    ("gemm", ("gemm", "nvjet", "cutlass", "matmul", "cublas", "splitk")),
    ("norm", ("norm", "welford", "moments")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def counts(attention, sampler, torus):
    """The launch counts of the port's kernels and the dense attention
    route's calls."""
    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            "attention_dense": attention.dense_calls,
            "torus_fwd": torus.fwd_launches, "torus_bwd": torus.launches,
            "sampler_keyed": sampler.launches,
            "sampler_rng": sampler.rng_launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="profiles",
                    help="where the per-kernel tables go (relative paths "
                         "are taken from the repository root)")
    ap.add_argument("--config", default="flagship32",
                    choices=("flagship32", "cnn4096"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.nn.conv_vae import CNNVAE
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    build.build_all()
    out_dir = os.path.join(ROOT, args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(BATCH, 32, 32, 1, generator=gen, device="cuda") * 2 - 1
    for dtype in (torch.float32, torch.bfloat16):
        if args.config == "cnn4096":
            srv = serving.Serving(CNNVAE(
                latent_dim=4096, in_channels=1, img_size=32,
                compute_dtype=dtype, seed=0))
            routes = ("keyed", "unfused", "rng")
        else:
            srv = serving.Serving(CliffordARVAE(
                latent_dim=16, image_size=32, in_channels=1,
                compute_dtype=dtype, seed=0))
            routes = ("keyed",)
        z = srv.encode_z((0, 1), x)
        calls = {"encode_mu": lambda: srv.encode_mu(x),
                 **{"encode_z" + (f"_{r}" if len(routes) > 1 else ""):
                    (lambda r=r: srv.encode_z((0, 1), x, sampler=r))
                    for r in routes},
                 "decode": lambda: srv.decode(z)}
        for name, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            walls = []
            before = counts(attention, sampler, torus)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(REQUESTS):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            after = counts(attention, sampler, torus)
            events = kernel_events(prof)
            by_class = {}
            for e in events:
                c = classify(e.name)
                by_class[c] = by_class.get(c, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
            n = REQUESTS
            wall = sum(walls) / n
            busy = busy_us(events) / 1e3 / n
            tag = (f"{args.config}_{str(dtype).replace('torch.', '')}"
                   f"_{name}")
            with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=40))
            print(json.dumps({
                "config": args.config,
                "dtype": str(dtype).replace("torch.", ""), "entry": name,
                "batch": BATCH, "requests": n,
                "wall_ms_per_request": wall,
                "device_busy_ms_per_request": busy,
                "idle_share": 1.0 - busy / wall if wall else None,
                "kernels_per_request": len(events) / n,
                "port_launches_per_request": {
                    k: (after[k] - before[k]) / n for k in after},
                "device_ms_per_request_by_class": {
                    k: v / n for k, v in sorted(by_class.items())},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
