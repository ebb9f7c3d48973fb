#!/usr/bin/env python3
"""Where a train step's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_train.py [--out-dir profiles]
        [--config flagship32|cnn4096|image256]
        [--distribution clifford|gaussian|powerspherical]

Builds the flagship32 ``CliffordARVAE`` (``default_config(32)``), with
``--config cnn4096`` the ``CNNVAE`` at latent 4096 (a clifford latent on
each of its three sampler routes), or with ``--config image256`` the
``CliffordARVAE`` of ``default_config(256)`` (batch 4, S 260: the dense
attention route), with the ``--distribution`` latent, seeded random
weights, in float32 and in bfloat16 compute, takes 3 warm-up AdamW steps
at batch 64 (lr 1e-4, clip 1), times 5 steps without the profiler, then
traces 5 more with ``torch.profiler``.  For each dtype it prints one JSON
line: the step's wall time without and with the profiler (host clock,
ends in a synchronise), the device's busy time (union of kernel intervals)
and idle share against the unprofiled wall time, kernel launches per step,
the launches per step of the port's kernels and its dense attention
calls (``attention.dense_calls``), and device time per step by kernel
class (attention forward and backward kernels, sampler and torus forward /
backward kernels, GEMM, convolution, norm, optimizer, other).  The full
per-kernel table goes to
``<out-dir>/profile_train_<config>[_<distribution>]_<dtype>[_<route>].txt``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from torch_profile_serving import busy_us, counts, kernel_events  # noqa

BATCH = 64
STEPS = 5  # timed, then traced, after 3 warm-up steps
CLASSES = (  # first match wins, on the lower-cased kernel name
    ("attention_bwd_kernel", ("attention_bwd_",)),
    ("attention_fwd_kernel", ("attention_fwd_",)),
    ("sampler_kernel", ("keyed_sample_embed", "rng_sample_embed")),
    ("torus_bwd_kernel", ("torus_bwd_kernel",)),
    ("torus_fwd_kernel", ("torus_fwd_",)),
    ("optimizer", ("adam", "multi_tensor", "foreach", "lpnorm")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit",
              "winograd", "nchw", "nhwc")),
    ("gemm", ("gemm", "nvjet", "cutlass", "matmul", "cublas", "splitk",
              "gemv")),
    ("norm", ("norm", "welford", "moments")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="profiles",
                    help="where the per-kernel tables go (relative paths "
                         "are taken from the repository root)")
    ap.add_argument("--config", default="flagship32",
                    choices=("flagship32", "cnn4096", "image256"))
    ap.add_argument("--distribution", default="clifford",
                    choices=("clifford", "gaussian", "powerspherical"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.nn.conv_vae import CNNVAE
    from cliffordtpu_torch.nn.vit_vae import CliffordARVAE
    from cliffordtpu_torch.train.loop import make_cnn_train_step
    from cliffordtpu_torch.train.state import create_train_state

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
    shape = ((4, 256, 256, 3) if args.config == "image256"
             else (BATCH, 32, 32, 1))
    x = torch.rand(*shape, generator=gen, device="cuda") * 2 - 1
    beta = torch.ones((), device="cuda")
    dist = args.distribution
    routes = (("keyed", "unfused", "rng")
              if args.config == "cnn4096" and dist == "clifford"
              else (None,))

    for dtype, route in ((dt, r) for dt in (torch.float32, torch.bfloat16)
                         for r in routes):
        if args.config == "cnn4096":
            model = CNNVAE(latent_dim=4096, in_channels=1, img_size=32,
                           distribution=dist, sampler=route,
                           compute_dtype=dtype, seed=0)
        elif args.config == "image256":
            model = CliffordARVAE(latent_dim=16, image_size=256,
                                  distribution=dist, compute_dtype=dtype,
                                  seed=0)
        else:
            model = CliffordARVAE(latent_dim=16, image_size=32,
                                  in_channels=1, distribution=dist,
                                  compute_dtype=dtype, seed=0)
        st = create_train_state(model, optimizer="adamw", lr=1e-4)
        step = make_cnn_train_step(st.model, st.optimizer)

        def timed_steps(first_key):
            walls = []
            for i in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(x, (0, first_key + i), beta)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            return walls

        for i in range(3):
            step(x, (0, i), beta)
        before = counts(attention, sampler, torus)
        plain_walls = timed_steps(10)
        after = counts(attention, sampler, torus)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_walls = timed_steps(20)
        events = kernel_events(prof)
        by_class = {}
        for e in events:
            c = classify(e.name)
            by_class[c] = by_class.get(c, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        wall = statistics.median(plain_walls)
        busy = busy_us(events) / 1e3 / STEPS
        tag = str(dtype).replace("torch.", "")
        name = (f"profile_train_{args.config}"
                + ("" if dist == "clifford" else f"_{dist}") + f"_{tag}"
                + (f"_{route}" if len(routes) > 1 else ""))
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
        print(json.dumps({
            "config": args.config, "distribution": dist, "dtype": tag,
            "sampler": route, "batch": x.shape[0], "steps": STEPS,
            "wall_ms_per_step": wall,
            "wall_ms_per_step_profiled": statistics.median(traced_walls),
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall if wall else None,
            "kernels_per_step": len(events) / STEPS,
            "port_launches_per_step": {k: (after[k] - before[k]) / STEPS
                                       for k in after},
            "device_ms_per_step_by_class": {
                k: v / STEPS for k, v in sorted(by_class.items())},
        }), flush=True)
        del st, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
