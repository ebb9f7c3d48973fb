#!/usr/bin/env python3
"""Where a train step's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_profile_train.py [--out-dir profiles]
        [--config flagship32|cnn4096|image256|hybrid_fashion4096|mnist_mlp|
                  runner_fashion4096]
        [--distribution clifford|gaussian|powerspherical|normal]

Builds the flagship32 ``CliffordARVAE`` (``default_config(32)``), with
``--config cnn4096`` the ``CNNVAE`` at latent 4096 (a clifford latent on
each of its three sampler routes), or with ``--config image256`` the
``CliffordARVAE`` of ``default_config(256)`` (batch 4, S 260: the
key-tiled forms of kernels A and B), or with ``--config hybrid_fashion4096`` the Fashion
runner's ``HybridVAE`` at latent 256 per token (64 tokens, batch 256,
AdamW lr 1e-3, float32 only), or with ``--config runner_fashion4096`` the
Fashion runner's ``CNNVAE`` at latent 4096 as ``cnn_runner.build_model``
makes it from ``fashion_train``'s defaults (l1 reconstruction, batch 256,
AdamW at its lr 1e-3, beta 0.1, float32 only: the step of chip_smoke's
``runner_step``), with the ``--distribution`` latent, seeded random
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

``--config mnist_mlp`` is the MNIST sweep's ``MLPVAE`` at d 5 (h_dim 128,
float32, Adam lr 1e-3, clip 1, batch 128, binarised synthetic images,
beta 0.01 as the runner's warmup starts), clifford or, with
``--distribution normal``, the normal latent with ``l2_normalize``: the
same lines for its train step, then one more for an epoch of
``fit_trials`` with 20 lanes (2048 training and 512 validation images),
whose numbers are per epoch (``wall_ms_per_epoch`` ...).
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
    ("sampler_kernel", ("sample_embed_",)),
    ("torus_bwd_kernel", ("torus_bwd_",)),
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


def by_kernel_class(events):
    """Device ms of the traced kernels, summed by ``classify``."""
    out = {}
    for e in events:
        c = classify(e.name)
        out[c] = out.get(c, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


MLP_BATCH, MLP_D, MLP_BETA = 128, 5, 0.01
MLP_TRAIN, MLP_VAL, MLP_TRIALS = 2048, 512, 20  # the runner's 20 trials


def report(name, out_dir, prof, events, walls, traced_walls, n, unit,
           launches, **fields):
    """Write the per-kernel table and print one JSON line per ``unit``
    (a step or an epoch) of ``n`` traced units."""
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    wall = statistics.median(walls)
    busy = busy_us(events) / 1e3 / n
    print(json.dumps({
        **fields, f"wall_ms_per_{unit}": wall,
        f"wall_ms_per_{unit}_profiled": statistics.median(traced_walls),
        f"device_busy_ms_per_{unit}": busy,
        "idle_share": 1.0 - busy / wall if wall else None,
        f"kernels_per_{unit}": len(events) / n,
        f"port_launches_per_{unit}": launches,
        f"device_ms_per_{unit}_by_class": {
            k: v / n for k, v in sorted(by_kernel_class(events).items())},
    }), flush=True)


def profile_mnist(args, out_dir, gen) -> int:
    """The mnist_mlp cell: the MLPVAE train step, then a fit_trials epoch."""
    from cliffordtpu_torch.kernels import attention, sampler, torus
    from cliffordtpu_torch.nn.mlp_vae import MLPVAE
    from cliffordtpu_torch.train import loop
    from cliffordtpu_torch.train.state import create_train_state

    dist = args.distribution
    images = torch.rand(MLP_TRAIN + MLP_VAL, 784, generator=gen,
                        device="cuda")
    x = images[:MLP_BATCH]
    beta = torch.full((), MLP_BETA, device="cuda")

    def model(seed=0):
        return MLPVAE(128, MLP_D, dist, dist == "normal", seed=seed)

    st = create_train_state(model(), optimizer="adam", lr=1e-3)
    step = loop.make_mlp_train_step(st.model, st.optimizer)

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
    walls = timed_steps(10)
    after = counts(attention, sampler, torus)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = timed_steps(20)
    report(f"profile_train_mnist_mlp_{dist}", out_dir, prof,
           kernel_events(prof), walls, traced, STEPS, "step",
           {k: (after[k] - before[k]) / STEPS for k in after},
           config="mnist_mlp", distribution=dist, dtype="float32",
           batch=MLP_BATCH, d=MLP_D, steps=STEPS)

    T = MLP_TRIALS
    lanes = loop.stack_trial_states([
        create_train_state(model(t), optimizer="adam", lr=1e-3)
        for t in range(T)])
    x_train, x_val = images[:MLP_TRAIN], images[MLP_TRAIN:]

    def epochs(first_key, n=2):
        walls = []
        for e in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.fit_trials(lanes, [(first_key + e, t) for t in range(T)],
                            x_train, x_val, epochs=1, batch_size=MLP_BATCH,
                            beta_fn=lambda _: MLP_BETA)
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    epochs(0, 1)
    before = counts(attention, sampler, torus)
    walls = epochs(10)
    after = counts(attention, sampler, torus)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = epochs(20)
    report(f"profile_train_mnist_mlp_{dist}_trials{T}", out_dir, prof,
           kernel_events(prof), walls, traced, 2, "epoch",
           {k: (after[k] - before[k]) / 2 for k in after},
           config="mnist_mlp", distribution=dist, dtype="float32",
           batch=MLP_BATCH, d=MLP_D, trials=T, train=MLP_TRAIN,
           val=MLP_VAL, steps_per_epoch=MLP_TRAIN // MLP_BATCH)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="profiles",
                    help="where the per-kernel tables go (relative paths "
                         "are taken from the repository root)")
    ap.add_argument("--config", default="flagship32",
                    choices=("flagship32", "cnn4096", "image256",
                             "hybrid_fashion4096", "mnist_mlp",
                             "runner_fashion4096"))
    ap.add_argument("--distribution", default="clifford",
                    choices=("clifford", "gaussian", "powerspherical",
                             "normal"))
    args = ap.parse_args()
    mlp = args.config == "mnist_mlp"
    if (mlp and args.distribution not in ("clifford", "normal")
            or not mlp and args.distribution == "normal"):
        ap.error("mnist_mlp takes clifford or normal; normal is the MLP's")
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.nn.conv_vae import CNNVAE
    from cliffordtpu_torch.nn.hybrid_vae import HybridVAE
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
    if args.config == "mnist_mlp":
        return profile_mnist(args, out_dir, gen)
    hybrid = args.config == "hybrid_fashion4096"
    runner = args.config == "runner_fashion4096"
    shape = ((4, 256, 256, 3) if args.config == "image256"
             else (256 if hybrid or runner else BATCH, 32, 32, 1))
    x = torch.rand(*shape, generator=gen, device="cuda") * 2 - 1
    beta = torch.full((), 0.1 if runner else 1.0, device="cuda")
    dist = args.distribution
    routes = (("keyed", "unfused", "rng")
              if args.config == "cnn4096" and dist == "clifford"
              else (None,))

    dtypes = ((torch.float32,) if hybrid or runner
              else (torch.float32, torch.bfloat16))
    for dtype, route in ((dt, r) for dt in dtypes for r in routes):
        lr = 1e-3 if hybrid else 1e-4
        if runner:
            from cliffordtpu_torch.runners import cnn_runner
            from cliffordtpu_torch.scripts import fashion_train

            rargs = fashion_train.build_parser().parse_args(
                ["--dataset", "mnist32", "--arch", "cnn", "--batch_size",
                 str(x.shape[0])])
            model = cnn_runner.build_model(rargs, dist, 4096, 1, seed=0)
            lr = rargs.lr
        elif hybrid:
            model = HybridVAE(latent_dim=256, in_channels=1, img_size=32,
                              distribution=dist, seed=0)
        elif args.config == "cnn4096":
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
        st = create_train_state(model, optimizer="adamw", lr=lr)
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
        tag = str(dtype).replace("torch.", "")
        name = (f"profile_train_{args.config}"
                + ("" if dist == "clifford" else f"_{dist}") + f"_{tag}"
                + (f"_{route}" if len(routes) > 1 else ""))
        report(name, out_dir, prof, kernel_events(prof), plain_walls,
               traced_walls, STEPS, "step",
               {k: (after[k] - before[k]) / STEPS for k in after},
               config=args.config, distribution=dist, dtype=tag,
               sampler=route, batch=x.shape[0], steps=STEPS)
        del st, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
