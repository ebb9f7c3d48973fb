#!/usr/bin/env python3
"""Train-step throughput of the PyTorch port on one GPU: the counterpart
of ``bench.py --config flagship32`` and ``--config cnn4096``.

    python3 scripts/torch_bench_train.py [--config flagship32|cnn4096]
        [--dtype bfloat16|float32] [--sampler keyed|unfused|rng]

Builds the flagship32 ``CliffordARVAE`` (``default_config(32)``: 32 px,
1 channel, latent 16) or the cnn4096 ``CNNVAE`` (32 px, 1 channel, latent
4096), seeded random weights, batch 64, AdamW at lr 1e-4 behind a
global-norm clip of 1, beta 1, the reparameterised draw through the named
sampler route.  After 3 warm-up steps it times 3
windows of 30 steps on one fixed batch (a new sampling key every step);
each window ends in ``torch.cuda.synchronize()``.  Prints one JSON line:
steps per second (the median window, with all three windows and the best
beside it), ms per step, the launch counts of the hand-written kernels per
step, the last loss, and the card's name and power limit as ``nvidia-smi``
gives them.  Raises without a CUDA device.  Imports nothing of JAX.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64
WARMUP_STEPS = 3
MEASURE_STEPS = 30
N_WINDOWS = 3
LR = 1e-4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="flagship32",
                    choices=("flagship32", "cnn4096"))
    ap.add_argument("--sampler", default="keyed",
                    choices=("keyed", "unfused", "rng"),
                    help="route of the reparameterised draw")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="compute dtype of the convolution stacks and the "
                         "transformer projections (parameters stay float32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_bench_train needs a CUDA device")
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
    t0 = time.perf_counter()
    build.build_all()
    dtype = getattr(torch, args.dtype)
    if args.config == "cnn4096":
        model = CNNVAE(latent_dim=4096, in_channels=1, img_size=32,
                       sampler=args.sampler, compute_dtype=dtype, seed=0)
    else:
        model = CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                              sampler=args.sampler, compute_dtype=dtype,
                              seed=0)
    st = create_train_state(model, optimizer="adamw", lr=LR)
    step = make_cnn_train_step(st.model, st.optimizer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(BATCH, 32, 32, 1, generator=gen, device="cuda") * 2 - 1
    beta = torch.ones((), device="cuda")
    for i in range(WARMUP_STEPS):
        losses = step(x, (0, i), beta)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def counts():
        return {"attention_fwd": attention.launches,
                "attention_bwd": attention.bwd_launches,
                "attention_dense": attention.dense_calls,
                "torus_fwd": torus.fwd_launches,
                "torus_bwd": torus.launches,
                "sampler_keyed": sampler.launches,
                "sampler_rng": sampler.rng_launches}

    before = counts()
    windows = []
    for w in range(N_WINDOWS):
        t0 = time.perf_counter()
        for i in range(MEASURE_STEPS):
            losses = step(x, (0, 100 + w * 1000 + i), beta)
        torch.cuda.synchronize()
        windows.append(MEASURE_STEPS / (time.perf_counter() - t0))
    after = counts()
    n = N_WINDOWS * MEASURE_STEPS
    sps = statistics.median(windows)
    print(json.dumps({
        "metric": ("cnn_vae_d4096" if args.config == "cnn4096"
                   else "cliffordar_vae") + "_train_steps_per_sec_b64_32px",
        "config": args.config, "sampler": args.sampler,
        "steps_per_sec": sps, "ms_per_step": 1e3 / sps,
        "windows_steps_per_sec": windows, "best_steps_per_sec": max(windows),
        "compute_dtype": args.dtype, "batch": BATCH, "optimizer": "adamw",
        "lr": LR, "warmup_steps": WARMUP_STEPS,
        "measure_steps": MEASURE_STEPS, "n_windows": N_WINDOWS,
        "build_and_warmup_s": setup_s,
        "params_m": sum(p.numel() for p in st.model.parameters()) / 1e6,
        "kernel_launches_per_step": {k: (after[k] - before[k]) / n
                                     for k in after},
        "last_total_loss": losses["total_loss"].item(),
        "card": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
