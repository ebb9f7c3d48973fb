#!/usr/bin/env python3
"""Drive the PyTorch port (``cliffordtpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line and each fatal when it fails:

1. env      the card (``nvidia-smi`` name and power limit), torch, CUDA;
2. build    every ``cliffordtpu_torch/csrc/*.cu`` compiled from the
            checkout, all at once, into ``build/cliffordtpu_torch``;
3. kernels  each of the six CUDA kernels (attention forward and backward,
            torus embedding forward and backward, keyed and Philox sampler)
            against its plain PyTorch version on the card at the main
            paths' shapes (flagship32: attention B 64, S 68, 8 heads of 64,
            sampler and torus R 4096, d 16; cnn4096: R 64, d 4096) and at
            odd ones (attention at S 17 without RoPE, 16-row padding in
            bfloat16; d 2048; the table forms at d 513; the keyed sampler
            and the torus backward at the MNIST MLP's R 128, d 5, 40 and
            256; attention forward and backward at image 256's B 4, S 260,
            where the key-tiled forms run, and those forms at flagship32's
            shape for the record), with the form that
            ran (attention forward and backward: "mma" or "simt", with
            "_tiled" for the key-tiled form; torus
            forward and backward, both samplers: "fft" or "table"), its
            device time
            (CUDA events, median after warm-up; see ``cuda_ms``), the plain
            version's, the library's where it computes the same function
            (attention: ``scaled_dot_product_attention``; torus forward and
            backward: ``torch.fft.irfft`` / ``rfft``, see
            ``torus_fwd_fft``), and its bound; for the torus forward and
            backward also the two ``torch.matmul`` calls alone on a
            prebuilt basis;
4. serve    the flagship32 ``CliffordARVAE`` (``default_config(32)``: 32 px,
            latent 16, 8 heads of 64, 4 + 8 blocks) at full width with
            seeded random weights answers batch-64 requests through
            ``Serving.encode_mu`` / ``encode_z`` / ``decode`` in float32 and
            in bfloat16 compute.  The launch counts are set to 0 before
            each dtype's requests and read after; every request must
            launch the attention kernel 4 / 4 / 8 times and the sampler
            0 / 1 / 0 times.  Outputs must be finite, of the right shapes,
            the float32 outputs must match the same requests with the
            plain versions swapped in explicitly (<= 5e-4), and the
            bfloat16 outputs the float32 ones within ``BF16_BARS``;
5. train    the same model takes ``TRAIN_STEPS`` AdamW steps (lr 1e-5,
            global-norm clip 1) on one fixed batch of 64 through
            ``create_train_state`` / ``make_cnn_train_step``, in float32
            and in bfloat16 compute, after one warm-up step.  Every step
            must move the launch counts by exactly 12 (attention forward),
            12 (attention backward), 1 (sampler), 1 (torus backward); every
            loss must be finite and the last total loss below the first.
            Then, in float32, the loss pieces and every parameter's gradient
            of the first step are held against the same step with the plain
            versions swapped in (``TRAIN_BARS``), and the bfloat16 first
            loss and gradients against the float32 ones;
6. cnn_serve  the cnn4096 ``CNNVAE`` (latent 4096, 32 px, 1 channel) serves
            batch-64 requests the same way, ``encode_z`` through each of
            the three sampler routes: one launch of the keyed sampler, of
            the torus forward ("unfused") or of the Philox sampler ("rng")
            per request, none for ``encode_mu`` and ``decode``; latents of
            unit norm; the keyed and the unfused latents equal; float32
            against the plain versions;
7. cnn_train  the same model takes ``CNN_TRAIN_STEPS`` AdamW steps per dtype
            and route: one forward launch of the route's kernel and one of
            the torus backward per step, a falling loss; the float32 first
            step of every route against the plain versions
            (``TRAIN_BARS``); the "rng" route gives one loss for one key
            and another for another;
8. attention_route  ``fused_attention`` at image 256's shape (B 4, S 260,
            8 heads of 64, RoPE) in each dtype, with and without a
            gradient, and at S 400 (beyond the JAX package's
            ``attention_supported``) with one: at S 260 every case must
            take the kernels (the bfloat16 forward without a gradient in
            the whole-sequence form, the rest key-tiled), at S 400 the
            dense route (``attention_dense``, SDPA after the rotation),
            read from the counts; outputs and gradients against the plain
            versions at the attention bars;
9. image256  ``CliffordARVAE(image_size=256)`` (``default_config(256)``: 6
            + 12 blocks of S 260), clifford latent 16, batch 4: one request
            of each entry point and one train step per dtype; serving
            launches A 6 / 6 / 12 times (float32 in the tiled form,
            bfloat16 in the whole one), every step 18 tiled A and 18 tiled
            B, and nothing takes the dense route; the bfloat16 first loss
            within ``TRAIN_BARS`` of the float32 one;
10. heads   the gaussian and powerspherical heads, batch 64, per dtype: one
            request of each entry point and ``HEAD_STEPS`` steps after a
            warm-up, on the cnn4096 ``CNNVAE`` (no launch of any kernel;
            the float32 first step against the port's own step on the CPU,
            ``TRAIN_BARS``) and, with the vmf head too, on the flagship32
            ``CliffordARVAE`` (A 4 / 4 / 8 per request, 12 A + 12 B per
            step, nothing else); then the device time of one threefry
            ``normal`` and ``uniform`` draw of the cnn4096 powerspherical
            draw's shape;
11. mlp     the ``MLPVAE`` at the MNIST runner's defaults (h_dim 128, batch
            128, Adam lr 1e-3, clip 1, binarised inputs, beta from
            ``linear_kl_warmup``) on seeded synthetic images of 784 pixels
            in [0, 1]: every family at d 5 (normal with l2, powerspherical
            at z_dim 6, vmf, clifford) for ``MLP_STEPS`` steps after a
            warm-up, 1 keyed sampler + 1 torus backward launch per clifford
            step and none for the others, a falling loss, the float32 first
            step against the port's own step on the CPU (``TRAIN_BARS``);
            the clifford step at every d of the sweep (2 ... 256); ``fit``
            (2 epochs, 2048 / 512 images) and ``fit_trials`` (20 lanes):
            the first step of every lane against its own ``MLPVAE``'s
            (losses, gradient norms and clipped gradients within
            ``MLP_LANE_STEP_BAR``), two lanes' histories against their own
            sequential ``fit`` (rtol 2e-4),
            the epoch times of both; ``compute_test_metrics`` with 10 IWAE
            samples finite;
12. hybrid  the Fashion runner's ``--arch hybrid`` at the sweep's largest
            latent: ``HybridVAE`` (32 px, channels [64, 128, 256], 64
            tokens of latent 256), float32, batch 256 of seeded random
            images: the three entry points (1 keyed sampler launch per
            ``encode_z``, none otherwise; unit torus points; against the
            plain versions), ``HYBRID_STEPS`` AdamW steps at lr 1e-3 (1
            keyed sampler + 1 torus backward per step, a falling loss), the
            first step against the plain versions (``TRAIN_BARS``), then
            the gaussian and powerspherical heads (no kernel);
13. checkpoint  resume: 5 steps straight against 3, ``save_checkpoint``,
            ``load_checkpoint`` into a fresh model and optimizer and 2
            more, bit-equal losses and parameters (under cuDNN's
            deterministic algorithms; whether two straight runs differ
            without them is reported), with AdamW and with the
            learnable-beta sigma group under two-step accumulation;
14. eval    the battery on the trained hybrid over seeded labelled images:
            an item memory of 1000 flat latents (T x 2d = 32768),
            bundle and role-filler capacity (20 trials), self-binding to
            depth 40 by both unbindings, the per-class bundle test,
            ``test_vsa_operations``, the pairwise and cross-class decodes,
            kNN (torch backend) and class means; every number finite,
            every accuracy in [0, 1], the keyed sampler launched;
15. fid     ``cifar_fid4096``: ``scripts/cifar10_train.py``'s ``CNNVAE``
            at its largest latent (4096, 32 px, 3 channels, seeded
            weights) scored by ``compute_fid`` as the CNN runner calls it
            (2048 prior draws in batches of 256 against 2048 seeded
            labelled images of CIFAR's shape): one launch of the torus
            forward per prior batch and nothing else; the decodes and the
            FID against the same run with the plain embedding
            (``FID_DECODE_BAR``, ``FID_REL_BAR``); the seed-42 surrogate
            and InceptionV3 on a seeded random-weight npz that the phase
            writes to a temporary directory (``$CLIFFORDTPU_INCEPTION`` set
            for that call only; its features on two images against the
            port's CPU run, ``INCEPTION_CPU_BAR``); the host Fréchet
            distance at 512 and 2048 features; the trained hybrid scored
            alike (per token at d 256: no kernel); then the device half of
            each plot (manifold grid of 144 rows, prior grid,
            reconstructions, interpolations, fixed-pair interpolations,
            decoded bundles: torus forward and keyed sampler), each canvas
            finite in [0, 1].  No figure is drawn: the card has no
            matplotlib;
16. runner  ``run_cnn_experiments`` as a user runs it, ``CNNVAE`` at the
            sweep's largest latent (4096) and the runners' batch 256: the
            Fashion runner's parser on the committed MNIST shard
            (``--dataset mnist32``, 1500 / 297 digits, 2 epochs, in
            process, ``data_source`` "real") and the CIFAR-10 runner's on
            its synthetic fallback (1024 / 512, 1 epoch) with
            ``--eval_subprocess`` (the battery in the port's
            ``eval_checkpoint`` child, on the card); matplotlib replaced by
            a recorder (``PLOT_RECORDER``: calls ignored, every image shown
            finite), so only ``HOST_DRAWING_STAGES`` (t-SNE, for want of
            scikit-learn) may fail, and their device halves run here.  Per
            run: one torus backward per train step, the keyed sampler at
            least once per train step and test batch, the torus forward at
            least once per prior batch of ``compute_fid``; no other
            ``warning:`` line; the artifact set with every battery number
            filled in; then the runner's step at batch 256 (host wall and
            device time) and one epoch of ``train_model`` with the kernels
            against the plain versions (best loss within
            ``RUNNER_LOSS_REL``, cuDNN deterministic); then the Fashion
            runner's other arms, ``--arch hybrid`` and ``--arch vit`` at
            latent 128, one epoch each on the shard with the battery in
            process: the artifacts, one torus backward a train step, the
            keyed sampler at least once a train step and test batch, and
            for the ViT 12 attention backward launches a step and no dense
            attention call (S 68 fits the kernels);
17. mnist_runners  ``cliffordtpu_torch.scripts.mnist_clifpws`` and
            ``mnist_vmf`` as a user runs them, on the committed shard (1350
            / 150 / 297 digits), 2 lanes of ``fit_trials`` a cell: every
            family at d 5 and 256 (3 epochs, the battery on trial 1, trial
            2 the table feed only); the clifford cell at d 5 with
            ``--eval_subprocess`` (the child on the card, ``--table_only``
            for trial 2); the vMF runner at d 5 (every trial's battery).
            The per-trial dumps (kNN accuracies in steps of 1/297, finite
            losses, the curves filled or empty as gated), the CSV with
            every family at both d, the sidecar and the across-dims table;
            one torus backward a clifford lane step and the keyed sampler
            once a lane step and at least once an encoded eval batch,
            nothing for the other families; no other ``warning:`` line;
            one epoch of ``fit_trials`` with the kernels against the plain
            versions (best validation losses within
            ``MNIST_RUNNER_LOSS_REL``);

then the ``sweep`` and ``figures`` phases (``sweep_phase``,
``figures_phase``), then:

18. export  flagship32 (float32 and bfloat16 compute) and cnn4096
            exported for "cuda" by ``serving.export_serving`` into a
            temporary directory (params.npz float32, and for flagship32
            float32 and cnn4096 also bfloat16 and int8), loaded by a
            child process (``chip_smoke.py --export-child``) that imports
            no ``cliffordtpu_torch.nn`` module; requests at batch 1, 8 and
            64 through one program per function, held against in-process
            ``Serving`` on the same weights and keys (``EXPORT_BAR``;
            bfloat16 ``EXPORT_BF16_BAR``); the launches inside the loaded
            programs per request (flagship32 A 4 / 4 / 8 and F 0 / 1 / 0,
            cnn4096 F 0 / 1 / 0); the storage modes within
            ``EXPORT_QUANT``; every program under ``EXPORT_PT2_SHARE`` of
            params.npz; the batch-64 request times of bundle and
            ``Serving``;
19. native  the Python-free serving path: the operator library
            (``csrc/native_ops.cpp`` with kernels A, F, E and C linked in)
            and the C++ host (``native/serve.cc``) built from the
            checkout at once, neither linking libpython; each operator's
            CUDA implementation against its CPU one at the serving
            shapes (u and v bit for bit, ``HOST_OP_BAR``; the attention
            also at image 256's S 260 in float32, its key-tiled form); the
            ``HOST_EXPORTS`` bundles (flagship32 in float32 and bfloat16
            compute, cnn4096 by each sampler route and with the gaussian
            and powerspherical heads, the vMF ``MLPVAE`` at z_dim 41)
            exported with ``native=True`` at batch 64 by parallel child
            processes (AOTInductor packages), each bundle served as soon
            as its child is done; each function answered by
            the host binary as a subprocess with no Python in it, held
            against in-process ``Serving`` (``EXPORT_BAR``; a bfloat16
            package, compiled as eager runs it, against bfloat16
            ``Serving`` at ``EXPORT_BF16_BAR`` and ``HOST_BF16_EAGER_BAR``
            and at least ``HOST_BF16_FLOOR`` from float32 ``Serving``),
            its launches counted inside the host
            (``HOST_LAUNCHES``: A 4 / 4 / 8, F, E or C once per
            ``encode_z`` by route); the host's p50 ms at batch 64 beside
            ``LoadedServing``'s and ``Serving``'s;
20. native_data  the native data engine built on the card's host; the
            committed digit shard written as idx files (plain and gz) and
            read back natively and in Python; ``iterate_batches``'
            stream at batch 256 through the C++ batcher against the numpy
            path, keyed and not; ms per epoch of both;

then the run's seconds (``seconds``: the total, and each phase's wall
time since the one before, the six longest first), the table of all six
kernels as one JSON line (the attention kernels
also on the heads' path and at image 256; the keyed sampler and the torus
backward also at the MNIST shapes and at the hybrid's, R 16384 rows of d
256; the torus forward and the keyed sampler at cifar_fid4096's, R 256 and
R 200 of d 4096; the keyed sampler, the torus backward and the torus
forward at runner_fashion4096's, R 256 of d 4096; the attention kernels
at the ViT arm's B 256 and the keyed sampler and torus backward at the
hybrid arm's R 16384 of d 8; the keyed sampler and the torus backward at
R 128, d 5 and 256, with the MNIST runners' launches; A and F inside
the loaded bundles' programs; A, F, E and C inside the C++ host), the
``nvidia-smi`` line, and
last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12}  # float32 outside the tensor cores
BATCH = 64
DEVICE = torch.device("cuda")
REQUESTS = 6  # per entry point and dtype; the first is the warm-up
# bfloat16 against float32 compute, same weights and requests: about five
# times the largest difference bfloat16 rounding gave on an H100 (0.053
# rad, 0.0098, 0.052), far below what a wrong cast or dtype would give
BF16_BARS = {"encode_mu": 0.25, "encode_z": 0.05, "decode": 0.25}
TRAIN_STEPS = 10  # timed, after one warm-up step
# flagship32's train lr.  At 1e-4, with no warm-up, this 12-block ViT's
# one-batch losses swing by a third from step to step (the JAX package's
# own AdamW steps from the same initial params swing alike), and the
# card's bfloat16 steps are not bit-reproducible, so whether the last loss
# lay below the first was chance: three bfloat16 runs of one tree on an
# H100 ended at 659, 703 and 881 from 861.  At 1e-5 the losses fall step
# after step, with at most a small rise, by a third in ten steps, so a
# last loss above the first points at the step again.
TRAIN_LR = 1e-5
PER_STEP = {"attention_fwd": 12, "attention_bwd": 12, "torus_fwd": 0,
            "torus_bwd": 1, "sampler_keyed": 1, "sampler_rng": 0}
CNN_LATENT = 4096
CNN_TRAIN_STEPS = 6  # timed, after one warm-up step
ROUTES = ("keyed", "unfused", "rng")
# the forward kernel each sampler route launches once per draw
ROUTE_KERNEL = {"keyed": "sampler_keyed", "unfused": "torus_fwd",
                "rng": "sampler_rng"}
# float32 train step with the kernels against the same step with the plain
# versions: each loss piece relative to its value; the gradients' global
# l2 error relative to the global gradient norm, and every parameter's
# largest gradient error relative to that norm.  Both sides run the same
# float32 library GEMMs and convolutions, so only the kernels' summation
# order differs (about 1e-6 relative).  The bfloat16 first-step total loss
# lies within 2% of the float32 one (bfloat16 keeps 8 bits of mantissa),
# and the bfloat16 gradients' global l2 error within 15% of the float32
# gradient norm (rounding noise through 12 blocks; 4% on the tiny model of
# the CPU tests), far below what a wrong backward gives (100% or more).
TRAIN_BARS = {"loss_rel": 1e-4, "grad_l2_rel": 1e-3, "grad_max_rel": 5e-4,
              "bf16_loss_rel": 2e-2, "bf16_grad_l2_rel": 0.15}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median device time of one call, from CUDA events around ``inner``
    calls, after three warm-up calls.  The timed calls are queued behind a
    sleep kernel longer than the host needs to queue them, so the events
    time the device work alone (with its launch gaps), as when the card is
    kept busy, and not the wrapper's host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # 4e9 cycles per host second: at least twice the host time at any SM
    # clock up to 2 GHz
    sleep_cycles = int(host_s * 4e9) + 100_000
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_dtype) -> tuple:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def attention_form(attention, direction, dtype, S, H, hd, tiled=False):
    """The form kernel A ("fwd") or B ("bwd") takes at this shape, or its
    key-tiled form with ``tiled``.  A checkout from before the tiled forms
    names a form by its dtype alone, one from before the tensor-core forms
    has one form."""
    if tiled:
        return attention.fwd_form(dtype) + "_tiled"
    if hasattr(attention, "route"):
        return (attention.fwd_form(dtype, S, H, hd) if direction == "fwd"
                else attention.bwd_form(dtype, S, H, hd))
    if direction == "fwd":
        return getattr(attention, "fwd_form", lambda dt: "simt")(dtype)
    return getattr(attention, "bwd_form", lambda dt: "scalar")(dtype)


def attention_case(attention, rope, B, S, H, hd, dtype, use_rope, gen,
                   packed=False, tiled=False):
    """Kernel A against its plain version; ``packed``: q, k, v the views
    of one (B, S, H, 3, hd) projection (``fused_proj``), read in place;
    ``tiled``: the key-tiled form (with the log-sum-exp, as under
    autograd) whatever form the route gives the shape."""
    dev = DEVICE
    if packed:
        qkv = torch.randn(B, S, H, 3, hd, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(3)
    else:
        q, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
    cos = sin = None
    if use_rope:
        c, s = rope.rope_2d_cos_sin(32, math.isqrt(S - 4), hd,
                                    cls_token_num=4)
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev)
    cs = (None, None) if cos is None else (cos[:S].contiguous(),
                                           sin[:S].contiguous())

    def call():
        if tiled:
            return attention._launch_fwd_tiled(q, k, v, *cs)[0]
        if packed:
            return attention.fused_attention_qkv(qkv, cos, sin)
        return attention.fused_attention(q, k, v, cos, sin)

    got = call()
    want = attention.attention_plain(q, k, v, cos, sin)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        check(err <= 1e-5, f"attention f32 S={S} max_abs_err {err} > 1e-5")
    else:
        check(err <= 2e-2 * scale,
              f"attention bf16 S={S} err {err} > 2e-2 * {scale}")
    # the library yardstick: SDPA on the already-rotated heads (B, H, S, hd)
    qr, kr = q, k
    if use_rope:
        qr = rope.apply_rotary_half(q.float(), cos, sin).to(dtype)
        kr = rope.apply_rotary_half(k.float(), cos, sin).to(dtype)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    elt = q.element_size()
    nbytes = 4 * q.numel() * elt + (0 if cos is None else 2 * cos.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * H * S * S * hd, dtype)
    kernel = cuda_ms(call)
    plain = cuda_ms(lambda: attention.attention_plain(q, k, v, cos, sin))
    library = cuda_ms(lambda: sdpa(qh, kh, vh))
    form = attention_form(attention, "fwd", dtype, S, H, hd, tiled)
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, form=form, layout="packed" if packed else "contiguous",
        max_abs_err=err, ms=kernel, plain_ms=plain,
        library_ms=library, bound_ms=b_ms, bound_by=b_by)


def attention_bwd_case(attention, rope, B, S, H, hd, dtype, use_rope, gen,
                       packed=False, tiled=False):
    """Kernel B against its plain version; ``packed``: q, k, v the views of
    one (B, S, H, 3, hd) projection, the gradient one packed dqkv.  The
    tiled form (where the route gives it, or with ``tiled``) reads the
    tiled forward's output and log-sum-exp, made once before it is
    timed."""
    dev = DEVICE
    if packed:
        qkv = torch.randn(B, S, H, 3, hd, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(3)
        d_out = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    else:
        q, k, v, d_out = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                          .to(dtype) for _ in range(4))
    cos = sin = None
    if use_rope:
        c, s = rope.rope_2d_cos_sin(32, math.isqrt(S - 4), hd,
                                    cls_token_num=4)
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev)
    form = attention_form(attention, "bwd", dtype, S, H, hd, tiled)
    cs = (None, None) if cos is None else (cos[:S].contiguous(),
                                           sin[:S].contiguous())
    saved = {}  # the tiled forward's output and log-sum-exp
    if form.endswith("_tiled"):
        saved = dict(zip(("out", "lse"),
                         attention._launch_fwd_tiled(q, k, v, *cs)))

    def bwd():
        if tiled:
            return attention._launch_bwd_tiled(q, k, v, *cs, saved["out"],
                                               saved["lse"], d_out)
        return attention.fused_attention_bwd(q, k, v, cos, sin, d_out,
                                             **saved)
    got = bwd()
    want = attention.attention_bwd_plain(q, k, v, cos, sin, d_out)
    torch.cuda.synchronize()
    errs, scales = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = (a.float() - b.float()).abs().max().item()
        scales[name] = b.float().abs().max().item()
        bar = (1e-5 if dtype == torch.float32 else 2e-2) * max(
            1.0, scales[name])
        check(bool(torch.isfinite(a).all()) and errs[name] <= bar,
              f"attention_bwd {dtype} S={S} {name}: err {errs[name]} > {bar}")
    # through autograd, as the model reaches the kernel (in the form the
    # route gives the shape)
    before = attention.bwd_launches
    if tiled:
        pass
    elif packed:
        check(got[0]._base is not None and got[0].stride() == q.stride(),
              "the packed backward did not write one packed gradient")
        qkvg = qkv.clone().requires_grad_()
        auto = torch.autograd.grad(
            attention.fused_attention_qkv(qkvg, cos, sin), qkvg,
            d_out)[0].unbind(3)
    else:
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(
            attention.fused_attention(qg, kg, vg, cos, sin), (qg, kg, vg),
            d_out)
    if not tiled:
        check(attention.bwd_launches == before + 1,
              "autograd of fused_attention did not launch the backward "
              "kernel")
        check(all(torch.equal(a, b) for a, b in zip(auto, got)),
              "autograd of fused_attention differs from fused_attention_bwd")
    # the library yardstick: autograd through SDPA on the already-rotated
    # heads (B, H, S, hd), graph retained
    qr, kr = q, k
    if use_rope:
        qr = rope.apply_rotary_half(q.float(), cos, sin).to(dtype)
        kr = rope.apply_rotary_half(k.float(), cos, sin).to(dtype)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (qr, kr, v))
    doh = d_out.transpose(1, 2).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
    # q, k, v, dO read; dq, dk, dv written; five S x S x hd products
    nbytes = 7 * q.numel() * q.element_size() + (
        0 if cos is None else 2 * cos.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 10.0 * B * H * S * S * hd, dtype)
    kernel = cuda_ms(bwd)
    plain = cuda_ms(
        lambda: attention.attention_bwd_plain(q, k, v, cos, sin, d_out))
    library = cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, form=form, layout="packed" if packed else "contiguous",
        max_abs_err=max(errs.values()), errors=errs,
        scales=scales, ms=kernel, plain_ms=plain, library_ms=library,
        bound_ms=b_ms, bound_by=b_by)


def matmul_yardstick_ms(ops_torus, theta, g):
    """Device time of the two ``torch.matmul`` calls alone that the torus
    forward (on cos and sin theta, ``g`` None) or backward (on ``g``) would
    make against a basis already in memory."""
    d = theta.shape[1] + 1
    cos_b, sin_b, _ = ops_torus.torus_bases(d, theta.device)
    if g is None:
        ct, st = torch.cos(theta), torch.sin(theta)
        return cuda_ms(lambda: (ct @ cos_b, st @ sin_b))
    cos_t, sin_t = cos_b.T.contiguous(), sin_b.T.contiguous()
    return cuda_ms(lambda: (g @ cos_t, g @ sin_t))


def torus_fwd_fft(theta):
    """The embedding as the library computes it: the inverse real FFT of
    the Hermitian spectrum (1, exp(i theta_1), ..., exp(i theta_{d-1}), 1)
    of length n = 2d.  A yardstick only: the port never calls it."""
    phase = torch.nn.functional.pad(theta, (1, 1))
    return torch.fft.irfft(torch.polar(torch.ones_like(phase), phase),
                           n=2 * (theta.shape[1] + 1), dim=1)


def torus_bwd_fft(theta, g):
    """d theta as the library computes it: with G = rfft(g), g C^T = (2/n)
    Re G and g S^T = (2/n) Im G, so d theta_k = (2/n) Im(G_k exp(-i
    theta_k)).  A yardstick only."""
    d = theta.shape[1] + 1
    spectrum = torch.fft.rfft(g, dim=1)[:, 1:d]
    return (spectrum * torch.polar(torch.ones_like(theta), -theta)).imag / d


def sampler_bwd_fft(torus, theta, u, v, kappa, g):
    """``sampler_bwd_plain`` with ``torus_bwd_fft`` for its products."""
    dth = torus_bwd_fft(theta, g)
    kap = torch.broadcast_to(kappa, (theta.shape[0], theta.shape[1] + 1))
    zero = torch.zeros_like(dth[:, :1])
    return (torch.cat([zero, dth], 1), torch.cat(
        [zero, dth * torus.dtheta_dkappa(u, v, kap[:, 1:])], 1))


def torus_form(torus, kernel, d):
    """The form a torus-family kernel takes at d (``torus.form``); in a
    checkout from before that function (``scripts/torch_kernel_times.py
    --root``) the forward and the Philox sampler took ``fwd_form``'s, the
    torus backward and the keyed sampler the table form."""
    if hasattr(torus, "form"):
        return torus.form(d)
    return torus.fwd_form(d) if kernel in ("torus_fwd", "sampler_rng") \
        else "table"


def torus_bound_ms(nbytes, R, d):
    """(bound ms, what binds, the dense form's bound ms) of a kernel that
    embeds R rows of d angles or differentiates that embedding.  The
    function is a real FFT of length n = 2d per row (about 2.5 n log2 n
    operations), so it is bound by its bytes; the table forms compute it
    as a dense product, two float32 multiply-adds per (row, angle, column),
    whose operation bound is reported beside it."""
    b_ms, b_by = bound_ms(nbytes, 2.5 * R * 2 * d * math.log2(2 * d),
                          torch.float32)
    dense = 8.0 * R * (d - 1) * d / PEAK_OPS_PER_S[torch.float32] * 1e3
    return b_ms, b_by, dense


def torus_fwd_case(torus, ops_torus, R, d, gen):
    """The torus forward kernel against its plain version, alone and through
    ``angles_to_torus`` where that routes to it."""
    theta = (torch.rand(R, d - 1, generator=gen, device=DEVICE) * 2 - 1) \
        * math.pi
    got, want = torus.torus_fwd(theta), torus.torus_fwd_plain(theta)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (R, 2 * d) and bool(torch.isfinite(got).all())
          and err <= 1e-5, f"torus_fwd R={R} d={d}: err {err} > 1e-5")
    if ops_torus.uses_kernel("cuda", d):
        # through autograd, as the "unfused" sampler route reaches it
        angles = torch.cat([torch.zeros(R, 1, device=DEVICE), theta], 1)
        angles.requires_grad_()
        g = torch.randn(R, 2 * d, generator=gen, device=DEVICE)
        before = (torus.fwd_launches, torus.launches)
        x = ops_torus.angles_to_torus(angles)
        (d_angles,) = torch.autograd.grad(x, angles, g)
        check((torus.fwd_launches, torus.launches)
              == (before[0] + 1, before[1] + 1),
              "angles_to_torus did not launch the forward and backward "
              "kernels once each")
        check(torch.equal(x, got) and bool((d_angles[:, 0] == 0).all()),
              "angles_to_torus differs from torus_fwd")
        # the backward without the epilogue, at this route's own shape
        bwd_err = (d_angles[:, 1:] - torus.torus_bwd_plain(theta, g)) \
            .abs().max().item()
        check(bwd_err <= 1e-5, f"angles_to_torus backward R={R} d={d}: err "
                               f"{bwd_err} > 1e-5")
    fft_err = (torus_fwd_fft(theta) - want).abs().max().item()
    check(fft_err <= 1e-5, f"torus_fwd_fft R={R} d={d}: err {fft_err}")
    # theta read, x written
    b_ms, b_by, dense = torus_bound_ms(4 * (theta.numel() + R * 2 * d), R, d)
    return dict(R=R, d=d, form=torus_form(torus, "torus_fwd", d),
                max_abs_err=err,
                ms=cuda_ms(lambda: torus.torus_fwd(theta)),
                plain_ms=cuda_ms(lambda: torus.torus_fwd_plain(theta),
                                 reps=5),
                matmul_ms=matmul_yardstick_ms(ops_torus, theta, None),
                library_ms=cuda_ms(lambda: torus_fwd_fft(theta)),
                bound_ms=b_ms, bound_by=b_by, dense_bound_ms=dense)


def torus_bwd_case(torus, sampler, ops_torus, R, d, epilogue, gen):
    """The torus backward kernel alone (``torus_bwd``), or with the fused
    samplers' concentration epilogue (``sampler_bwd``) on the residuals of
    a forward draw with one kappa per row."""
    dev = DEVICE
    g = torch.randn(R, 2 * d, generator=gen, device=dev)
    if epilogue:
        loc = (torch.rand(R, d, generator=gen, device=dev) * 2 - 1) * math.pi
        kappa = torch.rand((R, 1), generator=gen, device=dev) * 10 + 0.03
        _, theta, u, v = sampler.sample_embed_keyed((0, 77 + R + d), loc,
                                                    kappa)
        run = lambda: torus.sampler_bwd(theta, u, v, kappa, g)
        run_plain = lambda: torus.sampler_bwd_plain(theta, u, v, kappa, g)
        run_fft = lambda: sampler_bwd_fft(torus, theta, u, v, kappa, g)
        names = ("dloc", "dkappa")
        # theta, u, v, g, kappa read; dloc, dkappa (R, d) written
        nbytes = 4 * (3 * theta.numel() + g.numel() + kappa.numel()
                      + 2 * R * d)
    else:
        theta = (torch.rand(R, d - 1, generator=gen, device=dev) * 2 - 1) \
            * math.pi
        run = lambda: (torus.torus_bwd(theta, g),)
        run_plain = lambda: (torus.torus_bwd_plain(theta, g),)
        run_fft = lambda: (torus_bwd_fft(theta, g),)
        names = ("dtheta",)
        nbytes = 4 * (2 * theta.numel() + g.numel())
    got, want, by_fft = run(), run_plain(), run_fft()
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c in zip(names, got, want, by_fft):
        errs[name] = (a - b).abs().max().item()
        bar = 1e-5 * max(1.0, b.abs().max().item())
        check(a.shape == b.shape and bool(torch.isfinite(a).all())
              and errs[name] <= bar,
              f"torus_bwd R={R} d={d} {name}: err {errs[name]} > {bar}")
        fft_err = (c - b).abs().max().item()
        check(fft_err <= bar, f"torus_bwd_fft R={R} d={d} {name}: err "
                              f"{fft_err} > {bar}")
    if epilogue:
        check(bool((got[0][:, 0] == 0).all() and (got[1][:, 0] == 0).all()),
              "sampler_bwd: column 0 (the pinned angle) is not zero")
        # through autograd, as the model reaches the kernel, from either
        # fused sampler
        for fused in (sampler.sample_embed_keyed, sampler.sample_embed_rng):
            lg = loc.clone().requires_grad_()
            kg = kappa.clone().requires_grad_()
            before = torus.launches
            x, th2, u2, v2 = fused((0, 77 + R + d), lg, kg)
            a_loc, a_kap = torch.autograd.grad(x, (lg, kg), g)
            check(torus.launches == before + 1,
                  f"autograd of {fused.__name__} did not launch torus_bwd")
            ref = torus.sampler_bwd(th2, u2, v2, kappa, g)
            check(torch.equal(a_loc, ref[0]) and bool(torch.allclose(
                a_kap, ref[1].sum(1, keepdim=True), rtol=1e-5, atol=1e-6)),
                f"autograd of {fused.__name__} differs from sampler_bwd")
    del got, want, by_fft
    b_ms, b_by, dense = torus_bound_ms(nbytes, R, d)
    return dict(R=R, d=d, epilogue=epilogue,
                form=torus_form(torus, "torus_bwd", d),
                max_abs_err=max(errs.values()), errors=errs, ms=cuda_ms(run),
                plain_ms=cuda_ms(run_plain, reps=5),
                matmul_ms=matmul_yardstick_ms(ops_torus, theta, g),
                library_ms=cuda_ms(run_fft), bound_ms=b_ms, bound_by=b_by,
                dense_bound_ms=dense)


def sampler_case(sampler, route, R, d, per_row_kappa, gen, row0=0):
    """A fused sampler + embedding kernel ("keyed" or "rng") against its
    plain version: u and v bit for bit, theta and x to 1e-5.  With
    ``row0`` > 0 the R rows are rows row0.. of a global draw of row0 + R
    (a data-parallel rank's), and u and v are also those rows of the
    global draw, bit for bit."""
    dev = DEVICE
    fused = getattr(sampler, f"sample_embed_{route}")
    plain = getattr(sampler, f"sample_embed_{route}_plain")
    loc = (torch.rand(R, d, generator=gen, device=dev) * 2 - 1) * math.pi
    kshape = (R, 1) if per_row_kappa else (R, d)
    kappa = torch.rand(kshape, generator=gen, device=dev) * 10 + 0.03
    key = (0, 1234 + R + d)
    # (a checkout from before the row base takes no ``rows``)
    kw = {"rows": (row0, row0 + R)} if row0 else {}
    got = fused(key, loc, kappa, **kw)
    want = plain(key, loc, kappa, **kw)
    if row0:
        lead = torch.zeros(row0, d, device=dev)
        whole = fused(key, torch.cat([lead, loc]), torch.cat(
            [torch.ones(row0, kappa.shape[1], device=dev), kappa]))
        for i in (2, 3):
            check(torch.equal(whole[i][row0:], got[i]),
                  f"sampler {route} rows {row0}.. are not those rows of the "
                  f"global draw")
        del whole
    torch.cuda.synchronize()
    names = ("x", "theta", "u", "v")
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(names, got, want)}
    for i, name in ((2, "u"), (3, "v")):
        check(torch.equal(got[i], want[i]),
              f"sampler {route} R={R} d={d}: {name} not bit-exact")
    check(errs["theta"] <= 1e-5 and errs["x"] <= 1e-5,
          f"sampler {route} R={R} d={d}: theta/x errors {errs} > 1e-5")
    check(bool((got[2] >= 1e-12).all() and (got[2] < 1).all()
               and (got[3] >= 0).all() and (got[3] < 1).all()),
          f"sampler {route} R={R} d={d}: uniforms out of range")
    del got, want
    # loc + kappa read; x, theta, u, v written (float32)
    nbytes = 4 * (loc.numel() + kappa.numel() + R * 2 * d + 3 * R * (d - 1))
    # the draws are a few hundred operations per angle, below the bytes too
    b_ms, b_by, dense = torus_bound_ms(nbytes, R, d)
    return dict(
        route=route, R=R, d=d, row0=row0, per_row_kappa=per_row_kappa,
        form=torus_form(sampler.torus, f"sampler_{route}", d),
        max_abs_err=errs["x"], errors=errs,
        ms=cuda_ms(lambda: fused(key, loc, kappa, **kw)),
        plain_ms=cuda_ms(lambda: plain(key, loc, kappa, **kw), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, dense_bound_ms=dense)


@contextlib.contextmanager
def plain_versions(attention, sampler, ops_torus):
    """Swap the plain PyTorch versions in for the kernels, so the same
    requests can be answered, and the same step taken, without them on the
    card: autograd then differentiates the plain forward versions, and no
    backward kernel is reached either."""
    saved = (attention.fused_attention, sampler.sample_embed_keyed,
             sampler.sample_embed_rng, ops_torus.uses_kernel)
    attention.fused_attention = attention.attention_plain
    sampler.sample_embed_keyed = sampler.sample_embed_keyed_plain
    sampler.sample_embed_rng = sampler.sample_embed_rng_plain
    ops_torus.uses_kernel = lambda device_type, d: False
    try:
        yield
    finally:
        (attention.fused_attention, sampler.sample_embed_keyed,
         sampler.sample_embed_rng, ops_torus.uses_kernel) = saved


def flagship(vit_vae, dtype):
    return vit_vae.CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                                 compute_dtype=dtype, seed=0)


def cnn4096(conv_vae, dtype, route="keyed"):
    return conv_vae.CNNVAE(latent_dim=CNN_LATENT, in_channels=1, img_size=32,
                           sampler=route, compute_dtype=dtype, seed=0)


def launch_counts(attention, sampler, torus):
    """The six kernels' launch counts, and the calls of the dense attention
    route (``attention_dense``, not a kernel of this repository)."""
    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            # the share of A's and B's launches in the key-tiled form
            "attention_fwd_tiled": attention.tiled_launches,
            "attention_bwd_tiled": attention.tiled_bwd_launches,
            "attention_dense": attention.dense_calls,
            "torus_fwd": torus.fwd_launches, "torus_bwd": torus.launches,
            "sampler_keyed": sampler.launches,
            "sampler_rng": sampler.rng_launches}


def zero_counts(attention, sampler, torus):
    attention.launches = attention.bwd_launches = attention.dense_calls = 0
    attention.tiled_launches = attention.tiled_bwd_launches = 0
    torus.fwd_launches = torus.launches = 0
    sampler.launches = sampler.rng_launches = 0


def launched_since_zero(kmods):
    """The kernels launched since ``zero_counts``, with their counts."""
    return {k: v for k, v in launch_counts(*kmods).items() if v}


def moved_counts(before, after):
    """The kernels whose count moved, with by how much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def serve(kmods, srv, images, requests, label, rounds=None):
    """Answer ``rounds`` (default ``REQUESTS``) requests per entry point.
    ``requests`` maps a name to (call(srv, images, key, outs), launches it
    must make); returns the outputs of the last round, the latencies and
    the launch counts."""
    lat = {name: [] for name in requests}
    zero_counts(*kmods)
    for i in range(rounds or REQUESTS):
        outs = {}
        for name, (call, expected) in requests.items():
            before = launch_counts(*kmods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = call(srv, images, (0, i), outs)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
            moved = moved_counts(before, launch_counts(*kmods))
            check(moved == expected, f"{label} {name}: launches moved "
                                     f"{moved}, expected {expected}")
    for name, out in outs.items():
        check(bool(torch.isfinite(out).all()), f"{label} {name}: not finite")
    return outs, lat, launch_counts(*kmods)


FLAGSHIP_REQUESTS = {
    "encode_mu": (lambda srv, x, key, outs: srv.encode_mu(x),
                  {"attention_fwd": 4}),
    "encode_z": (lambda srv, x, key, outs: srv.encode_z(key, x),
                 {"attention_fwd": 4, "sampler_keyed": 1}),
    "decode": (lambda srv, x, key, outs: srv.decode(outs["encode_z"]),
               {"attention_fwd": 8}),
}
CNN_REQUESTS = {
    "encode_mu": (lambda srv, x, key, outs: srv.encode_mu(x), {}),
    **{f"encode_z[{route}]": (
        lambda srv, x, key, outs, route=route: srv.encode_z(key, x,
                                                            sampler=route),
        {ROUTE_KERNEL[route]: 1}) for route in ROUTES},
    "decode": (lambda srv, x, key, outs: srv.decode(outs["encode_z[keyed]"]),
               {}),
}


def serve_flagship(kmods, serving, vit_vae, dtype, images):
    srv = serving.Serving(flagship(vit_vae, dtype), device=DEVICE)
    outs, lat, counts = serve(kmods, srv, images, FLAGSHIP_REQUESTS,
                              f"flagship32 {dtype}")
    check(outs["encode_mu"].shape == (BATCH, 1024), "encode_mu shape")
    check(outs["encode_z"].shape == (BATCH, 2048), "encode_z shape")
    check(outs["decode"].shape == (BATCH, 32, 32, 1), "decode shape")
    norms = outs["encode_z"].reshape(BATCH, 64, 32).norm(dim=-1)
    check((norms - 1).abs().max().item() < 1e-4,
          "encode_z: torus points are not of unit norm")
    return srv, outs, lat, counts


def serve_cnn(kmods, serving, conv_vae, dtype, images):
    srv = serving.Serving(cnn4096(conv_vae, dtype), device=DEVICE)
    outs, lat, counts = serve(kmods, srv, images, CNN_REQUESTS,
                              f"cnn4096 {dtype}")
    check(outs["encode_mu"].shape == (BATCH, CNN_LATENT), "cnn encode_mu "
                                                          "shape")
    check(outs["decode"].shape == (BATCH, 32, 32, 1), "cnn decode shape")
    for route in ROUTES:
        z = outs[f"encode_z[{route}]"]
        check(z.shape == (BATCH, 2 * CNN_LATENT), f"cnn encode_z[{route}] "
                                                  f"shape")
        check((z.norm(dim=-1) - 1).abs().max().item() < 1e-4,
              f"cnn encode_z[{route}]: torus points are not of unit norm")
    same = (outs["encode_z[keyed]"] - outs["encode_z[unfused]"]).abs().max()
    check(same.item() <= 1e-5, f"cnn encode_z: the keyed and the unfused "
                               f"route differ by {same.item()}")
    return srv, outs, lat, counts


def serve_check(kmods, ops_torus, label, srv, outs, bf16_outs, requests,
                images):
    """float32 serving with the kernels against the same requests with the
    plain versions, and bfloat16 against float32 compute."""
    attention, sampler, _ = kmods
    before = launch_counts(*kmods)
    with plain_versions(attention, sampler, ops_torus), \
            torch.inference_mode():
        plain = {}
        for name, (call, _) in requests.items():
            # the decoders are fed the kernels' latents
            plain[name] = call(srv, images, (0, REQUESTS - 1), outs)
    check(launch_counts(*kmods) == before,
          f"{label}: the plain requests launched a kernel")
    diffs = {k: (outs[k] - plain[k]).abs().max().item() for k in plain}
    bf16_vs_f32 = {}
    for k in outs:
        diff = bf16_outs[k].float() - outs[k]
        if k == "encode_mu":  # angles: compare them modulo 2 pi
            diff = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
        bf16_vs_f32[k] = diff.abs().max().item()
    emit(f"{label}_check", kernels_vs_plain_f32=diffs,
         bf16_vs_f32=bf16_vs_f32, bf16_bars=BF16_BARS)
    check(max(diffs.values()) <= 5e-4,
          f"{label}: float32 serving with kernels vs plain: {diffs} > 5e-4")
    for k, v in bf16_vs_f32.items():
        bar = BF16_BARS[k.split("[")[0]]
        check(v <= bar, f"{label} {k}: bfloat16 vs float32 compute {v} > "
                        f"{bar}")


def train(kmods, st, step, per_step, steps, images, label, must_fall=True,
          total="total_loss", beta=1.0):
    """One warm-up and ``steps`` timed Adam(W) steps on one batch; returns
    the per-step losses, the step times and the launch counts.  With
    ``must_fall`` the last ``total`` loss must lie below the first."""
    beta = torch.full((), beta, device=DEVICE)
    zero_counts(*kmods)
    history, ms = [], []
    for i in range(steps + 1):
        before = launch_counts(*kmods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(images, (0, i), beta)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        moved = moved_counts(before, launch_counts(*kmods))
        check(moved == per_step,
              f"{label} train step {i}: launches moved {moved}, expected "
              f"{per_step}")
        history.append({k: v.item() for k, v in losses.items()})
        check(all(math.isfinite(v) for v in history[-1].values()),
              f"{label} train step {i}: losses not finite: {history[-1]}")
    counts = launch_counts(*kmods)
    check(not must_fall or history[-1][total] < history[0][total],
          f"{label} train: total loss did not fall: {history[0][total]} -> "
          f"{history[-1][total]}")
    for p in st.model.parameters():
        check(p.dtype == torch.float32 and p.grad.dtype == torch.float32,
              f"{label} train: a parameter or gradient is not float32")
    for moments in st.optimizer.inner.state.values():
        check(moments["exp_avg"].dtype == torch.float32
              and moments["exp_avg_sq"].dtype == torch.float32,
              f"{label} train: an Adam moment is not float32")
    return history, ms, counts


def first_step(conv_vae, model, images, key=(0, 0), device=None):
    """Loss pieces and gradients of the first train step (seeded weights,
    beta 1), without the update, on ``device`` (the card by default)."""
    model = model.to(device or DEVICE).train()
    x_recon, q_z, p_z, _ = model(images, key)
    losses = conv_vae.cnn_vae_loss(
        images, x_recon, q_z, p_z, model.distribution, beta=1.0,
        recon_loss_type=model.recon_loss_type, l1_weight=model.l1_weight)
    losses["total_loss"].backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


def hold_step(losses, grads, ref_losses, ref_grads, what, scales=None):
    """Hold one step's loss pieces and gradients against a reference step
    at ``TRAIN_BARS``; returns the errors.  A loss piece's error is
    relative to its reference value, or to ``scales[piece]`` where that is
    larger (the magnitude of the terms the piece is a difference of)."""
    scales = scales or {}
    loss_rel = {k: abs(losses[k] - ref_losses[k])
                / max(abs(ref_losses[k]), scales.get(k, 0.0), 1e-12)
                for k in losses}
    norm = math.sqrt(sum(g.double().pow(2).sum().item()
                         for g in ref_grads.values()))
    diff = {n: (grads[n].to(ref_grads[n].device) - ref_grads[n]).double()
            for n in grads}
    err = math.sqrt(sum(d.pow(2).sum().item() for d in diff.values()))
    worst_name, worst = max(((n, d.abs().max().item())
                             for n, d in diff.items()), key=lambda t: t[1])
    check(max(loss_rel.values()) <= TRAIN_BARS["loss_rel"],
          f"{what}: losses differ {loss_rel}")
    check(err / norm <= TRAIN_BARS["grad_l2_rel"],
          f"{what}: gradient l2 error {err / norm}")
    check(worst / norm <= TRAIN_BARS["grad_max_rel"],
          f"{what}: {worst_name} gradient error {worst / norm} of the "
          f"global norm")
    return dict(loss_rel=loss_rel, grad_norm=norm, grad_l2_rel=err / norm,
                grad_max_rel=worst / norm, grad_max_param=worst_name)


def train_check(kmods, ops_torus, conv_vae, make_model, images, label,
                bf16=True):
    """The float32 first step with the kernels against the same step with
    the plain versions, and (``bf16``) the bfloat16 one against float32."""
    attention, sampler, _ = kmods
    losses, grads = first_step(conv_vae, make_model(torch.float32), images)
    before = launch_counts(*kmods)
    with plain_versions(attention, sampler, ops_torus):
        p_losses, p_grads = first_step(conv_vae, make_model(torch.float32),
                                       images)
    check(launch_counts(*kmods) == before,
          f"{label}: the plain step launched a kernel")
    report = hold_step(losses, grads, p_losses, p_grads,
                       f"{label} float32 step, kernels vs plain")
    norm = report["grad_norm"]
    if bf16:
        bf16_losses, bf16_grads = first_step(
            conv_vae, make_model(torch.bfloat16), images)
        bf16_rel = abs(bf16_losses["total_loss"] - losses["total_loss"]) \
            / abs(losses["total_loss"])
        bf16_err = math.sqrt(sum(
            (bf16_grads[n] - grads[n]).double().pow(2).sum().item()
            for n in grads))
        report.update(bf16_loss_rel=bf16_rel,
                      bf16_grad_l2_rel=bf16_err / norm)
        check(bf16_rel <= TRAIN_BARS["bf16_loss_rel"],
              f"{label} bfloat16 first loss {bf16_losses['total_loss']} vs "
              f"float32 {losses['total_loss']}: {bf16_rel}")
        check(bf16_err / norm <= TRAIN_BARS["bf16_grad_l2_rel"],
              f"{label} bfloat16 gradients vs float32: l2 error "
              f"{bf16_err / norm} of the gradient norm")
    emit(f"{label}_check", **report, bars=TRAIN_BARS)
    return losses

def attention_route(attention, rope, gen):
    """``fused_attention`` at image 256's shape (B 4, S 260, H 8, hd 64,
    RoPE) in each dtype, with and without a gradient, and at S 400 (beyond
    the JAX package's ``attention_supported`` at 8 heads of 64) with one:
    the route and form each took (read from the counts) against the
    expected ones, and the outputs and gradients against the plain
    versions at the attention bars."""
    B, H, hd = 4, 8, 64
    # S 260: every case on the kernels, the bfloat16 forward without a
    # gradient in the whole-sequence form (it fits), the rest key-tiled;
    # S 400: the dense route for both directions
    expected = {(260, torch.float32, False): "tiled",
                (260, torch.float32, True): "tiled",
                (260, torch.bfloat16, False): "whole",
                (260, torch.bfloat16, True): "tiled",
                (400, torch.float32, True): "dense",
                (400, torch.bfloat16, True): "dense"}
    routes = {(1, 0, 0, 0, 0): "whole", (1, 0, 1, 0, 0): "tiled",
              (1, 1, 1, 1, 0): "tiled", (1, 1, 0, 0, 0): "whole",
              (0, 0, 0, 0, 1): "dense"}

    def counts():
        return (attention.launches, attention.bwd_launches,
                attention.tiled_launches, attention.tiled_bwd_launches,
                attention.dense_calls)

    rows = []
    for (S, dtype, grad), want_route in expected.items():
        grid = math.ceil(math.sqrt(S - 4))
        c, s_ = rope.rope_2d_cos_sin(256, grid, hd, cls_token_num=4)
        cos = torch.from_numpy(c).to(DEVICE)
        sin = torch.from_numpy(s_).to(DEVICE)
        q, k, v, d_out = (torch.randn(B, S, H, hd, generator=gen,
                                      device=DEVICE).to(dtype)
                          for _ in range(4))
        qg, kg, vg = (t.clone().requires_grad_(grad) for t in (q, k, v))
        before = counts()
        out = attention.fused_attention(qg, kg, vg, cos, sin)
        grads = (torch.autograd.grad(out, (qg, kg, vg), d_out) if grad
                 else None)
        torch.cuda.synchronize()
        moved = tuple(a - b for a, b in zip(counts(), before))
        route = routes.get(moved, f"counts {moved}")
        check(route == want_route, f"attention_route S={S} {dtype} "
                                   f"grad={grad}: took {route}, expected "
                                   f"{want_route}")
        want = attention.attention_plain(q, k, v, cos, sin)
        err = (out.detach().float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bar = 1e-5 if dtype == torch.float32 else 2e-2 * scale
        check(err <= bar, f"attention_route S={S} {dtype} grad={grad}: "
                          f"output error {err} > {bar}")
        row = dict(S=S, dtype=str(dtype).replace("torch.", ""), grad=grad,
                   route=route, max_abs_err=err, bar=bar)
        if grad:
            ref = attention.attention_bwd_plain(q, k, v, cos, sin, d_out)
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
                errs[name] = (a.float() - b.float()).abs().max().item()
                gbar = (1e-5 if dtype == torch.float32 else 2e-2) * max(
                    1.0, b.float().abs().max().item())
                check(errs[name] <= gbar,
                      f"attention_route S={S} {dtype}: {name} error "
                      f"{errs[name]} > {gbar}")
            row["grad_errors"] = errs
        rows.append(row)
    S = 260
    emit("attention_route", B=B, H=H, hd=hd, cases=rows,
         jax_supported={n: attention.jax_supported(n, H, hd)
                        for n in (260, 400)},
         smem_bytes={"fwd_f32": attention.smem_bytes(S, hd),
                     "fwd_bf16": attention.smem_bytes(S, hd, torch.bfloat16),
                     "bwd_f32": attention.bwd_smem_bytes(S, hd),
                     "bwd_bf16": attention.bwd_smem_bytes(
                         S, hd, torch.bfloat16),
                     "tiled_fwd_f32": attention.tiled_smem_bytes(hd),
                     "tiled_bwd_f32": attention.tiled_smem_bytes(
                         hd, torch.float32, True),
                     "tiled_fwd_bf16": attention.tiled_smem_bytes(
                         hd, torch.bfloat16),
                     "tiled_bwd_bf16": attention.tiled_smem_bytes(
                         hd, torch.bfloat16, True)},
         smem_max=attention._SMEM_MAX)


IMAGE256_BATCH = 4


def image256(vit_vae, dtype):
    """``CliffordARVAE(image_size=256)`` at ``default_config(256)``: 6
    encoder and 12 decoder blocks of S 260, clifford latent 16."""
    return vit_vae.CliffordARVAE(latent_dim=16, image_size=256,
                                 compute_dtype=dtype, seed=0)


def image256_phase(kmods, serving, vit_vae, state, loop, gen):
    """Serve one request of each entry point and take one train step per
    dtype, every attention on the kernels: float32 serving in the key-tiled
    forward, bfloat16 serving in the whole-sequence one (it fits at S
    260), and every train step in the tiled forward and backward."""
    images = torch.rand(IMAGE256_BATCH, 256, 256, 3, generator=gen,
                        device=DEVICE) * 2 - 1
    requests = {
        "bfloat16": {
            "encode_mu": (FLAGSHIP_REQUESTS["encode_mu"][0],
                          {"attention_fwd": 6}),
            "encode_z": (FLAGSHIP_REQUESTS["encode_z"][0],
                         {"attention_fwd": 6, "sampler_keyed": 1}),
            "decode": (FLAGSHIP_REQUESTS["decode"][0],
                       {"attention_fwd": 12})},
        "float32": {
            "encode_mu": (FLAGSHIP_REQUESTS["encode_mu"][0],
                          {"attention_fwd": 6, "attention_fwd_tiled": 6}),
            "encode_z": (FLAGSHIP_REQUESTS["encode_z"][0],
                         {"attention_fwd": 6, "attention_fwd_tiled": 6,
                          "sampler_keyed": 1}),
            "decode": (FLAGSHIP_REQUESTS["decode"][0],
                       {"attention_fwd": 12, "attention_fwd_tiled": 12})},
    }
    per_step = {"attention_fwd": 18, "attention_fwd_tiled": 18,
                "attention_bwd": 18, "attention_bwd_tiled": 18,
                "sampler_keyed": 1, "torus_bwd": 1}
    first, path_counts = {}, {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        srv = serving.Serving(image256(vit_vae, dtype), device=DEVICE)
        outs, lat, counts = serve(kmods, srv, images, requests[label],
                                  f"image256 {label}", rounds=1)
        check(outs["encode_z"].shape == (IMAGE256_BATCH, 256 * 32)
              and outs["decode"].shape == images.shape, "image256 shapes")
        del srv
        st = state.create_train_state(image256(vit_vae, dtype),
                                      optimizer="adamw", lr=1e-4,
                                      device=DEVICE)
        history, ms, step_counts = train(
            kmods, st, loop.make_cnn_train_step(st.model, st.optimizer),
            per_step, 0, images, f"image256 {label}", must_fall=False)
        first[label] = history[0]
        path_counts[label] = (counts, step_counts)
        emit("image256", compute_dtype=label, batch=IMAGE256_BATCH,
             tokens=260, blocks=[6, 12], serve_launches=counts,
             serve_ms={k: v[0] for k, v in lat.items()},
             train_launches=step_counts, train_step_ms=ms[0],
             losses=history[0],
             params_m=sum(p.numel() for p in st.model.parameters()) / 1e6)
        del st
        torch.cuda.empty_cache()
    rel = abs(first["bfloat16"]["total_loss"] - first["float32"][
        "total_loss"]) / abs(first["float32"]["total_loss"])
    emit("image256_check", bf16_vs_f32_loss_rel=rel, bars=TRAIN_BARS)
    check(rel <= TRAIN_BARS["bf16_loss_rel"], f"image256: bfloat16 loss vs "
                                              f"float32 {rel}")
    return path_counts


HEAD_STEPS = 3  # timed train steps of a head's path, after one warm-up
HEADS = ("gaussian", "powerspherical")
# CliffordARVAE also has the vmf head (CNNVAE has none, in JAX either)
FLAGSHIP_HEADS = HEADS + ("vmf",)


def cnn4096_head(conv_vae, dtype, head):
    return conv_vae.CNNVAE(latent_dim=CNN_LATENT, in_channels=1, img_size=32,
                           distribution=head, compute_dtype=dtype, seed=0)


def flagship_head(vit_vae, dtype, head):
    return vit_vae.CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                                 distribution=head, compute_dtype=dtype,
                                 seed=0)


def heads_phase(kmods, serving, conv_vae, vit_vae, state, loop, random,
                images, gen):
    """The gaussian and powerspherical heads of cnn4096 (no kernel of A-F
    on the path; the float32 first step against the port's own step on the
    CPU) and those and the vmf head of flagship32 (attention kernels only:
    4 / 4 / 8 per request, 12 + 12 per step)."""
    nothing = {}
    paths = {
        "cnn4096": (lambda dt, h: cnn4096_head(conv_vae, dt, h),
                    {"encode_mu": nothing, "encode_z": nothing,
                     "decode": nothing}, nothing, CNN_LATENT, 1, HEADS),
        "flagship32": (lambda dt, h: flagship_head(vit_vae, dt, h),
                       {"encode_mu": {"attention_fwd": 4},
                        "encode_z": {"attention_fwd": 4},
                        "decode": {"attention_fwd": 8}},
                       {"attention_fwd": 12, "attention_bwd": 12}, 16, 64,
                       FLAGSHIP_HEADS),
    }
    counts = {}
    for path, (make, req_counts, per_step, d, tokens, heads) in paths.items():
        requests = {name: (FLAGSHIP_REQUESTS[name][0], req_counts[name])
                    for name in ("encode_mu", "encode_z", "decode")}
        for head in heads:
            for label, dtype in (("float32", torch.float32),
                                 ("bfloat16", torch.bfloat16)):
                srv = serving.Serving(make(dtype, head), device=DEVICE)
                outs, lat, served = serve(kmods, srv, images, requests,
                                          f"{path} {head} {label}", rounds=1)
                check(outs["encode_z"].shape == (BATCH, tokens * d)
                      and outs["decode"].shape == images.shape,
                      f"{path} {head} shapes")
                del srv
                st = state.create_train_state(make(dtype, head),
                                              optimizer="adamw", lr=1e-4,
                                              device=DEVICE)
                history, ms, stepped = train(
                    kmods, st, loop.make_cnn_train_step(st.model,
                                                        st.optimizer),
                    per_step, HEAD_STEPS, images, f"{path} {head} {label}",
                    must_fall=False)
                counts[path, head, label] = (served, stepped)
                emit("heads", path=path, head=head, compute_dtype=label,
                     batch=BATCH, serve_launches=served,
                     serve_ms={k: v[0] for k, v in lat.items()},
                     steps=HEAD_STEPS, train_launches=stepped,
                     per_step_launches=per_step,
                     median_ms_per_step=statistics.median(ms[1:]),
                     min_ms_per_step=min(ms[1:]), first_ms=ms[0],
                     first_losses=history[0], last_losses=history[-1])
                del st
                torch.cuda.empty_cache()
    for head in HEADS:
        # the float32 first step on the card against the port's own step on
        # the CPU: same seeded weights, batch and key, same threefry words
        losses, grads = first_step(conv_vae, cnn4096_head(
            conv_vae, torch.float32, head), images)
        cpu_losses, cpu_grads = first_step(
            conv_vae, cnn4096_head(conv_vae, torch.float32, head),
            images.cpu(), device=torch.device("cpu"))
        # a KL against the uniform prior is -H[q] + H[uniform]: at d 4096
        # the powerspherical entropies are about -1.1e4 and cancel to about
        # 1e-3, which float32 resolves to about 1e-3 on either device, so
        # that piece is held relative to the entropy it is made from
        report = hold_step(losses, grads, cpu_losses, cpu_grads,
                           f"cnn4096 {head} float32 step, card vs CPU",
                           scales={"kld_loss": abs(cpu_losses["entropy"])})
        bf16_losses, _ = first_step(conv_vae, cnn4096_head(
            conv_vae, torch.bfloat16, head), images)
        bf16_rel = abs(bf16_losses["total_loss"] - losses["total_loss"]) \
            / abs(losses["total_loss"])
        check(bf16_rel <= TRAIN_BARS["bf16_loss_rel"],
              f"cnn4096 {head}: bfloat16 first loss vs float32 {bf16_rel}")
        emit("heads_check", path="cnn4096", head=head, card_vs_cpu=report,
             bf16_loss_rel=bf16_rel, bars=TRAIN_BARS)
    # what the threefry normals cost: the powerspherical draw of cnn4096
    # (64 rows of 4095 chi-square normals and the tangent direction)
    key = (0, 7)
    normal_ms = cuda_ms(lambda: random.normal(key, (BATCH, CNN_LATENT - 1),
                                              device=DEVICE), reps=5)
    uniform_ms = cuda_ms(lambda: random.uniform(key, (BATCH, CNN_LATENT - 1),
                                                device=DEVICE), reps=5)
    emit("threefry_cost", shape=[BATCH, CNN_LATENT - 1], normal_ms=normal_ms,
         uniform_ms=uniform_ms)
    return counts

# the MNIST runner's defaults (scripts/mnist_clifpws.py): batch 128, Adam at
# lr 1e-3 behind a clip of 1, h_dim 128, 20 trials, beta from a linear
# warmup over 100 epochs; the sweep's latent dims (cliffordtpu/configs)
MLP_BATCH = 128
MNIST_KERNEL_DIMS = (5, 40, 256)  # F and D held at R 128 at these d
MLP_LR = 1e-3
MLP_H_DIM = 128
MLP_TRIALS = 20
MLP_WARMUP_EPOCHS = 100
MLP_DIMS = (2, 5, 10, 20, 40, 128, 256)
MLP_D = 5
MLP_STEPS = 5  # timed steps of each family, after one warm-up
MLP_TRAIN, MLP_VAL, MLP_EPOCHS = 2048, 512, 2
MLP_IWAE_SAMPLES = 10
MLP_DATA_SEED = 7
# (family, l2_normalize, z_dim at d 5): the runner's powerspherical model
# is one dim wider than d
MLP_FAMILIES = (("normal", True, MLP_D), ("powerspherical", False, MLP_D + 1),
                ("vmf", False, MLP_D), ("clifford", False, MLP_D))
MLP_PER_STEP = {"sampler_keyed": 1, "torus_bwd": 1}  # clifford; others none
# fit_trials' lanes against their own sequential fit: tests/test_train.py's
# bar for the JAX loops
MLP_LANE_RTOL = 2e-4
MLP_HELD_LANES = (0, 7)
# one step of a lane against its MLPVAE on the same batch and key: a lane
# runs its model's own products and norm, bit-equal but for the loss sums'
# order (1e-7); a wrong key, slice or clip factor moves it by percents
MLP_LANE_STEP_BAR = 1e-5


def mlp_images(n):
    """Seeded synthetic digits of 784 pixels in [0, 1], from a generator of
    their own (``MLP_DATA_SEED``), whatever ran before: 10 prototypes whose
    pixels are on (0.95, with probability 0.2) or off (0.05); image i is
    prototype i % 10 plus uniform noise of +-0.05.  Binarised, they hold
    structure a step can learn (uniform noise would leave the BCE at its
    floor of 784 ln 2 from the first step)."""
    gen = torch.Generator(device=DEVICE).manual_seed(MLP_DATA_SEED)
    protos = (torch.rand(10, 784, generator=gen, device=DEVICE) < 0.2) \
        .float() * 0.9 + 0.05
    noise = (torch.rand(n, 784, generator=gen, device=DEVICE) - 0.5) * 0.1
    return (protos[torch.arange(n, device=DEVICE) % 10] + noise).clamp(0, 1)


def mlp_model(mlp_vae, dist, z_dim, l2=False, seed=0):
    return mlp_vae.MLPVAE(MLP_H_DIM, z_dim, dist, l2, seed=seed)


def mlp_first_step(loop, model, x, beta, device=None):
    """Loss pieces and gradients of the first MLP train step (key (0, 0),
    seeded weights), without the update, on ``device`` (the card by
    default)."""
    model = model.to(device or DEVICE).train()
    losses = loop.mlp_losses(model, x.to(device or DEVICE), (0, 0), beta)
    losses["total"].backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


def mlp_lane_step(loop, lanes, singles, x, rngs, beta):
    """The first train step of every lane of ``lanes`` against the same
    step of its own ``MLPVAE`` in ``singles`` on batch x[t] and rng
    rngs[t]: the loss, the gradient norm (relative) and the clipped
    gradients (largest difference over the clipped norm), each held at
    ``MLP_LANE_STEP_BAR``.  Returns the worst of each over the lanes."""
    kb, ks = loop.lane_keys([rngs], DEVICE)
    got = loop.make_lane_train_step(lanes.model, lanes.optimizer)(
        x, (kb[0], ks[0]), beta)
    lane_grads = [p.grad for p in lanes.model.parameters()]
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "grad_max_rel": 0.0}
    for t, st in enumerate(singles):
        want = loop.make_mlp_train_step(st.model, st.optimizer)(
            x[t], rngs[t], beta)
        norm = want["grad_norm"].item()
        err = dict(
            loss_rel=abs(got["total"][t].item() - want["total"].item())
            / abs(want["total"].item()),
            grad_norm_rel=abs(got["grad_norm"][t].item() - norm) / norm,
            grad_max_rel=max((g[t] - p.grad).abs().max().item()
                             for g, p in zip(lane_grads,
                                             st.model.parameters()))
            / min(norm, 1.0))  # the clipped norm
        check(max(err.values()) <= MLP_LANE_STEP_BAR,
              f"mlp fit_trials lane {t}, first step vs its MLPVAE: {err}")
        worst = {k: max(v, err[k]) for k, v in worst.items()}
    return worst


def mlp_fit_counts(n_steps, n_val_batches, lanes=1):
    """F and D launches of a fit: a draw per train and validation batch,
    a backward per train step, per lane, per epoch."""
    return {"sampler_keyed": lanes * MLP_EPOCHS * (n_steps + n_val_batches),
            "torus_bwd": lanes * MLP_EPOCHS * n_steps}


def mlp_phase(kmods, mods):
    """The MLP family at the MNIST sweep's dims: every family's step at d 5
    (launches, a falling loss, the float32 first step on the card against
    the port's CPU step), the clifford step at every d of the sweep, then
    ``fit`` and ``fit_trials`` (20 lanes) at d 5 with two lanes held
    against their own sequential ``fit``, and ``compute_test_metrics``.
    Returns the clifford launch counts per d."""
    loop, state, mlp_vae, losses, schedules, trandom = mods
    t_phase = time.perf_counter()
    images = mlp_images(MLP_TRAIN + MLP_VAL)
    x_train, x_val = images[:MLP_TRAIN], images[MLP_TRAIN:]
    batch = x_train[:MLP_BATCH]
    beta = schedules.linear_kl_warmup(0, MLP_WARMUP_EPOCHS)
    per_d = {}

    def add(d, counts):
        mine = per_d.setdefault(d, {})
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v

    for dist, l2, z_dim in MLP_FAMILIES:
        st = state.create_train_state(mlp_model(mlp_vae, dist, z_dim, l2),
                                      "adam", MLP_LR, device=DEVICE)
        per_step = MLP_PER_STEP if dist == "clifford" else {}
        history, ms, counts = train(
            kmods, st, loop.make_mlp_train_step(st.model, st.optimizer),
            per_step, MLP_STEPS, batch, f"mlp {dist}", total="total",
            beta=beta)
        if dist == "clifford":
            add(MLP_D, counts)
        card = mlp_first_step(loop, mlp_model(mlp_vae, dist, z_dim, l2),
                              batch, beta)
        cpu = mlp_first_step(loop, mlp_model(mlp_vae, dist, z_dim, l2),
                             batch.cpu(), beta, torch.device("cpu"))
        report = hold_step(*card, *cpu, f"mlp {dist} float32 step, card vs "
                                        f"CPU")
        emit("mlp", family=dist, l2_normalize=l2, z_dim=z_dim,
             batch=MLP_BATCH, steps=MLP_STEPS, beta=beta, launches=counts,
             per_step_launches=per_step,
             median_ms_per_step=statistics.median(ms[1:]),
             min_ms_per_step=min(ms[1:]), first_ms=ms[0],
             first_losses=history[0], last_losses=history[-1],
             card_vs_cpu=report, bars=TRAIN_BARS)
        del st
    sweep = {}
    for d in MLP_DIMS:
        st = state.create_train_state(mlp_model(mlp_vae, "clifford", d),
                                      "adam", MLP_LR, device=DEVICE)
        history, ms, counts = train(
            kmods, st, loop.make_mlp_train_step(st.model, st.optimizer),
            MLP_PER_STEP, 0, batch, f"mlp clifford d{d}", must_fall=False,
            total="total", beta=beta)
        add(d, counts)
        sweep[d] = dict(ms=ms[0], launches=counts,
                        total=history[0]["total"])
    emit("mlp_sweep", family="clifford", batch=MLP_BATCH, steps=sweep)

    # fit and fit_trials at d 5: one trial sequentially, 20 lanes at once
    n_steps = MLP_TRAIN // MLP_BATCH
    n_val_batches = -(-MLP_VAL // MLP_BATCH)
    kw = dict(epochs=MLP_EPOCHS, batch_size=MLP_BATCH,
              beta_fn=lambda e: schedules.linear_kl_warmup(
                  e, MLP_WARMUP_EPOCHS))
    trial_key = lambda t: (0, 1000 + t)  # noqa: E731

    def sequential(t):
        st = state.create_train_state(mlp_model(mlp_vae, "clifford", MLP_D,
                                                seed=t), "adam", MLP_LR,
                                      device=DEVICE)
        stamps = [time.perf_counter()]
        st, hist = loop.fit(
            st, loop.make_mlp_train_step(st.model, st.optimizer),
            loop.make_mlp_eval_step(st.model), trial_key(t), x_train, x_val,
            log_fn=lambda e, d: stamps.append(time.perf_counter()), **kw)
        return st, hist, [b - a for a, b in zip(stamps, stamps[1:])]

    zero_counts(*kmods)
    seq_st, seq_hist, seq_epoch_s = sequential(0)
    fit_counts = launched_since_zero(kmods)
    check(fit_counts == mlp_fit_counts(n_steps, n_val_batches),
          f"mlp fit: launches {fit_counts}")
    check(all(math.isfinite(v) for v in seq_hist["train_loss"]
              + seq_hist["val_loss"])
          and seq_hist["train_loss"][-1] < seq_hist["train_loss"][0],
          f"mlp fit: history {seq_hist}")
    add(MLP_D, fit_counts)

    def trials():
        return [state.create_train_state(mlp_model(mlp_vae, "clifford", MLP_D,
                                                   seed=t), "adam", MLP_LR,
                                         device=DEVICE)
                for t in range(MLP_TRIALS)]

    # each lane's first step on its own batch and fit's first step key
    zero_counts(*kmods)
    lane_step = mlp_lane_step(
        loop, loop.stack_trial_states(trials()), trials(),
        x_train[torch.arange(MLP_TRIALS * MLP_BATCH, device=DEVICE)
                % MLP_TRAIN].reshape(MLP_TRIALS, MLP_BATCH, -1),
        [trandom.fold_in_words(trandom.fold_in_words(trial_key(t), 0), 1)
         for t in range(MLP_TRIALS)], beta)
    add(MLP_D, launched_since_zero(kmods))
    lanes = loop.stack_trial_states(trials())
    zero_counts(*kmods)
    stamps = [time.perf_counter()]
    lanes, lane_hist = loop.fit_trials(
        lanes, [trial_key(t) for t in range(MLP_TRIALS)], x_train, x_val,
        log_fn=lambda e, d: stamps.append(time.perf_counter()), **kw)
    trial_epoch_s = [b - a for a, b in zip(stamps, stamps[1:])]
    trial_counts = launched_since_zero(kmods)
    check(trial_counts == mlp_fit_counts(n_steps, n_val_batches,
                                         MLP_TRIALS),
          f"mlp fit_trials: launches {trial_counts}")
    add(MLP_D, trial_counts)
    lane_err = {}
    for t in MLP_HELD_LANES:
        _, hist, _ = (seq_st, seq_hist, None) if t == 0 else sequential(t)
        lane_err[t] = max(abs(a - b) / abs(b) for k in ("train_loss",
                                                         "val_loss")
                          for a, b in zip(lane_hist[t][k], hist[k]))
        check(len(lane_hist[t]["val_loss"]) == len(hist["val_loss"])
              and lane_err[t] <= MLP_LANE_RTOL
              and abs(lane_hist[t]["best_val"] - hist["best_val"])
              <= MLP_LANE_RTOL * abs(hist["best_val"]),
              f"mlp fit_trials lane {t} vs its fit: {lane_hist[t]} vs "
              f"{hist}")
    zero_counts(*kmods)
    metrics = losses.compute_test_metrics(
        (0, 7), seq_st.model,
        [(x_val[s:s + MLP_BATCH], None)
         for s in range(0, MLP_VAL, MLP_BATCH)], MLP_IWAE_SAMPLES)
    check(all(math.isfinite(v) for v in metrics.values()),
          f"mlp compute_test_metrics: {metrics}")
    add(MLP_D, launched_since_zero(kmods))
    emit("mlp_fit", family="clifford", d=MLP_D, train=MLP_TRAIN,
         val=MLP_VAL, batch=MLP_BATCH, epochs=MLP_EPOCHS,
         fit_epoch_s=seq_epoch_s, fit_history=seq_hist,
         fit_launches=fit_counts, trials=MLP_TRIALS,
         fit_trials_epoch_s=trial_epoch_s,
         fit_trials_launches=trial_counts,
         lane_vs_fit_rel={str(t): v for t, v in lane_err.items()},
         lane_rtol=MLP_LANE_RTOL, lane_first_step=lane_step,
         lane_step_bar=MLP_LANE_STEP_BAR, test_metrics=metrics,
         iwae_samples=MLP_IWAE_SAMPLES,
         phase_s=time.perf_counter() - t_phase)
    return per_d


# the Fashion runner's --arch hybrid at the sweep's largest latent (4096 //
# 16 = 256 per token, 8 x 8 tokens), batch 256, AdamW lr 1e-3 behind a
# clip of 1 (powerspherical: lr 1e-4), float32
HYBRID_LATENT = 256
HYBRID_BATCH = 256
HYBRID_TOKENS = 64
HYBRID_LR = {"clifford": 1e-3, "gaussian": 1e-3, "powerspherical": 1e-4}
HYBRID_STEPS = 5  # timed clifford steps, after one warm-up
HYBRID_PER_STEP = {"sampler_keyed": 1, "torus_bwd": 1}
HYBRID_REQUESTS = {
    "encode_mu": (FLAGSHIP_REQUESTS["encode_mu"][0], {}),
    "encode_z": (FLAGSHIP_REQUESTS["encode_z"][0], {"sampler_keyed": 1}),
    "decode": (FLAGSHIP_REQUESTS["decode"][0], {}),
}
CKPT_STEPS, CKPT_SAVE_AT = 5, 3  # resume after step 3 of 5
# eval_checkpoint.py's sampled protocol: an item memory of 1000 flat
# sampled latents, 20 trials per capacity point, self-binding to depth 40
# over 10 targets, kNN on 100 / 600 / 1000 training means
EVAL_N_MEM, EVAL_TRIALS, EVAL_TRAIN = 1000, 20, 2000
EVAL_DATA_SEED = 11


def hybrid_model(hybrid_vae, head="clifford", seed=0, learn=False):
    return hybrid_vae.HybridVAE(latent_dim=HYBRID_LATENT, in_channels=1,
                                distribution=head, img_size=32,
                                use_learnable_beta=learn, seed=seed)


def labelled_images(n, seed, channels=1):
    """Seeded labelled synthetic images (n, 32, 32, channels) in [-1, 1]
    and their labels: 10 class prototypes of uniform pixels, image i is
    prototype y_i at 0.7 plus uniform noise at 0.3, y_i uniform over the
    classes."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    protos = torch.rand(10, 32, 32, channels, generator=gen,
                        device=DEVICE) * 2 - 1
    y = torch.randint(0, 10, (n,), generator=gen, device=DEVICE)
    noise = torch.rand(n, 32, 32, channels, generator=gen,
                       device=DEVICE) * 2 - 1
    return 0.7 * protos[y] + 0.3 * noise, y.cpu().numpy()


def hybrid_phase(kmods, ops_torus, serving, conv_vae, hybrid_vae, state,
                 loop, images):
    """``HybridVAE`` at the full width: the three entry points (1 F launch
    per ``encode_z``, float32 against the plain versions), clifford AdamW
    steps (1 F + 1 D each, a falling loss, the first step against the
    plain versions), then the gaussian and powerspherical heads (no
    kernel).  Returns the clifford path's launch counts and its trained
    state."""
    attention, sampler, _ = kmods
    t_phase = time.perf_counter()
    label = "hybrid_fashion4096"
    srv = serving.Serving(hybrid_model(hybrid_vae), device=DEVICE)
    outs, lat, served = serve(kmods, srv, images, HYBRID_REQUESTS, label)
    B, T, d = HYBRID_BATCH, HYBRID_TOKENS, HYBRID_LATENT
    check(outs["encode_mu"].shape == (B, T * d)
          and outs["encode_z"].shape == (B, T * 2 * d)
          and outs["decode"].shape == (B, 32, 32, 1), f"{label} shapes")
    norms = outs["encode_z"].reshape(B, T, 2 * d).norm(dim=-1)
    check((norms - 1).abs().max().item() < 1e-4,
          f"{label} encode_z: torus points are not of unit norm")
    before = launch_counts(*kmods)
    with plain_versions(attention, sampler, ops_torus), \
            torch.inference_mode():
        plain = {name: call(srv, images, (0, REQUESTS - 1), outs)
                 for name, (call, _) in HYBRID_REQUESTS.items()}
    check(launch_counts(*kmods) == before,
          f"{label}: the plain requests launched a kernel")
    serve_diffs = {k: (outs[k] - plain[k]).abs().max().item() for k in plain}
    check(max(serve_diffs.values()) <= 5e-4,
          f"{label}: serving with kernels vs plain: {serve_diffs} > 5e-4")
    del srv, outs, plain
    st = state.create_train_state(hybrid_model(hybrid_vae), "adamw",
                                  HYBRID_LR["clifford"], device=DEVICE)
    history, ms, stepped = train(
        kmods, st, loop.make_cnn_train_step(st.model, st.optimizer),
        HYBRID_PER_STEP, HYBRID_STEPS, images, f"{label} clifford")
    first = train_check(kmods, ops_torus, conv_vae,
                        lambda dtype: hybrid_model(hybrid_vae), images,
                        label, bf16=False)
    emit("hybrid", config=label, head="clifford", batch=B, tokens=T,
         latent_dim=d, lr=HYBRID_LR["clifford"], serve_launches=served,
         serve_median_ms={k: statistics.median(v[1:])
                          for k, v in lat.items()},
         serve_first_ms={k: v[0] for k, v in lat.items()},
         kernels_vs_plain_serving=serve_diffs, steps=HYBRID_STEPS,
         train_launches=stepped, per_step_launches=HYBRID_PER_STEP,
         params_m=sum(p.numel() for p in st.model.parameters()) / 1e6,
         median_ms_per_step=statistics.median(ms[1:]),
         min_ms_per_step=min(ms[1:]), first_ms=ms[0],
         first_losses=history[0], last_losses=history[-1],
         first_step_total=first["total_loss"])
    counts = {k: served.get(k, 0) + stepped.get(k, 0)
              for k in set(served) | set(stepped)}
    for head in ("gaussian", "powerspherical"):
        srv = serving.Serving(hybrid_model(hybrid_vae, head), device=DEVICE)
        h_outs, _, h_served = serve(kmods, srv, images, {
            name: (call, {}) for name, (call, _) in
            HYBRID_REQUESTS.items()}, f"{label} {head}", rounds=1)
        check(h_outs["encode_z"].shape == (B, T * d), f"{label} {head} "
                                                      f"encode_z shape")
        del srv, h_outs
        h_st = state.create_train_state(hybrid_model(hybrid_vae, head),
                                        "adamw", HYBRID_LR[head],
                                        device=DEVICE)
        h_hist, h_ms, h_stepped = train(
            kmods, h_st, loop.make_cnn_train_step(h_st.model,
                                                  h_st.optimizer),
            {}, HEAD_STEPS, images, f"{label} {head}", must_fall=False)
        emit("hybrid", config=label, head=head, batch=B,
             lr=HYBRID_LR[head], serve_launches=h_served,
             steps=HEAD_STEPS, train_launches=h_stepped,
             median_ms_per_step=statistics.median(h_ms[1:]),
             first_losses=h_hist[0], last_losses=h_hist[-1])
        del h_st
    torch.cuda.empty_cache()
    emit("hybrid_phase", seconds=time.perf_counter() - t_phase)
    return counts, st


def checkpoint_phase(kmods, checkpoint, hybrid_vae, state, loop, images,
                     root):
    """Resume on the card: ``CKPT_STEPS`` steps straight against
    ``CKPT_SAVE_AT`` steps, a save, a load into a fresh model (another
    seed) and optimizer, and the rest; losses and parameters bit-equal.
    Once with plain AdamW, once with the learnable-beta sigma group and
    two-step accumulation (the save falls in the middle of a cycle).
    Two runs of the same steps are equal bit for bit only with cuDNN's
    deterministic convolution algorithms, which the phase selects; it
    first reports whether two straight runs differ without them."""
    t_phase = time.perf_counter()
    out = os.path.join(root, "build", "chip_smoke_checkpoint")
    keys = [(0, 300 + i) for i in range(CKPT_STEPS)]
    results = {}
    saved_flags = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark)
    for name, learn, accum in (("adamw", False, 1),
                               ("sigma_group_accum2", True, 2)):
        def fresh(seed):
            return state.create_train_state(
                hybrid_model(hybrid_vae, seed=seed, learn=learn), "adamw",
                HYBRID_LR["clifford"],
                sigma_lr_scale=0.1 if learn else None, accum_steps=accum,
                device=DEVICE)

        def steps(st, ks):
            step = loop.make_cnn_train_step(st.model, st.optimizer)
            return [step(images, k, 1.0)["total_loss"] for k in ks]

        torch.backends.cudnn.deterministic = False
        twice = [steps(fresh(0), keys) for _ in range(2)]
        results[name] = dict(straight_runs_differ_without_flag=not all(
            torch.equal(a, b) for a, b in zip(*twice)))
        del twice
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        straight = fresh(0)
        want = steps(straight, keys)
        first = fresh(0)
        got = steps(first, keys[:CKPT_SAVE_AT])
        checkpoint.save_checkpoint(out, first, step=CKPT_SAVE_AT,
                                   rng_key=keys[CKPT_SAVE_AT])
        del first
        resumed = fresh(1)
        meta = checkpoint.restore_checkpoint(
            resumed, checkpoint.load_checkpoint(out))
        got += steps(resumed, keys[CKPT_SAVE_AT:])
        same_loss = all(torch.equal(a, b) for a, b in zip(got, want))
        same_params = all(torch.equal(a, b) for a, b in zip(
            resumed.model.state_dict().values(),
            straight.model.state_dict().values()))
        results[name].update(losses=[v.item() for v in got],
                             bit_equal_losses=same_loss,
                             bit_equal_params=same_params,
                             micro_step=resumed.optimizer.micro_step,
                             restored_step=meta["step"])
        check(same_loss and same_params and meta["step"] == CKPT_SAVE_AT,
              f"checkpoint {name}: resumed run differs: {results[name]}")
        checkpoint.delete_checkpoint(out)
        check(checkpoint.load_checkpoint(out) is None,
              f"checkpoint {name}: not deleted")
        del straight, resumed
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved_flags
    torch.cuda.empty_cache()
    emit("checkpoint", config="hybrid_fashion4096", steps=CKPT_STEPS,
         save_after=CKPT_SAVE_AT, runs=results,
         seconds=time.perf_counter() - t_phase)


def depth_curve_ok(curve) -> bool:
    """A binding-depth curve of cosines: finite at depth 1, every finite
    value within [-1, 1] (to rounding), and once not finite never finite
    again.  A flat latent of T unit torus points has norm sqrt(T) = 8, so
    unbinding by the involution leaves float32's range after about 40 / 4
    binds; the JAX package's curve degenerates at the same depths
    (``tests/test_torch_eval.py``)."""
    finite = [math.isfinite(v) for v in curve]
    return (finite[0] and all(abs(v) <= 1 + 1e-5 for v, f in
                              zip(curve, finite) if f)
            and finite == sorted(finite, reverse=True))


def eval_phase(kmods, mods, model):
    """The battery on the trained hybrid over seeded labelled images:
    ``collect_flat_z`` (a memory of ``EVAL_N_MEM`` flat latents of T * 2d),
    bundle and role-filler capacity, self-binding (both unbindings), the
    per-class bundle test, ``test_vsa_operations``, the pairwise and the
    cross-class decodes, kNN with the torch backend and class means.
    Every number finite, every accuracy in [0, 1].  Returns the launch
    counts."""
    adapters, binding, capacity, class_means, knn = mods
    t_phase = time.perf_counter()
    x, y = labelled_images(EVAL_TRAIN + EVAL_N_MEM, EVAL_DATA_SEED)
    x_train, y_train = x[:EVAL_TRAIN], y[:EVAL_TRAIN]
    x_test, y_test = x[EVAL_TRAIN:], y[EVAL_TRAIN:]
    handle = adapters.ModelHandle(model.eval())
    key = (0, 0)
    timings, results = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        return results[name]

    zero_counts(*kmods)
    memory, labels = timed("collect_flat_z", lambda: handle.collect_flat_z(
        x_test, y_test, key, limit=EVAL_N_MEM))
    check(memory.shape == (EVAL_N_MEM, HYBRID_TOKENS * 2 * HYBRID_LATENT)
          and bool(torch.isfinite(memory).all()),
          f"eval item memory {tuple(memory.shape)}")
    results["collect_flat_z"] = list(memory.shape)
    d_mem = memory.shape[-1]
    curves = {
        "bundle_capacity": lambda: capacity.test_bundle_capacity(
            d=d_mem, n_items=EVAL_N_MEM, n_trials=EVAL_TRIALS,
            item_memory=memory, key=key),
        "role_filler": lambda: capacity.test_binding_unbinding_pairs(
            d=d_mem, n_items=EVAL_N_MEM, n_trials=EVAL_TRIALS,
            item_memory=memory, key=key),
    }
    for name, fn in curves.items():
        res = timed(name, fn)
        check(all(0.0 <= a <= 1.0 for a in res["accuracy"])
              and all(math.isfinite(s) for s in res["std"]),
              f"eval {name}: {res}")
    for method in ("*", "†"):
        res = timed(f"self_binding[{method}]", lambda: binding
                    .test_self_binding(handle, x_test[:500], y_test[:500],
                                       unbind_method=method, key=key))
        for curve in ("k_sims", "self_k_sims"):
            check(len(res[curve]) == 40 and depth_curve_ok(res[curve]),
                  f"eval self_binding {method} {curve}: {res[curve]}")
            res[f"{curve}_finite_depths"] = sum(
                math.isfinite(v) for v in res[curve])
    res = timed("per_class", lambda: capacity
                .test_per_class_bundle_capacity_k_items(
                    d=HYBRID_LATENT, n_items=EVAL_N_MEM, n_classes=10,
                    items_per_class=1, item_memory=memory, labels=labels,
                    key=key))
    check(bool(np.isfinite(res["avg_similarity_matrix"]).all())
          and res["n_bundles"] == 10, "eval per_class")
    results["per_class"] = {"n_bundles": res["n_bundles"],
                            "diag_mean": float(np.diag(
                                res["avg_similarity_matrix"]).mean())}
    for name, fn in (
            ("vsa_operations", lambda: binding.test_vsa_operations(
                handle, x_test, y_test, key=key)),
            ("pairwise", lambda: binding.test_pairwise_bind_bundle_decode(
                handle, x_test[:500], y_test[:500], key=key)),
            ("cross_class", lambda: binding.test_cross_class_bind_unbind(
                handle, x_test[:500], y_test[:500], class_a=5, class_b=6,
                key=key))):
        res = timed(name, fn)
        check(all(math.isfinite(v) for v in res.values()
                  if isinstance(v, float)), f"eval {name}: {res}")
    res = timed("knn", lambda: knn.perform_knn_evaluation(
        handle, x_train, y_train, x_test, y_test, (100, 600, 1000),
        backend="torch", rng=np.random.default_rng(0), key=key))
    check(all(0.0 <= v <= 1.0 for v in res.values()), f"eval knn: {res}")
    acc = timed("mean_vector_cosine", lambda: class_means
                .evaluate_mean_vector_cosine(
                    handle, x_test, y_test, class_means.compute_class_means(
                        handle, x_train, y_train, key=key), key=key)[0])
    check(0.0 <= acc <= 1.0, f"eval mean_vector_cosine {acc}")
    counts = launched_since_zero(kmods)
    check(counts.get("sampler_keyed", 0) > 0,
          f"eval: the keyed sampler never launched: {counts}")
    emit("eval", config="hybrid_fashion4096", n_mem=EVAL_N_MEM,
         trials=EVAL_TRIALS, train=EVAL_TRAIN, launches=counts,
         results=results, seconds=timings,
         phase_s=time.perf_counter() - t_phase)
    return counts


# scripts/cifar10_train.py's CNN at its largest latent, scored as the CNN
# runner scores it (cnn_runner.py: compute_fid with --fid_samples 2048,
# batch 256), on seeded labelled images of CIFAR's shape
FID_LATENT = 4096
FID_SAMPLES, FID_BATCH = 2048, 256
FID_SHAPE = (32, 32, 3)
FID_DATA_SEED = 13
FID_GRID = 12  # the manifold grid: 144 rows of d 4096
FID_INTERP_PAIRS, FID_INTERP_STEPS = 5, 10
FID_BUNDLE_SAMPLES = 500
FID_ENCODE_ROWS = 200  # plot_decoded_bundles encodes 200 images at a time
INCEPTION_RATE_IMAGES = 512  # images timed through InceptionV3 alone
# prior decodes with kernel C against the plain embedding: C lies within
# 1e-5 of the plain version per coordinate (kernels phase) and the float32
# decoder (TF32 off) carries that to about that size on [0, 1] images; the
# FID, a distance between feature statistics of those images, within 1e-3
# of itself
FID_DECODE_BAR, FID_REL_BAR = 1e-4, 1e-3
# the card's InceptionV3 features against the port's CPU run of the same
# weights: 94 float32 layers (TF32 off) summed in another order, 1e-4 of
# the largest feature (the CPU tests hold the port against JAX at 1e-4 and
# measure 4e-7)
INCEPTION_CPU_BAR = 1e-4


def cifar_fid4096(conv_vae):
    return conv_vae.CNNVAE(latent_dim=FID_LATENT, in_channels=3,
                           img_size=32, distribution="clifford", seed=0)


def random_inception_npz(path, param_spec, seed=0):
    """InceptionV3 weights of the npz layout from a seed: He-scaled convs
    and an identity-like BatchNorm with a ReLU gain, so input differences
    survive all 94 layers (the recipe of tests/test_inception.py)."""
    rng = np.random.RandomState(seed)
    arrs = {}
    for key, shape in param_spec().items():
        if key.endswith("running_var"):
            arrs[key] = np.ones(shape, np.float32)
        elif key.endswith("running_mean"):
            arrs[key] = np.zeros(shape, np.float32)
        elif key.endswith("bn.weight"):
            arrs[key] = np.full(shape, 1.4, np.float32)
        elif key.endswith("bn.bias"):
            arrs[key] = (rng.randn(*shape) * 0.02).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            arrs[key] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(
                np.float32)
    np.savez(path, **arrs)
    return path


@contextlib.contextmanager
def inception_weights(path):
    """``$CLIFFORDTPU_INCEPTION`` set to ``path`` for the calls inside, or
    unset there when ``path`` is None."""
    saved = os.environ.pop("CLIFFORDTPU_INCEPTION", None)
    if path is not None:
        os.environ["CLIFFORDTPU_INCEPTION"] = path
    try:
        yield
    finally:
        os.environ.pop("CLIFFORDTPU_INCEPTION", None)
        if saved is not None:
            os.environ["CLIFFORDTPU_INCEPTION"] = saved


def canvas_ok(canvas) -> bool:
    return bool(np.isfinite(canvas).all() and canvas.min() >= 0
                and canvas.max() <= 1)


def fid_phase(kmods, mods, ops_torus, conv_vae, hybrid):
    """``cifar_fid4096`` scored on the card: ``compute_fid`` with the
    surrogate (8 prior batches of 256 through kernel C), the same with the
    plain embedding (decodes and FID held against C's), InceptionV3 on a
    seeded random-weight npz (its features on two images against the
    port's CPU run), the host Fréchet distance at 512 and 2048 features,
    the trained hybrid scored alike (per token at d 256: no kernel), then
    the device half of each plot.  Returns the launch counts of the main
    path (``compute_fid`` and the plots) and the phase's numbers."""
    adapters, fid, inception, plots = mods
    attention, sampler, _ = kmods
    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    handle = adapters.ModelHandle(cifar_fid4096(conv_vae).to(DEVICE).eval())
    x, y = labelled_images(FID_SAMPLES, FID_DATA_SEED, channels=3)
    args = (handle, x, "clifford", FID_LATENT)
    kw = dict(in_channels=3, n_samples=FID_SAMPLES, batch_size=FID_BATCH,
              key=(0, 0))
    with inception_weights(None):
        zero_counts(*kmods)
        res = timed("compute_fid", lambda: fid.compute_fid(*args, **kw))
        counts = launched_since_zero(kmods)
        n_batches = FID_SAMPLES // FID_BATCH
        check(counts == {"torus_fwd": n_batches},
              f"fid: compute_fid launched {counts}, expected "
              f"{n_batches} torus_fwd (one per prior batch)")
        check(res["fid_features"] == "random_conv"
              and math.isfinite(res["fid"]), f"fid: {res}")
        try:  # "inception" without an npz raises, never a surrogate
            fid.compute_fid(*args, **{**kw, "n_samples": FID_BATCH},
                            feature_extractor="inception")
            check(False, "fid: inception without an npz did not raise")
        except RuntimeError as e:
            check("CLIFFORDTPU_INCEPTION" in str(e), f"fid: {e}")
        fakes = timed("prior_decodes", lambda: fid.prior_decodes(
            handle, "clifford", FID_LATENT, FID_SAMPLES, FID_BATCH, (0, 0),
            FID_SHAPE))
        with plain_versions(attention, sampler, ops_torus):
            before = launch_counts(*kmods)
            plain_fakes = timed("prior_decodes_plain", lambda: fid
                                .prior_decodes(handle, "clifford", FID_LATENT,
                                               FID_SAMPLES, FID_BATCH, (0, 0),
                                               FID_SHAPE))
            plain = fid.compute_fid(*args, **kw)
            check(launch_counts(*kmods) == before,
                  "fid: the plain run launched a kernel")
    decode_err = float(np.abs(fakes - plain_fakes).max())
    fid_rel = abs(res["fid"] - plain["fid"]) / abs(plain["fid"])
    check(fakes.shape == (FID_SAMPLES, *FID_SHAPE) and canvas_ok(fakes),
          "fid: prior decodes not finite images in [0, 1]")
    check(decode_err <= FID_DECODE_BAR,
          f"fid: decodes with C vs plain: {decode_err} > {FID_DECODE_BAR}")
    check(fid_rel <= FID_REL_BAR,
          f"fid: FID with C vs plain: {fid_rel} > {FID_REL_BAR} relative")
    real01 = np.clip(x.cpu().numpy() * 0.5 + 0.5, 0, 1)
    f_real = timed("random_conv_real", lambda: fid._get_features(
        real01, "random_conv", device=DEVICE))
    f_fake = fid._get_features(fakes, "random_conv", device=DEVICE)
    stats = (f_real.mean(0), np.cov(f_real, rowvar=False), f_fake.mean(0),
             np.cov(f_fake, rowvar=False))
    surrogate = timed("frechet_512", lambda: fid._frechet(*stats))
    check(abs(surrogate - res["fid"]) <= FID_REL_BAR * abs(res["fid"]),
          f"fid: the surrogate FID {surrogate} again vs {res['fid']}")

    with tempfile.TemporaryDirectory() as tmp:
        npz = random_inception_npz(os.path.join(tmp, "inception.npz"),
                                   inception.param_spec)
        with inception_weights(npz):
            net = timed("inception_load", lambda: fid.inception_net(DEVICE))
            inc = timed("compute_fid_inception", lambda: fid.compute_fid(
                *args, **kw))
            # the rate once cuDNN has chosen its algorithms for every layer
            feats = timed("inception_rate", lambda: inception
                          .inception_features(
                              real01[:INCEPTION_RATE_IMAGES], net))
        check(inc["fid_features"] == "inception"
              and math.isfinite(inc["fid"]), f"fid inception: {inc}")
        cpu_net = inception.InceptionV3Features(
            inception.load_inception_params(npz), "cpu")
        on_cpu = inception.inception_features(real01[:2], cpu_net, batch=2)
    inc_err = float(np.abs(feats[:2] - on_cpu).max() / np.abs(on_cpu).max())
    check(feats.shape == (INCEPTION_RATE_IMAGES, inception.FEATURE_DIM)
          and bool(np.isfinite(feats).all()), "fid: inception features")
    check(inc_err <= INCEPTION_CPU_BAR, f"fid: inception features on the "
          f"card vs the CPU: {inc_err} > {INCEPTION_CPU_BAR} of the scale")
    # the host Fréchet distance at 2048 features (two eigh of 2048 x 2048)
    inc_stats = (feats.mean(0), np.cov(feats, rowvar=False))
    timed("frechet_2048", lambda: fid._frechet(*inc_stats, *inc_stats))
    del net, cpu_net, feats
    fid._INCEPTION_CACHE.clear()

    hx, _ = labelled_images(FID_SAMPLES, FID_DATA_SEED + 1)
    hybrid_handle = adapters.ModelHandle(hybrid.eval())
    zero_counts(*kmods)
    hyb = timed("compute_fid_hybrid", lambda: fid.compute_fid(
        hybrid_handle, hx, "clifford", hybrid.latent_dim, in_channels=1,
        n_samples=FID_SAMPLES, batch_size=FID_BATCH, key=(0, 0),
        feature_extractor="random_conv"))
    check(math.isfinite(hyb["fid"]) and not launched_since_zero(kmods),
          f"fid hybrid: {hyb}, launches {launched_since_zero(kmods)}")

    zero_counts(*kmods)
    pairs = plots.get_fixed_interp_pairs(x[:200], y[:200],
                                         n_pairs=FID_INTERP_PAIRS)
    canvases = {
        "manifold": lambda: plots.clifford_manifold_canvas(
            handle, FID_GRID, img_shape=FID_SHAPE),
        "prior_samples": lambda: plots.prior_sample_canvas(
            handle, 64, img_shape=FID_SHAPE),
        "reconstructions": lambda: plots.reconstructions_canvas(
            handle, x, img_shape=FID_SHAPE),
        "interpolations": lambda: plots.interpolations_canvas(
            handle, x, y, img_shape=FID_SHAPE),
        "latent_interpolations": lambda: plots.latent_interpolation_canvases(
            handle, pairs, FID_INTERP_STEPS, img_shape=FID_SHAPE),
        "decoded_bundles": lambda: plots.decoded_bundle_images(
            handle, x, y, FID_BUNDLE_SAMPLES)[0],
    }
    shapes = {}
    for name, fn in canvases.items():
        out = timed(f"plot_{name}", fn)
        for label, canvas in ({f"{name}[{k}]": v for k, v in out.items()}
                              .items() if isinstance(out, dict)
                              else ((name, out),)):
            check(canvas_ok(canvas), f"fid plot {label}: not finite in "
                                     f"[0, 1]")
            shapes[label] = list(canvas.shape)
    plot_counts = launched_since_zero(kmods)
    check(set(plot_counts) == {"torus_fwd", "sampler_keyed"},
          f"fid plots: launches {plot_counts}")
    counts = {k: counts.get(k, 0) + plot_counts.get(k, 0)
              for k in set(counts) | set(plot_counts)}
    del handle, hybrid_handle
    torch.cuda.empty_cache()
    emit("fid", config="cifar_fid4096", latent_dim=FID_LATENT,
         n_samples=FID_SAMPLES, batch=FID_BATCH, fid_random_conv=res["fid"],
         fid_random_conv_plain=plain["fid"], fid_rel_kernel_vs_plain=fid_rel,
         decode_err_kernel_vs_plain=decode_err,
         fid_inception_random_weights=inc["fid"],
         fid_features={"surrogate": res["fid_features"],
                       "inception": "inception (random weights)"},
         inception_images_per_s=INCEPTION_RATE_IMAGES
         / secs["inception_rate"], inception_card_vs_cpu=inc_err,
         fid_hybrid=hyb["fid"], launches=counts, plot_launches=plot_counts,
         canvases=shapes, seconds=secs,
         phase_s=time.perf_counter() - t_phase)
    return counts


# the runner phase: the Fashion runner's CNN at the sweep's largest latent
# (scripts/fashion_train.py --arch cnn --latent_dims 4096, batch 256), run
# as a user runs it, through cliffordtpu_torch.runners.cnn_runner
RUNNER_LATENT, RUNNER_BATCH = 4096, 256
RUNNER_FASHION_EPOCHS = 2
# the committed shard: 1500 train and 297 test digits
RUNNER_SHARD_TRAIN, RUNNER_SHARD_TEST = 1500, 297
RUNNER_CIFAR_TRAIN, RUNNER_CIFAR_TEST = 1024, 512


def runner_argv(script, epochs, *extra):
    """A runner's command line: clifford at ``RUNNER_LATENT``, batch
    ``RUNNER_BATCH``, one trial, no early stop; the card unless the phase
    runs elsewhere (``DEVICE``)."""
    return ([] if script == "cifar10" else ["--dataset", "mnist32",
                                            "--arch", "cnn"]) + [
        "--latent_dims", str(RUNNER_LATENT), "--distributions", "clifford",
        "--batch_size", str(RUNNER_BATCH), "--epochs", str(epochs),
        "--n_trials", "1", "--patience", "0", "--no_wandb", *extra] + (
        [] if DEVICE.type == "cuda" else ["--device", str(DEVICE)])

# the Fashion runner's other arms, one epoch each on the shard at latent
# 128, the battery in process: the hybrid (64 tokens of 8) and the ViT
# (flagship32's blocks, S 68: kernels A and B)
RUNNER_ARMS, ARM_LATENT = ("hybrid", "vit"), 128


def arm_argv(arch, outdir):
    return ["--dataset", "mnist32", "--arch", arch, "--latent_dims",
            str(ARM_LATENT), "--distributions", "clifford", "--epochs", "1",
            "--batch_size", str(RUNNER_BATCH), "--n_trials", "1",
            "--require_real", "--limit_test", str(RUNNER_SHARD_TEST),
            "--no_wandb", "--outdir", outdir] + (
        [] if DEVICE.type == "cuda" else ["--device", str(DEVICE)])


def epoch_seconds(text):
    """The epoch times a CNN runner printed."""
    return [float(ln.rsplit("(", 1)[1].rstrip("s)"))
            for ln in text.splitlines() if ln.startswith("epoch ")]


RUNNER_STEP_TIMES = 5  # timed steps of the runner's step, after a warm-up
# the runner's one epoch with the kernels against the same epoch with the
# plain versions, same initial weights, cuDNN deterministic: best loss
RUNNER_LOSS_REL = 1e-4
# stages whose host drawing half may fail on the card, and only for want
# of these modules (matplotlib is replaced by PLOT_RECORDER, so of the
# drawing halves only t-SNE, scikit-learn's, is left)
HOST_DRAWING_STAGES = {"tsne": ("sklearn",)}
# a stand-in for matplotlib that the phase puts first on the path, of its
# own process and of the eval_checkpoint child: every call is accepted and
# ignored, except that an image shown must be finite
PLOT_RECORDER = {
    "__init__.py": '''"""A stand-in for matplotlib (chip_smoke's runner phase)."""


def use(*args, **kw):
    pass
''',
    "pyplot.py": '''"""A recorder in place of pyplot: calls are accepted and ignored; an
image shown must be finite."""
import numpy as np


class _Rec:
    def __init__(self, *args, **kw):
        pass

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self

    def __call__(self, *args, **kw):
        return self

    def __getitem__(self, idx):
        return self

    def imshow(self, img, *args, **kw):
        if not np.isfinite(np.asarray(img, np.float64)).all():
            raise ValueError("an image shown is not finite")
        return self


def subplots(nrows=1, ncols=1, **kw):
    if nrows == ncols == 1:
        return _Rec(), _Rec()
    axes = np.empty((nrows, ncols), object)
    for idx in np.ndindex(axes.shape):
        axes[idx] = _Rec()
    return _Rec(), axes.squeeze()


def imshow(img, *args, **kw):
    return _Rec().imshow(img)


def __getattr__(name):
    return _Rec()
''',
    "gridspec.py": '''"""GridSpec of the pyplot recorder."""
from matplotlib.pyplot import _Rec as GridSpec  # noqa: F401
'''}


@contextlib.contextmanager
def plot_recorder(tmp):
    """``PLOT_RECORDER`` written under ``tmp`` and put first on the path of
    this process and, through ``$PYTHONPATH``, of its children."""
    base = os.path.join(tmp, "plot_recorder")
    os.makedirs(os.path.join(base, "matplotlib"))
    for name, text in PLOT_RECORDER.items():
        with open(os.path.join(base, "matplotlib", name), "w") as f:
            f.write(text)
    saved_env = os.environ.get("PYTHONPATH")
    saved_mods = {k: sys.modules.pop(k) for k in list(sys.modules)
                  if k.split(".")[0] == "matplotlib"}
    sys.path.insert(0, base)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (base, saved_env) if p)
    try:
        yield
    finally:
        sys.path.remove(base)
        for k in [k for k in sys.modules if k.split(".")[0] == "matplotlib"]:
            del sys.modules[k]
        sys.modules.update(saved_mods)
        if saved_env is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_env


def stage_warnings(text):
    """The runner's ``warning:`` lines, split into those of the host
    drawing stages that failed for want of a listed module, and the
    rest."""
    allowed, other = [], []
    for line in text.splitlines():
        if not line.startswith("warning:"):
            continue
        label = line[len("warning: "):].split(" failed", 1)[0]
        mods = HOST_DRAWING_STAGES.get(label, ())
        if "ModuleNotFoundError" in line and any(
                f"'{m}" in line for m in mods):
            allowed.append(line)
        else:
            other.append(line)
    return allowed, other


def runner_artifacts_ok(outdir, dataset, source, label, latent=None):
    """The runner's artifact set under ``outdir`` at ``latent`` (by default
    ``RUNNER_LATENT``), every battery number filled in; returns (metrics,
    timing)."""
    latent = latent or RUNNER_LATENT
    exp_dir = os.path.join(outdir, "results",
                           f"{dataset}-clifford-d{latent}-l1")
    with open(os.path.join(exp_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(exp_dir, "vsa_raw.json")) as f:
        vsa = json.load(f)
    for curve in ("bundle_cap", "role_filler"):
        check(bool(vsa[curve]["k"]) and all(
            0 <= a <= 1 for a in vsa[curve]["accuracy"]),
            f"{label}: vsa_raw {curve} empty or out of [0, 1]")
    for sb in ("self_binding_star", "self_binding_dagger"):
        check(bool(vsa[sb]["k_sims"]), f"{label}: vsa_raw {sb} empty")
    for n in (100, 600, 1000):
        acc = metrics.get(f"knn_acc_{n}")
        check(acc is not None and math.isfinite(acc) and 0 <= acc <= 1,
              f"{label}: knn_acc_{n} = {acc}")
    mvc = metrics["mean_vector_cosine_acc"]
    check(0 < mvc <= 1, f"{label}: mean_vector_cosine_acc = {mvc}")
    check(math.isfinite(metrics.get("generation_fid", float("nan")))
          and metrics["fid_features"] != "failed",
          f"{label}: generation FID {metrics.get('generation_fid')} "
          f"({metrics['fid_features']})")
    check(math.isfinite(metrics["final_best_total_loss"]),
          f"{label}: best loss {metrics['final_best_total_loss']}")
    with open(os.path.join(outdir, f"{dataset}_results.csv")) as f:
        csv_text = f.read()
    check(f"\n{latent},clifford," in csv_text,
          f"{label}: no {latent},clifford row in the CSV")
    comp = os.path.join(outdir, "results", "comparisons", dataset)
    with open(os.path.join(comp, f"dim{latent}_data.json")) as f:
        dim = json.load(f)
    check({"clifford", "random_hrr", "unitary"} <= set(dim),
          f"{label}: dim{latent}_data.json holds {sorted(dim)}")
    check(os.path.exists(os.path.join(comp, "across_dims_data.json")),
          f"{label}: no across_dims_data.json")
    timing_name = "fashion_train" if dataset == "mnist32" else \
        "cifar10_train"
    with open(os.path.join(outdir, f"{timing_name}_timing.json")) as f:
        timing = json.load(f)
    check(timing["data_source"] == source,
          f"{label}: data_source {timing['data_source']}, expected {source}")
    return metrics, timing


def runner_phase(kmods, mods, root):
    """``run_cnn_experiments`` as the two scripts call it, on the card:
    the Fashion runner on the committed MNIST shard (``--dataset mnist32``,
    in process) and the CIFAR-10 runner on its synthetic fallback with
    ``--eval_subprocess`` (the battery in the port's ``eval_checkpoint``
    child, on the card), both ``CNNVAE`` at latent 4096 and batch 256;
    pyplot replaced by ``PLOT_RECORDER``.  Checks the launches of F, D and
    C in each run, the artifacts, that no stage failed but those of
    ``HOST_DRAWING_STAGES`` (whose device halves it runs itself), and one
    epoch of ``train_model`` with the kernels against the plain versions.
    Returns the launches of the two runs and the child's, and the
    phase's numbers."""
    from cliffordtpu_torch.data import loaders

    (cnn_runner, fashion_train, cifar10_train, plots, conv_vae, loop, state,
     trandom, ops_torus) = mods
    attention, sampler, _ = kmods
    t_phase = time.perf_counter()
    stage_s, handles, children = {}, [], []
    real_safe_eval = cnn_runner.safe_eval
    real_handle = cnn_runner.ModelHandle
    real_subprocess = cnn_runner.subprocess

    def timed_safe_eval(label, fn, default=None):
        t0 = time.perf_counter()
        out = real_safe_eval(label, fn, default)
        torch.cuda.synchronize()
        stage_s[label] = stage_s.get(label, 0.0) + time.perf_counter() - t0
        return out

    def recorded_handle(model):
        handles.append(real_handle(model))
        return handles[-1]

    def recorded_run(cmd, **kw):
        t0 = time.perf_counter()
        r = real_subprocess.run(cmd, **kw)
        children.append((r, time.perf_counter() - t0))
        return r

    def run(script, argv, dataset, timing):
        args = script.build_parser().parse_args(argv)
        zero_counts(*kmods)
        stage_s.clear()
        buf = io.StringIO()
        cwd = os.getcwd()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cnn_runner.run_cnn_experiments(
                    args, dataset, timing, full_eval=dataset != "cifar10")
        finally:
            os.chdir(cwd)
            sys.stdout.write(buf.getvalue())
        torch.cuda.synchronize()
        return (buf.getvalue(), launched_since_zero(kmods),
                time.perf_counter() - t0, dict(stage_s))

    data_dir = os.path.join(root, "tests", "data")
    saved_data = os.environ.get("CLIFFORDTPU_DATA_DIR")
    os.environ["CLIFFORDTPU_DATA_DIR"] = data_dir
    cnn_runner.safe_eval = timed_safe_eval
    cnn_runner.ModelHandle = recorded_handle
    cnn_runner.subprocess = types.SimpleNamespace(run=recorded_run)
    out, arms = {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp, plot_recorder(tmp):
            fashion_dir = os.path.join(tmp, "fashion")
            text1, counts1, wall1, stages1 = run(
                fashion_train, runner_argv(
                    "fashion", RUNNER_FASHION_EPOCHS, "--outdir",
                    fashion_dir), "mnist32", "fashion_train")
            metrics1, timing1 = runner_artifacts_ok(
                fashion_dir, "mnist32", "real", "runner fashion")
            # the cifar10 run is held to the synthetic fallback: CIFAR-10
            # files in a directory the loader searches would change it
            check(loaders._find_real("cifar10") is None,
                  "runner: CIFAR-10 files found where the loader looks "
                  "($CLIFFORDTPU_DATA_DIR, ./data or the loader's fixed "
                  "data directory); this phase expects none, so that its "
                  "cifar10 run trains on the synthetic fallback")
            cifar_dir = os.path.join(tmp, "cifar")
            text2, counts2, wall2, stages2 = run(
                cifar10_train, runner_argv(
                    "cifar10", 1, "--limit_train", str(RUNNER_CIFAR_TRAIN),
                    "--limit_test", str(RUNNER_CIFAR_TEST),
                    "--eval_subprocess", "--outdir", cifar_dir),
                "cifar10", "cifar10_train")
            metrics2, timing2 = runner_artifacts_ok(
                cifar_dir, "cifar10", "synthetic",
                "runner cifar10 --eval_subprocess")
            check(len(children) == 1, f"runner: {len(children)} eval "
                                      f"children, expected 1")
            child, child_s = children[0]
            check(child.returncode == 0, f"runner: eval_checkpoint child "
                                         f"rc {child.returncode}: "
                                         f"{child.stderr[-2000:]}")
            launch_line = [ln for ln in child.stdout.splitlines()
                           if ln.startswith("kernel launches: ")]
            check(len(launch_line) == 1, "runner: the child printed no "
                                         "kernel launches")
            counts_child = {k: v for k, v in json.loads(
                launch_line[0][len("kernel launches: "):]).items() if v}
            allowed, other = stage_warnings(text1 + text2 + child.stdout)
            check(not other, f"runner: stages failed: {other}")

            # each run's launches: D once a train step, F at least once a
            # train step and a test batch, C once a prior batch of the FID
            steps1 = RUNNER_FASHION_EPOCHS * (RUNNER_SHARD_TRAIN
                                              // RUNNER_BATCH)
            test1 = RUNNER_FASHION_EPOCHS * -(-RUNNER_SHARD_TEST
                                              // RUNNER_BATCH)
            steps2 = RUNNER_CIFAR_TRAIN // RUNNER_BATCH
            test2 = -(-RUNNER_CIFAR_TEST // RUNNER_BATCH)
            # compute_fid's prior batches of 256 (the runner's batch_size)
            fid1 = -(-min(2048, RUNNER_SHARD_TEST) // FID_BATCH)
            fid2 = -(-min(2048, RUNNER_CIFAR_TEST) // FID_BATCH)
            for label, counts, steps, test, fid in (
                    ("fashion", counts1, steps1, test1, fid1),
                    ("cifar10 parent", counts2, steps2, test2, 0),
                    ("cifar10 child", counts_child, 0, 0, fid2)):
                check(set(counts) <= {"sampler_keyed", "torus_bwd",
                                      "torus_fwd"},
                      f"runner {label}: launches {counts}")
                check(counts.get("torus_bwd", 0) == steps,
                      f"runner {label}: {counts.get('torus_bwd', 0)} "
                      f"torus_bwd, expected {steps} (one a train step)")
                least = max(1, steps + test)
                check(counts.get("sampler_keyed", 0) >= least,
                      f"runner {label}: {counts.get('sampler_keyed', 0)} "
                      f"sampler_keyed, expected at least {least}")
                check(counts.get("torus_fwd", 0) >= fid,
                      f"runner {label}: {counts.get('torus_fwd', 0)} "
                      f"torus_fwd, expected at least {fid}")

            # the device halves of the listed stages (and of the other
            # plots) on the trained fashion model
            handle = handles[0]
            ds = cnn_runner.load_dataset("mnist32")
            x, y = ds["x_test"], ds["y_test"]
            ekey = (0, 0)
            pairs = plots.get_fixed_interp_pairs(x, y, n_pairs=5, seed=42)
            halves = {
                "reconstructions": lambda: plots.reconstructions_canvas(
                    handle, x, img_shape=(32, 32, 1), key=ekey),
                "tsne": lambda: plots.latent_space_points(
                    handle, x, y, n_plot=len(x), key=ekey)[0],
                "decoded_bundles": lambda: plots.decoded_bundle_images(
                    handle, x, y, n_samples=len(x), key=ekey)[0],
                "latent_interpolations": lambda: plots
                .latent_interpolation_canvases(handle, pairs, 10,
                                               img_shape=(32, 32, 1),
                                               key=ekey),
            }
            halves_ok = {}
            for name, fn in halves.items():
                got = fn()
                got = list(got.values()) if isinstance(got, dict) else [got]
                ok = all(np.isfinite(g).all() if name == "tsne"
                         else canvas_ok(g) for g in got)
                check(ok, f"runner: the device half of {name} is not "
                          f"finite (in [0, 1])")
                halves_ok[name] = [list(np.shape(g)) for g in got]
            del handles[:], handle

            # the other arms: the hybrid (F, D) and the ViT (A, B, F, D)
            steps = RUNNER_SHARD_TRAIN // RUNNER_BATCH
            tests = -(-RUNNER_SHARD_TEST // RUNNER_BATCH)
            for arch in RUNNER_ARMS:
                adir = os.path.join(tmp, arch)
                text, counts, wall, stages = run(
                    fashion_train, arm_argv(arch, adir), "mnist32",
                    "fashion_train")
                del handles[:]
                metrics, _ = runner_artifacts_ok(
                    adir, "mnist32", "real", f"runner {arch}",
                    latent=ARM_LATENT)
                arm_allowed, arm_other = stage_warnings(text)
                check(not arm_other, f"runner {arch}: stages failed: "
                                     f"{arm_other}")
                allowed += arm_allowed
                attn = {"attention_fwd", "attention_bwd"}
                check(set(counts) <= {"sampler_keyed", "torus_bwd",
                                      "torus_fwd"}
                      | (attn if arch == "vit" else set()),
                      f"runner {arch}: launches {counts} (a dense "
                      f"attention call or another kernel)")
                check(counts.get("torus_bwd", 0) == steps
                      and counts.get("sampler_keyed", 0) >= steps + tests,
                      f"runner {arch}: launches {counts}, expected "
                      f"{steps} torus_bwd and at least {steps + tests} "
                      f"sampler_keyed")
                if arch == "vit":
                    per = PER_STEP["attention_bwd"]
                    check(counts.get("attention_bwd", 0) == per * steps
                          and counts.get("attention_fwd", 0)
                          >= PER_STEP["attention_fwd"] * steps,
                          f"runner vit: launches {counts}, expected "
                          f"{per * steps} attention_bwd")
                arms[arch] = dict(launches=counts, wall_s=wall,
                                  epoch_s=epoch_seconds(text),
                                  stage_s=stages, metrics=metrics)

            # the runner's step at batch 256: host wall and device time
            args = fashion_train.build_parser().parse_args(
                runner_argv("fashion", 1))
            ds_train = torch.as_tensor(ds["x_train"][:RUNNER_BATCH],
                                       device=DEVICE)
            model = cnn_runner.build_model(args, "clifford", RUNNER_LATENT,
                                           1, seed=0)
            st = state.create_train_state(model, "adamw", lr=args.lr,
                                          device=DEVICE)
            step = loop.make_cnn_train_step(st.model, st.optimizer)
            beta = torch.full((), 0.1, device=DEVICE)
            ms = []
            for i in range(RUNNER_STEP_TIMES + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(ds_train, trandom.sample_key((0, i)), beta)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            busy = cuda_ms(lambda: step(ds_train, (0, 99), beta), reps=5,
                           inner=3)
            del st, model, step
            out["step"] = dict(wall_ms=statistics.median(ms[1:]),
                               wall_ms_min=min(ms[1:]), first_ms=ms[0],
                               busy_ms=busy)

            # one epoch of the runner's training with the kernels and with
            # the plain versions, the same initial weights
            args = fashion_train.build_parser().parse_args(
                runner_argv("fashion", 1))
            args.cur_lr = args.lr
            run_key = (0, 2024)
            init = cnn_runner.build_model(args, "clifford", RUNNER_LATENT, 1,
                                          seed=7).state_dict()
            bests = {}
            saved_det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                for label in ("kernels", "plain"):
                    model = cnn_runner.build_model(args, "clifford",
                                                   RUNNER_LATENT, 1)
                    model.load_state_dict(init)
                    with contextlib.ExitStack() as stack:
                        if label == "plain":
                            stack.enter_context(plain_versions(
                                attention, sampler, ops_torus))
                        zero_counts(*kmods)
                        with contextlib.redirect_stdout(io.StringIO()):
                            _, bests[label], _ = cnn_runner.train_model(
                                args, model, ds["x_train"], ds["x_test"],
                                run_key)
                        launched = launched_since_zero(kmods)
                    check(bool(launched) == (label == "kernels"),
                          f"runner train_model {label}: launches {launched}")
                    del model
            finally:
                torch.backends.cudnn.deterministic = saved_det
            loss_rel = abs(bests["kernels"] - bests["plain"]) \
                / abs(bests["plain"])
            check(loss_rel <= RUNNER_LOSS_REL,
                  f"runner: one epoch with the kernels vs plain: best loss "
                  f"{bests} apart by {loss_rel} > {RUNNER_LOSS_REL}")
    finally:
        cnn_runner.safe_eval = real_safe_eval
        cnn_runner.ModelHandle = real_handle
        cnn_runner.subprocess = real_subprocess
        if saved_data is None:
            os.environ.pop("CLIFFORDTPU_DATA_DIR", None)
        else:
            os.environ["CLIFFORDTPU_DATA_DIR"] = saved_data
        torch.cuda.empty_cache()

    epochs = epoch_seconds(text1)
    emit("runner_host_stages", host_drawing_stages={
        k: list(v) for k, v in HOST_DRAWING_STAGES.items()},
        failed_as_listed=allowed, pyplot="recorder (PLOT_RECORDER)",
        device_halves=halves_ok)
    emit("runner_step", config="runner_fashion4096", batch=RUNNER_BATCH,
         latent_dim=RUNNER_LATENT, **out["step"])
    emit("runner_epochs", fashion_epoch_s=epochs,
         fashion_train_s=[v["train_time_s"] for k, v in timing1.items()
                          if isinstance(v, dict)],
         cifar10_train_s=[v["train_time_s"] for k, v in timing2.items()
                          if isinstance(v, dict)])
    emit("runner_battery", fashion_stage_s=stages1,
         fashion_eval_s=[v["eval_time_s"] for v in timing1.values()
                         if isinstance(v, dict)],
         cifar10_subprocess_eval_s=child_s,
         cifar10_eval_s=[v["eval_time_s"] for v in timing2.values()
                         if isinstance(v, dict)])
    counts = {k: counts1.get(k, 0) + counts2.get(k, 0)
              + counts_child.get(k, 0)
              for k in set(counts1) | set(counts2) | set(counts_child)}
    emit("runner", config="runner_fashion4096", latent_dim=RUNNER_LATENT,
         batch=RUNNER_BATCH, fashion_wall_s=wall1, cifar10_wall_s=wall2,
         launches={"fashion": counts1, "cifar10": counts2,
                   "cifar10_child": counts_child},
         train_model_best={**bests, "rel": loss_rel},
         fashion_metrics=metrics1, cifar10_metrics=metrics2,
         phase_s=time.perf_counter() - t_phase)
    for arch, arm in arms.items():
        emit("runner_arm", arch=arch, config=f"runner_{arch}{ARM_LATENT}",
             latent_dim=ARM_LATENT, batch=RUNNER_BATCH, **arm)
    return counts, {arch: arm["launches"] for arch, arm in arms.items()}


# the mnist_runners phase: both MNIST runners as a user runs them, on the
# committed shard (1500 train digits: 1350 to train, 150 to validate; 297
# test digits), through cliffordtpu_torch/scripts/mnist_{clifpws,vmf}.py
MNIST_RUNNER_DIMS = (5, 256)  # the sweep's widest latent at h_dim 128
MNIST_RUNNER_LANES = 2
MNIST_RUNNER_EPOCHS = {"clifpws": 3, "clifpws_subprocess": 2, "vmf": 3}
# the digits the runs take: the whole shard (a CPU rehearsal takes fewer)
MNIST_TRAIN, MNIST_TEST = RUNNER_SHARD_TRAIN, RUNNER_SHARD_TEST
# one epoch of fit_trials on the clifford cell at d 5 with the kernels
# against the same epoch with the plain versions: best validation loss
MNIST_RUNNER_LOSS_REL = 1e-4
MNIST_FAMILY_DIRS = {"normal": "gaussian", "normal_nol2": "gaussian_nol2",
                     "powerspherical": "powerspherical",
                     "clifford": "clifford"}


def mnist_runner_runs():
    """(label, script name, argv) of the phase's three runs."""
    lanes = ["--n_runs", str(MNIST_RUNNER_LANES), "--vmap_trials",
             "--no_wandb"] + mnist_runner_extra()
    return [
        ("clifpws", "mnist_clifpws",
         ["--d_dims", *map(str, MNIST_RUNNER_DIMS), "--epochs",
          str(MNIST_RUNNER_EPOCHS["clifpws"]), "--warmup_epochs", "1",
          "--full_eval_runs", "1", "--require_real"] + lanes),
        ("clifpws_subprocess", "mnist_clifpws",
         ["--d_dims", str(MNIST_RUNNER_DIMS[0]), "--epochs",
          str(MNIST_RUNNER_EPOCHS["clifpws_subprocess"]),
          "--full_eval_runs", "1", "--eval_subprocess",
          "--distributions", "clifford"] + lanes),
        ("vmf", "mnist_vmf",
         ["--d_dims", str(MNIST_RUNNER_DIMS[0]), "--epochs",
          str(MNIST_RUNNER_EPOCHS["vmf"])] + lanes),
    ]


def mnist_trial_ok(outdir, dist_dir, d, trial, heavy, label):
    """One trial's dumps: kNN accuracies in steps of one test digit, the
    curves filled in on a heavy trial and empty beyond ``--full_eval_runs``,
    the losses and the mean-vector cosine finite.  Returns the metrics."""
    tdir = os.path.join(outdir, "results",
                        f"mnist-{dist_dir}-d{d}-l1-trial{trial}")
    check(os.path.isdir(tdir), f"{label}: no {tdir}")
    with open(os.path.join(tdir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(tdir, "vsa_raw.json")) as f:
        vsa = json.load(f)
    accs = {k: v for k, v in metrics.items() if k.startswith("knn_acc_")}
    check(len(accs) == 3 and all(
        abs(a * MNIST_TEST - round(a * MNIST_TEST)) < 1e-6
        for a in accs.values()),
        f"{label} {dist_dir} d{d} trial {trial}: kNN accuracies {accs} are "
        f"not multiples of 1/{MNIST_TEST}")
    for k in ("test/ll", "final_val_loss", "mean_vector_cosine_acc"):
        check(math.isfinite(metrics[k]),
              f"{label} {dist_dir} d{d} trial {trial}: {k} {metrics[k]}")
    curves = [vsa["bundle_cap"]["k"], vsa["role_filler"]["k"],
              vsa["self_binding_star"]["k_sims"],
              vsa["self_binding_dagger"]["k_sims"]]
    if heavy:
        check(all(curves), f"{label} {dist_dir} d{d} trial {trial}: an "
                           f"empty curve in vsa_raw")
    else:
        check(not vsa["bundle_cap"]["k"],
              f"{label} {dist_dir} d{d} trial {trial}: beyond "
              f"--full_eval_runs the battery must be skipped")
    return metrics


def mnist_runners_phase(kmods, mods, root):
    """``mnist_clifpws`` and ``mnist_vmf`` as a user runs them, on the card,
    on the committed shard: every family at d 5 and 256 in process; the
    clifford cell at d 5 with ``--eval_subprocess`` (the battery in the
    port's ``eval_checkpoint`` child, on the card; trial 2 takes
    ``--table_only``); the vMF runner at d 5 in process; pyplot replaced
    by ``PLOT_RECORDER``.  Checks the artifacts, F and D on every clifford
    lane (D once a lane step, F once a lane step and at least once an
    encoded eval batch), nothing launched by the other families, that no
    stage failed but those of ``HOST_DRAWING_STAGES``, and one epoch of
    ``fit_trials`` with the kernels against the plain versions.  Returns
    the launches per d of the in-process clifford cells."""
    (cnn_runner, mnist_runner, mnist_clifpws, mnist_vmf, mlp_vae,
     ops_torus) = mods
    attention, sampler, _ = kmods
    t_phase = time.perf_counter()
    stage_s, children, fits, per_d = {}, [], [], {}
    real = dict(clif_eval=mnist_clifpws.safe_eval,
                vmf_eval=mnist_vmf.safe_eval,
                subprocess=cnn_runner.subprocess,
                fit_trials=mnist_runner.fit_trials,
                merge=mnist_clifpws.merge_json_write)

    def timed_safe_eval(label, fn, default=None):
        t0 = time.perf_counter()
        out = real["clif_eval"](label, fn, default)
        torch.cuda.synchronize()
        stage_s[label] = stage_s.get(label, 0.0) + time.perf_counter() - t0
        return out

    def recorded_run(cmd, **kw):
        t0 = time.perf_counter()
        r = real["subprocess"].run(cmd, **kw)
        children.append((r, time.perf_counter() - t0))
        return r

    def timed_fit_trials(states, keys, x_train, *a, log_fn=None, **kw):
        stamps = [time.perf_counter()]

        def log(epoch, m):  # after the epoch's one copy to the host
            stamps.append(time.perf_counter())
            if log_fn:
                log_fn(epoch, m)

        out = real["fit_trials"](states, keys, x_train, *a, log_fn=log, **kw)
        lm = states.model
        lane_steps = (lm.lanes * (len(x_train) // kw["batch_size"])
                      * (len(stamps) - 1))
        fits.append(dict(
            dist=lm.distribution, z_dim=lm.z_dim, lanes=lm.lanes,
            epoch_s=[b - a for a, b in zip(stamps, stamps[1:])],
            trial_steps_per_s=lane_steps / (stamps[-1] - stamps[0])))
        return out

    def recording_merge(path, data):
        # the sidecar is written once a d, after all of that d's cells
        if path == mnist_clifpws.SIDECAR:
            d = int(next(iter(data)).split("|")[0])
            per_d[d] = launched_since_zero(kmods)
            zero_counts(*kmods)
        return real["merge"](path, data)

    def run(label, script, argv):
        args = script.build_parser().parse_args(argv)
        zero_counts(*kmods)
        stage_s.clear()
        del fits[:]
        buf = io.StringIO()
        cwd = os.getcwd()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                script.run(args)
        finally:
            os.chdir(cwd)
            sys.stdout.write(buf.getvalue())
        torch.cuda.synchronize()
        return dict(text=buf.getvalue(), launches=launched_since_zero(kmods),
                    wall_s=time.perf_counter() - t0, stage_s=dict(stage_s),
                    fits=list(fits))

    data_dir = os.path.join(root, "tests", "data")
    saved_data = os.environ.get("CLIFFORDTPU_DATA_DIR")
    os.environ["CLIFFORDTPU_DATA_DIR"] = data_dir
    mnist_clifpws.safe_eval = mnist_vmf.safe_eval = timed_safe_eval
    cnn_runner.subprocess = types.SimpleNamespace(run=recorded_run)
    mnist_runner.fit_trials = timed_fit_trials
    mnist_clifpws.merge_json_write = recording_merge
    runs, allowed = {}, []
    scripts = {"mnist_clifpws": mnist_clifpws, "mnist_vmf": mnist_vmf}
    try:
        with tempfile.TemporaryDirectory() as tmp, plot_recorder(tmp):
            for label, name, argv in mnist_runner_runs():
                outdir = os.path.join(tmp, label)
                per_d.clear()
                runs[label] = run(label, scripts[name],
                                  argv + ["--outdir", outdir])
                runs[label]["per_d"] = dict(per_d)
                runs[label]["outdir"] = outdir
            child_text = ""
            for r, _ in children:
                check(r.returncode == 0, f"mnist_runners: eval_checkpoint "
                                         f"child rc {r.returncode}: "
                                         f"{r.stderr[-2000:]}")
                child_text += r.stdout
            ok, other = stage_warnings(
                "".join(r["text"] for r in runs.values()) + child_text)
            check(not other, f"mnist_runners: stages failed: {other}")
            allowed += ok

            # run 1: every family at both d, in process
            r1 = runs["clifpws"]
            with open(os.path.join(r1["outdir"],
                                   mnist_clifpws.TIMING)) as f:
                timing1 = json.load(f)
            check(timing1["data_source"] == "real",
                  f"mnist_clifpws: data_source {timing1['data_source']}")
            metrics = {}
            for d in MNIST_RUNNER_DIMS:
                for dist, dist_dir in MNIST_FAMILY_DIRS.items():
                    for t in range(1, MNIST_RUNNER_LANES + 1):
                        metrics[dist, d, t] = mnist_trial_ok(
                            r1["outdir"], dist_dir, d, t, t == 1,
                            "mnist_clifpws")
            with open(os.path.join(r1["outdir"],
                                   "mnist_vae_results.csv")) as f:
                csv_rows = [ln.split(",") for ln in f.read().splitlines()]
            header = csv_rows[0]
            groups = [g.upper() for g in mnist_clifpws.DISTRIBUTIONS]
            check([row[0] for row in csv_rows[1:]]
                  == [str(d) for d in MNIST_RUNNER_DIMS]
                  and all(f"{g}_{m}" in header for g in groups
                          for m in ("acc_1000", "mvc", "ll"))
                  and all("N/A" not in row for row in csv_rows[1:]),
                  f"mnist_clifpws: mnist_vae_results.csv {csv_rows}")
            for name in ("mnist_vae_trial_metrics.json",
                         "results/comparisons/mnist/mnist_results.csv",
                         "results/comparisons/mnist/mnist_results.tex",
                         "results/comparisons/mnist/mnist_results_stats.csv"):
                check(os.path.exists(os.path.join(r1["outdir"], name)),
                      f"mnist_clifpws: no {name}")

            # run 2: the clifford cell with the battery in the child
            r2 = runs["clifpws_subprocess"]
            with open(os.path.join(r2["outdir"],
                                   mnist_clifpws.TIMING)) as f:
                check(json.load(f)["data_source"] == "real",
                      "mnist_clifpws --eval_subprocess: not the shard")
            for t in range(1, MNIST_RUNNER_LANES + 1):
                mnist_trial_ok(r2["outdir"], "clifford",
                               MNIST_RUNNER_DIMS[0], t, t == 1,
                               "mnist_clifpws --eval_subprocess")
            check(len(children) == MNIST_RUNNER_LANES,
                  f"mnist_runners: {len(children)} eval children, "
                  f"expected {MNIST_RUNNER_LANES}")
            child_counts = []
            for r, _ in children:
                line = [ln for ln in r.stdout.splitlines()
                        if ln.startswith("kernel launches: ")]
                check(len(line) == 1, "mnist_runners: a child printed no "
                                      "kernel launches")
                child_counts.append({k: v for k, v in json.loads(
                    line[0][len("kernel launches: "):]).items() if v})

            # run 3: the vMF runner, every trial's battery in process
            r3 = runs["vmf"]
            for t in range(1, MNIST_RUNNER_LANES + 1):
                mnist_trial_ok(r3["outdir"], "vmf", MNIST_RUNNER_DIMS[0], t,
                               True, "mnist_vmf")
            with open(os.path.join(r3["outdir"],
                                   "mnist_vmf_results.csv")) as f:
                vmf_csv = f.read().splitlines()
            check(len(vmf_csv) == 2 and vmf_csv[1].startswith(
                f"{MNIST_RUNNER_DIMS[0]},") and "N/A" not in vmf_csv[1],
                f"mnist_vmf: mnist_vmf_results.csv {vmf_csv}")

            # F and D on every clifford lane, and nowhere else
            steps = {}
            for label, r in runs.items():
                for fit in r["fits"]:
                    check(fit["lanes"] == MNIST_RUNNER_LANES,
                          f"{label}: fit_trials over {fit['lanes']} lanes")
            n_fit = int(0.9 * MNIST_TRAIN)
            n_val, n_test = MNIST_TRAIN - n_fit, MNIST_TEST
            for label, bs, test_bs in (("clifpws", 128, 512),
                                       ("clifpws_subprocess", 128, 512)):
                lane_steps = (MNIST_RUNNER_LANES * MNIST_RUNNER_EPOCHS[label]
                              * (n_fit // bs))
                val = (MNIST_RUNNER_LANES * MNIST_RUNNER_EPOCHS[label]
                       * -(-n_val // bs))
                tests = MNIST_RUNNER_LANES * -(-n_test // test_bs)
                steps[label] = lane_steps
                for d, counts in runs[label]["per_d"].items():
                    check(set(counts) <= {"sampler_keyed", "torus_bwd"}
                          and counts.get("torus_bwd", 0) == lane_steps
                          and counts.get("sampler_keyed", 0)
                          >= lane_steps + val + tests,
                          f"{label} d{d}: launches {counts}, expected "
                          f"{lane_steps} torus_bwd and at least "
                          f"{lane_steps + val + tests} sampler_keyed")
            check(runs["vmf"]["launches"] == {},
                  f"mnist_vmf: launches {runs['vmf']['launches']}")
            # the heavy child encodes sampled latents (F); the table
            # feed's kNN and class means read posterior means (none)
            check(child_counts[0].get("sampler_keyed", 0) > 0 and all(
                set(c) <= {"sampler_keyed"} for c in child_counts),
                f"mnist_runners: the children launched {child_counts}")

            # one epoch of fit_trials, kernels against plain versions
            args = mnist_clifpws.build_parser().parse_args(
                ["--epochs", "1"] + mnist_runner_extra())
            data = mnist_runner.load_mnist(args, require_real=True)
            keys = [mnist_clifpws.run_key(0, MNIST_RUNNER_DIMS[0], r,
                                          "clifford")
                    for r in range(MNIST_RUNNER_LANES)]
            bests, held = {}, {}
            saved_det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                for label in ("kernels", "plain"):
                    with contextlib.ExitStack() as stack:
                        if label == "plain":
                            stack.enter_context(plain_versions(
                                attention, sampler, ops_torus))
                        zero_counts(*kmods)
                        with contextlib.redirect_stdout(io.StringIO()):
                            _, hists, _ = mnist_runner.train_lanes(
                                args, lambda seed: mlp_vae.MLPVAE(
                                    128, MNIST_RUNNER_DIMS[0], "clifford",
                                    seed=seed), keys, data,
                                types.SimpleNamespace(use=False), DEVICE)
                        held[label] = launched_since_zero(kmods)
                    bests[label] = [h["best_val"] for h in hists]
            finally:
                torch.backends.cudnn.deterministic = saved_det
            check(bool(held["kernels"]) and not held["plain"],
                  f"mnist_runners fit_trials: launches {held}")
            fit_rel = max(abs(a - b) / abs(b) for a, b in
                          zip(bests["kernels"], bests["plain"]))
            check(fit_rel <= MNIST_RUNNER_LOSS_REL,
                  f"mnist_runners: fit_trials with the kernels vs plain: "
                  f"best validation losses {bests} apart by {fit_rel}")
    finally:
        mnist_clifpws.safe_eval = real["clif_eval"]
        mnist_vmf.safe_eval = real["vmf_eval"]
        cnn_runner.subprocess = real["subprocess"]
        mnist_runner.fit_trials = real["fit_trials"]
        mnist_clifpws.merge_json_write = real["merge"]
        if saved_data is None:
            os.environ.pop("CLIFFORDTPU_DATA_DIR", None)
        else:
            os.environ["CLIFFORDTPU_DATA_DIR"] = saved_data
        torch.cuda.empty_cache()

    rates = {f"{f['dist']},z{f['z_dim']}": f["trial_steps_per_s"]
             for f in runs["clifpws"]["fits"]}
    emit("mnist_runners_fit_trials", lanes=MNIST_RUNNER_LANES,
         trial_steps_per_s={str(d): rates[f"clifford,z{d}"]
                            for d in MNIST_RUNNER_DIMS},
         every_cell_trial_steps_per_s=rates,
         epoch_s={label: {f"{f['dist']},z{f['z_dim']}": f["epoch_s"]
                          for f in r["fits"]} for label, r in runs.items()})
    emit("mnist_runners_battery",
         stage_s={label: r["stage_s"] for label, r in runs.items()},
         child_s=[secs for _, secs in children],
         failed_as_listed=allowed, pyplot="recorder (PLOT_RECORDER)")
    emit("mnist_runners",
         run_s={label: r["wall_s"] for label, r in runs.items()},
         launches={label: {str(d): c for d, c in r["per_d"].items()}
                   or r["launches"] for label, r in runs.items()},
         child_launches=child_counts, lane_steps=steps,
         fit_trials_best_val={**bests, "rel": fit_rel},
         metrics_d5_trial1={dist: metrics[dist, MNIST_RUNNER_DIMS[0], 1]
                            for dist in MNIST_FAMILY_DIRS},
         phase_s=time.perf_counter() - t_phase)
    return runs["clifpws"]["per_d"]


def mnist_runner_extra():
    """The flags of every run beyond the phase's own: the device and the
    digits' limits where the phase runs elsewhere or on fewer digits."""
    return ([] if DEVICE.type == "cuda" else ["--device", str(DEVICE)]) + (
        [] if (MNIST_TRAIN, MNIST_TEST) == (RUNNER_SHARD_TRAIN,
                                            RUNNER_SHARD_TEST)
        else ["--limit_train", str(MNIST_TRAIN), "--limit_test",
              str(MNIST_TEST)])


# the sweep phase: the port's process-isolated sweep driver
# (cliffordtpu_torch/scripts/sweep.py) as a user runs it, on the shard:
# the Fashion runner's cnn arm, clifford at d 128, each trial one child
# process on the card; then a second invocation that must skip every
# trial, and trial 1 again in process (with a gaussian run beside it,
# whose checkpoint the figures phase reads)
SWEEP_LATENT, SWEEP_TRIALS, SWEEP_EPOCHS = 128, 2, 2
SWEEP_VSA_TRIALS, SWEEP_FID_SAMPLES = 2, 256
# the shelled trial against the same trial in process: best loss
SWEEP_LOSS_REL = 1e-4


def sweep_passthrough():
    """The runner flags after the sweep's ``--``."""
    return ["--arch", "cnn", "--epochs", str(SWEEP_EPOCHS), "--batch_size",
            str(RUNNER_BATCH), "--vsa_trials", str(SWEEP_VSA_TRIALS),
            "--fid_samples", str(SWEEP_FID_SAMPLES), "--patience", "0",
            "--keep_ckpts", "--require_real"]


@contextlib.contextmanager
def fresh_process_tf32():
    """PyTorch's TF32 settings of a fresh process, as the sweep's runner
    children have them (``main`` turns TF32 off for its comparisons):
    float32 matmuls at full precision, cuDNN convolutions in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def run_sweep(outdir, root):
    """One invocation of the sweep entry point in a process of its own;
    returns (its output, seconds)."""
    cmd = [sys.executable, "-m", "cliffordtpu_torch.scripts.sweep",
           "--runner", "fashion_train", "--dataset", "mnist32", "--outdir",
           outdir, "--distributions", "clifford", "--latent_dims",
           str(SWEEP_LATENT), "--n_trials", str(SWEEP_TRIALS),
           "--trial_timeout", "600"] + (
        [] if DEVICE.type == "cuda" else ["--device", str(DEVICE)]) + [
        "--"] + sweep_passthrough()
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                       timeout=1200)
    sys.stdout.write(r.stdout)
    check(r.returncode == 0, f"sweep: rc {r.returncode}: "
                             f"{(r.stdout + r.stderr)[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def sweep_phase(kmods, mods, root, work):
    """``python -m cliffordtpu_torch.scripts.sweep`` on the shard: two
    trials, each a runner child on the card that prints its launches as
    its last line; the summary, the aggregated CSV and the across-dims
    table; a second invocation launches no child; trial 1 in process
    equals the shelled one.  pyplot is ``PLOT_RECORDER`` (in the
    children through ``$PYTHONPATH``).  Returns the launches (children and
    the in-process run), the two checkpoints and the phase's numbers."""
    cnn_runner, fashion_train = mods
    t_phase = time.perf_counter()
    steps = SWEEP_EPOCHS * (RUNNER_SHARD_TRAIN // RUNNER_BATCH)
    tests = SWEEP_EPOCHS * -(-RUNNER_SHARD_TEST // RUNNER_BATCH)
    outdir = os.path.join(work, "sweep")
    saved_data = os.environ.get("CLIFFORDTPU_DATA_DIR")
    os.environ["CLIFFORDTPU_DATA_DIR"] = os.path.join(root, "tests", "data")
    try:
        with plot_recorder(os.path.join(work, "sweep_recorder")):
            text1, wall1 = run_sweep(outdir, root)
            with open(os.path.join(outdir, "sweep_summary.json")) as f:
                summary = json.load(f)
            check((summary["n_ok"], summary["n_failed"]) == (SWEEP_TRIALS, 0),
                  f"sweep: summary {summary}")
            exps = [f"mnist32-clifford-d{SWEEP_LATENT}-l1-trial{t}"
                    for t in range(1, SWEEP_TRIALS + 1)]
            children, trials = {}, {}
            for t in summary["trials"]:
                with open(t["log"]) as f:
                    lines = f.read().splitlines()
                check(bool(lines) and lines[-1].startswith(
                    "kernel launches: "), f"sweep: {t['exp']}: no kernel "
                                          f"launches line")
                counts = {k: v for k, v in json.loads(
                    lines[-1][len("kernel launches: "):]).items() if v}
                allowed, other = stage_warnings("\n".join(lines))
                check(not other, f"sweep {t['exp']}: stages failed: {other}")
                check(set(counts) == {"sampler_keyed", "torus_bwd"}
                      and counts["torus_bwd"] == steps
                      and counts["sampler_keyed"] >= steps + tests,
                      f"sweep {t['exp']}: launches {counts}, expected "
                      f"{steps} torus_bwd and at least {steps + tests} "
                      f"sampler_keyed")
                children[t["exp"]] = counts
                with open(os.path.join(outdir, "results", t["exp"],
                                       "metrics.json")) as f:
                    trials[t["exp"]] = json.load(f)
            check(sorted(children) == exps, f"sweep: trials {sorted(children)}")
            with open(os.path.join(outdir, "mnist32_results.csv")) as f:
                csv_text = f.read()
            check(f"\n{SWEEP_LATENT},clifford," in csv_text
                  and "±" in csv_text, f"sweep: CSV {csv_text!r}")
            comp = os.path.join(outdir, "results", "comparisons", "mnist32")
            check(os.path.exists(os.path.join(comp, "mnist32_results.tex")),
                  "sweep: no across-dims table")
            with open(os.path.join(outdir, "fashion_train_timing.json")) as f:
                timing = json.load(f)
            check(set(exps) <= set(timing), f"sweep: timing keys {timing}")

            # the same command again: both trials skipped, no child
            text2, wall2 = run_sweep(outdir, root)
            with open(os.path.join(outdir, "sweep_summary.json")) as f:
                again = json.load(f)
            check(again["n_skipped"] == SWEEP_TRIALS and again["n_ok"] == 0
                  and "[run ]" not in text2,
                  f"sweep: the second invocation ran a trial: {again}")

            # trial 1 in process, with the sweep child's arguments, and a
            # gaussian run beside it (its checkpoint for the figures)
            args = fashion_train.build_parser().parse_args(
                ["--dataset", "mnist32", "--outdir",
                 os.path.join(work, "inproc"), "--distributions",
                 "clifford", "gaussian", "--latent_dims", str(SWEEP_LATENT),
                 "--n_trials", "1", "--start_trial", "1", "--seed", "0",
                 "--no_wandb", "--force_trial_suffix"]
                + sweep_passthrough() + (
                    [] if DEVICE.type == "cuda" else ["--device",
                                                      str(DEVICE)]))
            zero_counts(*kmods)
            buf = io.StringIO()
            cwd = os.getcwd()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf), fresh_process_tf32():
                    cnn_runner.run_cnn_experiments(args, "mnist32",
                                                   "fashion_train",
                                                   full_eval=True)
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t0
            inproc = launched_since_zero(kmods)
            _, other = stage_warnings(buf.getvalue())
            check(not other, f"sweep in process: stages failed: {other}")
            check(set(inproc) == {"sampler_keyed", "torus_bwd"}
                  and inproc["torus_bwd"] == steps,
                  f"sweep in process: launches {inproc}, expected {steps} "
                  f"torus_bwd (clifford only)")
            with open(os.path.join(work, "inproc", "results", exps[0],
                                   "metrics.json")) as f:
                m_in = json.load(f)
    finally:
        if saved_data is None:
            os.environ.pop("CLIFFORDTPU_DATA_DIR", None)
        else:
            os.environ["CLIFFORDTPU_DATA_DIR"] = saved_data
        torch.cuda.empty_cache()
    shelled = trials[exps[0]]["final_best_total_loss"]
    loss_rel = abs(shelled - m_in["final_best_total_loss"]) / abs(shelled)
    check(loss_rel <= SWEEP_LOSS_REL,
          f"sweep: shelled trial 1 best loss {shelled} vs in process "
          f"{m_in['final_best_total_loss']}: {loss_rel} > {SWEEP_LOSS_REL}")
    ckpts = {"clifford": os.path.join(outdir, "results", exps[0]),
             "gaussian": os.path.join(
                 work, "inproc", "results",
                 f"mnist32-gaussian-d{SWEEP_LATENT}-l1-trial1")}
    for dist, path in ckpts.items():
        check(os.path.exists(os.path.join(path, "best_model.ckpt")),
              f"sweep: no {dist} checkpoint under {path}")
    counts = dict(inproc)
    for c in children.values():
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    emit("sweep", config=f"sweep_cnn{SWEEP_LATENT}", trials=SWEEP_TRIALS,
         epochs=SWEEP_EPOCHS, batch=RUNNER_BATCH,
         launches={"children": children, "in_process": inproc},
         trial_s={t["exp"]: t["seconds"] for t in summary["trials"]},
         sweep_s=wall1, resume_s=wall2, in_process_s=wall3,
         best_loss={"shelled": shelled,
                    "in_process": m_in["final_best_total_loss"],
                    "rel": loss_rel,
                    "exact": shelled == m_in["final_best_total_loss"]},
         metrics={k: {m: v[m] for m in ("knn_acc_1000",
                                        "mean_vector_cosine_acc",
                                        "generation_fid")}
                  for k, v in trials.items()},
         phase_s=time.perf_counter() - t_phase)
    return counts, ckpts


# the figures phase: the figure scripts' device work on the card under
# PLOT_RECORDER: the three heatmaps at reduced dims, sample_viz (one keyed
# draw of 4000 rows at d 4: kernel F), the pairwise bind / bundle figure
# on the sweep phase's two checkpoints, and eval_battery_timing at the
# reference's config
FIG_DIMS, FIG_ITEMS, FIG_TRIALS, FIG_DEPTH = [64, 256], 1000, 4, 20


def figures_phase(kmods, mods, ckpts, work):
    """The figure entry points on the card; checks every matrix, F's one
    launch in ``sample_viz`` and none elsewhere but the clifford model's
    encodes.  Returns ``sample_viz``'s launches."""
    (bundle_heatmap, rolefiller_heatmap, binding_depth_heatmap, sample_viz,
     paper_bind_bundle_figure, eval_battery_timing) = mods
    t_phase = time.perf_counter()
    dev = [] if DEVICE.type == "cuda" else ["--device", str(DEVICE)]
    out, launches, seconds = {}, {}, {}
    with plot_recorder(os.path.join(work, "figures_recorder")):
        for name, mod in (("bundle", bundle_heatmap),
                          ("rolefiller", rolefiller_heatmap),
                          ("depth", binding_depth_heatmap)):
            args = mod.build_parser().parse_args(
                ["--dims", *map(str, FIG_DIMS), "--n_trials",
                 str(FIG_TRIALS)] + (["--max_depth", str(FIG_DEPTH)]
                                     if name == "depth" else
                                     ["--n_items", str(FIG_ITEMS)]) + dev)
            zero_counts(*kmods)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = mod.compute(args)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = launched_since_zero(kmods)
            mats = res[0] if name == "depth" else res
            lo = -1.0 - 1e-5 if name == "depth" else 0.0
            for init, mat in mats.items():
                vals = mat[~np.isnan(mat)]
                check(mat.shape[0] == len(FIG_DIMS) and vals.size > 0
                      and bool(((vals >= lo) & (vals <= 1 + 1e-5)).all()),
                      f"figures {name} {init}: matrix {mat}")
            out[name] = {init: np.round(mat, 4).tolist()
                         for init, mat in mats.items()}
            check(not launches[name], f"figures {name}: launches "
                                      f"{launches[name]}")

        zero_counts(*kmods)
        t0 = time.perf_counter()
        sample_viz.main(["--out", os.path.join(work, "sample_viz.png")]
                        + dev)
        torch.cuda.synchronize()
        seconds["sample_viz"] = time.perf_counter() - t0
        launches["sample_viz"] = launched_since_zero(kmods)
        check(launches["sample_viz"] == {"sampler_keyed": 1},
              f"figures sample_viz: launches {launches['sample_viz']}, "
              f"expected one sampler_keyed")
        pts = sample_viz.column_points((0, 0), 5.0, 4, DEVICE)
        check(all(p.shape == (sample_viz.N_SAMPLES, 3)
                  and np.isfinite(p).all() for p in pts.values()),
              "figures sample_viz: points not finite")

        zero_counts(*kmods)
        t0 = time.perf_counter()
        panels = paper_bind_bundle_figure.main(
            ["--clifford_ckpt", ckpts["clifford"], "--gaussian_ckpt",
             ckpts["gaussian"], "--latent_dim", str(SWEEP_LATENT),
             "--output", os.path.join(work, "bind_bundle.png")] + dev)
        torch.cuda.synchronize()
        seconds["paper_bind_bundle_figure"] = time.perf_counter() - t0
        launches["paper_bind_bundle_figure"] = launched_since_zero(kmods)
        sims = {label: sim for label, _, sim in panels}
        check(all(math.isfinite(v) and -1 <= v <= 1 for v in sims.values())
              and set(launches["paper_bind_bundle_figure"])
              == {"sampler_keyed"},
              f"figures paper_bind_bundle_figure: sims {sims}, launches "
              f"{launches['paper_bind_bundle_figure']}")

        zero_counts(*kmods)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_battery_timing.main(["--device", str(DEVICE)])
        line = buf.getvalue().strip().splitlines()[-1]
        print(line, flush=True)
        battery = json.loads(line)
        check(battery["backend"] == DEVICE.type
              and battery["battery_warm_s"] > 0,
              f"figures eval_battery_timing: {battery}")
        launches["eval_battery_timing"] = launched_since_zero(kmods)
    emit("figures", dims=FIG_DIMS, n_items=FIG_ITEMS, n_trials=FIG_TRIALS,
         max_depth=FIG_DEPTH, matrices=out, launches=launches,
         seconds=seconds, pairwise_unbind_sim=sims,
         eval_battery_timing=battery, phase_s=time.perf_counter() - t_phase)
    return launches["sample_viz"]


EXPORT_BATCHES = (1, 8, 64)  # requests through one program per function
EXPORT_REQUESTS = 10  # timed batch-64 requests per function, after one
EXPORT_BAR = 1e-5  # float32 bundle vs in-process Serving, relative
EXPORT_BF16_BAR = 1e-2  # bfloat16 compute: the same ops, another process
# storage modes of params.npz against the float32 bundle: the largest
# encode_mu error relative to its largest magnitude, and how much
# params.npz must shrink (the JAX package's bars, tests/test_export.py)
EXPORT_QUANT = {"bfloat16": (5e-3, 1.6), "int8": (5e-2, 2.5)}
EXPORT_PT2_SHARE = 0.05  # each program below this share of params.npz
EXPORT_SEED = 17
EXPORT_FLAGSHIP = {"encode_mu": {"attention_fwd": 4},
                   "encode_z": {"attention_fwd": 4, "sampler_keyed": 1},
                   "decode": {"attention_fwd": 8}}
EXPORT_CNN = {"encode_mu": {}, "encode_z": {"sampler_keyed": 1},
              "decode": {}}


def export_child(spec_path: str) -> int:
    """The loading side of the export phase, in a process of its own that
    imports the kernels' operators and ``serving`` and no model code: load
    each bundle on the card, answer the requests of ``spec_path`` at every
    batch through one program per function, count the launches per
    request, time the batch-64 requests; write the answers to an npz and
    print one JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cliffordtpu_torch import kernels, serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    inputs = np.load(spec["inputs"])
    device = torch.device(spec["device"])
    out, report = {}, {}
    for name, d in spec["bundles"].items():
        t0 = time.perf_counter()
        ld = serving.load_serving(d, device)
        load_s = time.perf_counter() - t0
        launches, ms = {}, {}
        for b in spec["batches"]:
            x = inputs["x"][:b]
            for fn in ("encode_mu", "encode_z", "decode"):
                before = kernels.launch_counts()
                if fn == "encode_mu":
                    y = ld.encode_mu(x)
                elif fn == "encode_z":
                    y = ld.encode_z((0, b), x)
                else:
                    y = ld.decode(out[f"{name}/encode_z/{b}"])
                out[f"{name}/{fn}/{b}"] = y.float().cpu().numpy()
                launches[f"{fn}/{b}"] = moved_counts(
                    before, kernels.launch_counts())
        x = inputs["x"]
        z = torch.as_tensor(out[f"{name}/encode_z/{x.shape[0]}"],
                            device=device)
        calls = (("encode_mu", lambda: ld.encode_mu(x)),
                 ("encode_z", lambda: ld.encode_z((0, 1), x)),
                 ("decode", lambda: ld.decode(z)))
        for fn, call in calls:
            ms[fn] = request_ms(call, device)
        # the same requests without the programs' per-call input checks
        # (``validate_inputs``), to see what those checks cost; kept on
        # for every other request
        unchecked = {}
        for fn, call in calls:
            program = ld._program(fn, ld.device)
            if hasattr(program, "validate_inputs"):
                program.validate_inputs = False
                unchecked[fn] = request_ms(call, device)
                program.validate_inputs = True
        report[name] = {"load_s": load_s, "launches": launches,
                        "batch64_ms": ms, "batch64_unchecked_ms": unchecked}
    np.savez(spec["outputs"], **out)
    print(json.dumps({"bundles": report, "model_modules": [
        m for m in sys.modules if m.startswith("cliffordtpu_torch.nn")]}),
        flush=True)
    return 0


def request_ms(call, device) -> float:
    """Median host wall time of one request with its results on the card
    (synchronised), after one warm-up request."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    times = []
    for _ in range(EXPORT_REQUESTS):
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def export_phase(mods, root, work):
    """flagship32 (float32 and bfloat16 compute) and cnn4096 exported for
    "cuda", loaded in a child process with no model code, held against
    in-process ``Serving`` on the same weights and keys at batch 1, 8 and
    64; the storage modes of params.npz; the programs' sizes; batch-64
    request times of both.  Returns the child's launches per bundle."""
    serving, vit_vae, conv_vae, trandom = mods
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(EXPORT_SEED)
    images = (torch.rand(max(EXPORT_BATCHES), 32, 32, 1, generator=gen,
                         device=DEVICE) * 2 - 1).cpu().numpy()
    inputs = os.path.join(work, "export_inputs.npz")
    np.savez(inputs, x=images)
    models = {
        "flagship32_f32": (flagship(vit_vae, torch.float32), EXPORT_FLAGSHIP),
        "flagship32_bf16": (flagship(vit_vae, torch.bfloat16),
                            EXPORT_FLAGSHIP),
        "cnn4096_f32": (cnn4096(conv_vae, torch.float32), EXPORT_CNN)}
    bundles, export_s, sizes = {}, {}, {}
    storage = [(name, mode) for name in ("flagship32_f32", "cnn4096_f32")
               for mode in EXPORT_QUANT]
    for name, mode in [(n, "float32") for n in models] + storage:
        label = name if mode == "float32" else f"{name}:{mode}"
        d = os.path.join(work, label.replace(":", "_"))
        t0 = time.perf_counter()
        res = serving.export_serving(models[name][0], None, (32, 32, 1),
                                     out_dir=d, platforms=(DEVICE.type,),
                                     params_dtype=mode)
        export_s[label] = time.perf_counter() - t0
        check(all(f["batch"] == "symbolic"
                  for f in res["manifest"]["functions"].values()),
              f"export {label}: a function took a pinned batch")
        sizes[label] = {f: os.path.getsize(os.path.join(d, f))
                        for f in sorted(os.listdir(d))}
        bundles[label] = d
    spec = os.path.join(work, "export_spec.json")
    outputs = os.path.join(work, "export_outputs.npz")
    with open(spec, "w") as f:
        json.dump({"bundles": bundles, "inputs": inputs, "outputs": outputs,
                   "batches": list(EXPORT_BATCHES), "device": str(DEVICE)},
                  f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py"),
         "--export-child", spec], capture_output=True, text=True, env=env,
        timeout=900)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"export child failed:\n"
                                f"{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(child["model_modules"] == [],
          f"export child imported model code: {child['model_modules']}")
    got = np.load(outputs)

    errs, served_ms, launches = {}, {}, {}
    for name, (model, expected) in models.items():
        srv = serving.Serving(model, device=DEVICE)
        bar = EXPORT_BF16_BAR if name.endswith("bf16") else EXPORT_BAR
        errs[name] = {}
        for b in EXPORT_BATCHES:
            x = images[:b]
            z = got[f"{name}/encode_z/{b}"]
            want = {"encode_mu": srv.encode_mu(x),
                    "encode_z": srv.encode_z(trandom.sample_key((0, b)), x),
                    "decode": srv.decode(z)}
            for fn, w in want.items():
                e = rel_err(got[f"{name}/{fn}/{b}"], w.float().cpu().numpy())
                errs[name][f"{fn}/{b}"] = e
                check(e <= bar, f"export {name} {fn} batch {b}: bundle vs "
                                f"Serving {e} > {bar}")
                moved = child["bundles"][name]["launches"][f"{fn}/{b}"]
                check(moved == expected[fn],
                      f"export {name} {fn} batch {b}: the loaded program "
                      f"launched {moved}, expected {expected[fn]}")
        x = images
        z = torch.as_tensor(got[f"{name}/encode_z/{x.shape[0]}"],
                            device=DEVICE)
        served_ms[name] = {
            "encode_mu": request_ms(lambda: srv.encode_mu(x), DEVICE),
            "encode_z": request_ms(
                lambda: srv.encode_z(trandom.sample_key((0, 1)), x), DEVICE),
            "decode": request_ms(lambda: srv.decode(z), DEVICE)}
        total = {}
        for moved in child["bundles"][name]["launches"].values():
            for k, v in moved.items():
                total[k] = total.get(k, 0) + v
        launches[name] = total
        del srv
    check(sum(c.get("attention_fwd", 0) for c in launches.values()) > 0
          and sum(c.get("sampler_keyed", 0) for c in launches.values()) > 0,
          f"export: the loaded programs launched {launches}")

    quant = {}
    for name, mode in storage:
        max_err, shrink = EXPORT_QUANT[mode]
        label = f"{name}:{mode}"
        e = max(rel_err(got[f"{label}/encode_mu/{b}"],
                        got[f"{name}/encode_mu/{b}"])
                for b in EXPORT_BATCHES)
        ratio = (sizes[name]["params.npz"] / sizes[label]["params.npz"])
        quant[label] = {"encode_mu_rel_err": e, "shrink": ratio}
        check(e < max_err and ratio > shrink,
              f"export {label}: encode_mu error {e} (< {max_err}), "
              f"params.npz {ratio}x smaller (> {shrink})")
    share = {label: {f: s / files["params.npz"] for f, s in files.items()
                     if f.endswith(".pt2")}
             for label, files in sizes.items()}
    for label, files in share.items():
        check(max(files.values()) < EXPORT_PT2_SHARE,
              f"export {label}: a program holds {max(files.values())} of "
              f"params.npz's size: the weights are baked in")
    emit("export", batches=EXPORT_BATCHES, bar=EXPORT_BAR,
         bf16_bar=EXPORT_BF16_BAR, export_s=export_s, child_s=child_s,
         load_s={k: v["load_s"] for k, v in child["bundles"].items()},
         sizes=sizes, pt2_share_of_params=share,
         bundle_vs_serving_rel_err=errs, storage_modes=quant,
         launches=launches,
         bundle_batch64_ms={k: v["batch64_ms"]
                            for k, v in child["bundles"].items()
                            if k in models},
         bundle_batch64_unchecked_ms={
             k: v["batch64_unchecked_ms"]
             for k, v in child["bundles"].items() if k in models},
         serving_batch64_ms=served_ms,
         phase_s=time.perf_counter() - t_phase)
    return launches


HOST_BATCH = 64  # the native programs' fixed batch
HOST_EXPORT_TIMEOUT = 900  # seconds for all of the phase's export children
HOST_BENCH = 20  # timed requests of the host per function, after warm-up
HOST_WARMUP = 3
HOST_RNG = (0, 7)  # the apply rng of every encode_z request
HOST_VMF_Z = 41  # mnist_vmf's largest default d (40) as its R^(d+1) z_dim
HOST_SEED = 19
# the bundles of the native phase: label -> the functions compiled
HOST_EXPORTS = {
    "flagship32_f32": ("encode_mu", "encode_z", "decode"),
    "flagship32_bf16": ("encode_z", "decode"),
    "cnn4096_keyed": ("encode_z", "decode"),
    "cnn4096_rng": ("encode_z",),
    "cnn4096_unfused": ("encode_z",),
    "cnn4096_gaussian": ("encode_z",),
    "cnn4096_powerspherical": ("encode_z",),
    "mnist_vmf41": ("encode_z",),
}
# the kernels each request of the host must launch, by bundle and function
HOST_LAUNCHES = {
    "flagship32": {"encode_mu": {"attention_fwd": 4},
                   "encode_z": {"attention_fwd": 4, "sampler_keyed": 1},
                   "decode": {"attention_fwd": 8}},
    "cnn4096_keyed": {"encode_z": {"sampler_keyed": 1}, "decode": {}},
    "cnn4096_rng": {"encode_z": {"sampler_rng": 1}},
    "cnn4096_unfused": {"encode_z": {"torus_fwd": 1}},
}
HOST_OP_BAR = 1e-5  # an operator's CUDA impl against its CPU impl
# a bfloat16 package is held against bfloat16 Serving at EXPORT_BF16_BAR:
# native/compile.py compiles it as eager runs it (every op its ATen call).
# One bfloat16 step of an angle in [2, 4) is 2**-6 and moves a torus
# coordinate by up to 1.6e-2, so fused kernels that reduce and round
# otherwise than eager's miss that bar.  The package also parts from
# float32 Serving by at least HOST_BF16_FLOOR: one that computed in float32
# would sit within EXPORT_BAR of it (eager bfloat16 parts by 1.1e-2 in
# encode_z, 1.8e-2 in decode)
HOST_BF16_FLOOR = 1e-3
# and within this of bfloat16 Serving: the same ATen calls in the same
# order answer bit for bit (0.0 in every reading), where fused kernels
# that parted from eager at 43 (encode_z) or 4 (decode) bfloat16 roundings
# moved the answer by 1.3e-2 to 1.5e-2 (scripts/torch_native_bf16_parity.py)
HOST_BF16_EAGER_BAR = 1e-6


def host_model(label, mods):
    """The seeded model of a native bundle's label (``HOST_EXPORTS``)."""
    vit_vae, conv_vae, mlp_vae = mods
    if label.startswith("flagship32"):
        return flagship(vit_vae, torch.bfloat16 if label.endswith("bf16")
                        else torch.float32)
    if label == "mnist_vmf41":
        return mlp_vae.MLPVAE(MLP_H_DIM, HOST_VMF_Z, "vmf", seed=0)
    tail = label.split("_", 1)[1]
    if tail in ROUTES:
        return cnn4096(conv_vae, torch.float32, tail)
    return cnn4096_head(conv_vae, torch.float32, tail)


def host_img(label):
    return (28, 28, 1) if label.startswith("mnist") else (32, 32, 1)


def native_export_child(spec_path: str) -> int:
    """One bundle of the native phase, in a process of its own: the seeded
    model's bundle exported for "cuda", then native packages of the
    functions that the phase serves from it (``HOST_EXPORTS``; what
    ``native=True`` does for all three) at ``HOST_BATCH``, one compile
    process a package; prints one JSON line with the seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.nn import conv_vae, mlp_vae, vit_vae

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    model = host_model(spec["label"], (vit_vae, conv_vae, mlp_vae))
    t0 = time.perf_counter()
    img, out = host_img(spec["label"]), spec["out"]
    manifest = serving.export_serving(model, None, img, out_dir=out,
                                      platforms=("cuda",))["manifest"]
    manifest["native"], compile_s = serving._export_native(
        model, img, manifest["flat_z_dim"], out, ("cuda",), HOST_BATCH,
        tuple(spec["fns"]))
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps({"export_s": time.perf_counter() - t0,
                      "compile_s": compile_s}), flush=True)
    return 0


def host_expected(label, fn):
    return HOST_LAUNCHES.get(label.split("_")[0] if label.startswith(
        "flagship32") else label, {}).get(fn, {})


def native_op_checks(knative, rope, gen):
    """Each C++ operator's CUDA implementation against its CPU one on the
    same inputs at the serving paths' shapes: the attention at flagship32's
    (B 64, S 68, 8 heads of 64, RoPE) and, in float32, at image 256's (B 4,
    S 260: the key-tiled form), ``sample_embed`` at flagship32's and
    cnn4096's rows by every route (u and v bit for bit), ``draw_latent``
    of the other families at cnn4096's and the vMF MLP's.  Returns (the
    errors, the CUDA operators' device times (``cuda_ms``) by kernel row:
    attention by dtype, ``sample_embed`` by route and rows)."""
    ops = torch.ops.cliffordtpu_native
    out, op_ms = {}, {}
    c, s = rope.rope_2d_cos_sin(32, 8, 64, cls_token_num=4)
    cos, sin = torch.from_numpy(c).to(DEVICE), torch.from_numpy(s).to(DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(BATCH, 68, 8, 64, generator=gen,
                               device=DEVICE).to(dtype) for _ in range(3))
        got = ops.attention_fwd(q, k, v, cos, sin).float().cpu()
        want = ops.attention_fwd(q.cpu(), k.cpu(), v.cpu(), cos.cpu(),
                                 sin.cpu()).float()
        err = (got - want).abs().max().item()
        bar = 1e-5 if dtype == torch.float32 else 2e-2 * want.abs().max()
        check(err <= bar, f"native attention_fwd {dtype}: CUDA vs CPU "
                          f"{err} > {bar}")
        out[f"attention_fwd/{dtype}".replace("torch.", "")] = err
        op_ms["attention_fwd", dtype] = cuda_ms(
            lambda: ops.attention_fwd(q, k, v, cos, sin))
    # image 256's shape in float32: the operator's key-tiled form of A (a
    # generator of its own leaves the other cases' draws as they were)
    c, s = rope.rope_2d_cos_sin(256, 16, 64, cls_token_num=4)
    cos, sin = torch.from_numpy(c).to(DEVICE), torch.from_numpy(s).to(DEVICE)
    g260 = torch.Generator(device=DEVICE).manual_seed(260)
    q, k, v = (torch.randn(IMAGE256_BATCH, 260, 8, 64, generator=g260,
                           device=DEVICE) for _ in range(3))
    got = ops.attention_fwd(q, k, v, cos, sin).cpu()
    want = ops.attention_fwd(q.cpu(), k.cpu(), v.cpu(), cos.cpu(), sin.cpu())
    err = (got - want).abs().max().item()
    check(err <= 1e-5, f"native attention_fwd float32 S=260: CUDA vs CPU "
                       f"(attention_plain) {err} > 1e-5")
    out["attention_fwd/float32/S260"] = err
    op_ms["attention_fwd", torch.float32, 260] = cuda_ms(
        lambda: ops.attention_fwd(q, k, v, cos, sin))
    key = torch.tensor([3, 1234], dtype=torch.int64)
    for R, d in ((BATCH * 64, 16), (BATCH, CNN_LATENT)):
        loc = (torch.rand(R, d, generator=gen, device=DEVICE) * 2 - 1) \
            * math.pi
        kappa = torch.rand(R, 1, generator=gen, device=DEVICE) * 10 + 0.03
        for route, code in knative.ROUTES.items():
            got = [t.cpu() for t in ops.sample_embed(key, loc, kappa, code)]
            want = ops.sample_embed(key, loc.cpu(), kappa.cpu(), code)
            for i, name in ((2, "u"), (3, "v")):
                check(torch.equal(got[i], want[i]),
                      f"native sample_embed {route} R={R} d={d}: {name} "
                      f"CUDA vs CPU not bit-exact")
            errs = [(a - b).abs().max().item()
                    for a, b in zip(got[:2], want[:2])]
            check(max(errs) <= HOST_OP_BAR,
                  f"native sample_embed {route} R={R} d={d}: x, theta "
                  f"{errs} > {HOST_OP_BAR}")
            out[f"sample_embed/{route}/R{R}/d{d}"] = max(errs)
            # the key stays on the host: no copy, no sync in the timing
            op_ms["sample_embed", route, R] = cuda_ms(
                lambda: ops.sample_embed(key, loc, kappa, code))
    rng = torch.tensor(HOST_RNG, dtype=torch.int64)
    cases = {
        "gaussian": (torch.randn(BATCH, CNN_LATENT, generator=gen,
                                 device=DEVICE),
                     torch.randn(BATCH, CNN_LATENT, generator=gen,
                                 device=DEVICE) * 0.1),
        "powerspherical": (torch.nn.functional.normalize(torch.randn(
            BATCH, CNN_LATENT, generator=gen, device=DEVICE), dim=-1),
            torch.rand(BATCH, 1, generator=gen, device=DEVICE) * 50),
        "vmf": (torch.nn.functional.normalize(torch.randn(
            BATCH, HOST_VMF_Z, generator=gen, device=DEVICE), dim=-1),
            torch.rand(BATCH, 1, generator=gen, device=DEVICE) * 9 + 0.8),
        "clifford": (torch.randn(BATCH, 64, 16, generator=gen,
                                 device=DEVICE),
                     torch.rand(BATCH, 64, generator=gen, device=DEVICE)
                     * 10)}
    for fam, (mu, p2) in cases.items():
        sampler = "keyed" if fam == "clifford" else None
        got = knative.draw_latent(rng, mu, p2, fam, False, sampler, 1.0)
        want = knative.draw_latent(rng, mu.cpu(), p2.cpu(), fam, False,
                                   sampler, 1.0)
        e = rel_err(got.cpu().numpy(), want.numpy())
        check(e <= HOST_OP_BAR, f"native draw_latent {fam}: CUDA vs CPU "
                                f"{e} > {HOST_OP_BAR}")
        out[f"draw_latent/{fam}"] = e
    torch.cuda.synchronize()
    return out, op_ms


def host_libpython(path):
    """The ``libpython`` lines of ``ldd path`` (none expected)."""
    text = subprocess.run(["ldd", path], capture_output=True, text=True,
                          timeout=60).stdout
    return [line.strip() for line in text.splitlines()
            if "libpython" in line]


def native_builds(kbuild, nbuild):
    """Start building the native phase's operator library and C++ host
    (``nvcc`` and ``g++`` child processes, waited for on two threads), so
    that they build while the card runs earlier phases.  Returns a function
    that waits for both and gives (host, library, the seconds until the
    later of them was built)."""
    import concurrent.futures

    t0 = time.perf_counter()

    def timed(build):
        return build(True), time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(2)
    host_f = pool.submit(timed, nbuild.build_host)
    lib_f = pool.submit(timed, kbuild.build_native_ops)
    pool.shutdown(wait=False)

    def wait():
        (host, host_s), (lib, lib_s) = host_f.result(), lib_f.result()
        return host, lib, max(host_s, lib_s)
    return wait


def native_phase(mods, root, work, bundles, built):
    """The Python-free serving path on the card: the operator library and
    the host built from the checkout (``built``: ``native_builds``'
    waiting function); each operator's CUDA impl
    against its CPU impl; the ``bundles`` (label -> functions, as
    ``HOST_EXPORTS``) exported with
    ``native=True`` (AOTInductor packages at batch ``HOST_BATCH``) in
    parallel child processes, each bundle served as soon as its child is
    done; every function answered by the host binary
    as a subprocess (no Python in it) and held against in-process
    ``Serving`` on the bundle's weights (``EXPORT_BAR``; a bfloat16
    package within ``EXPORT_BF16_BAR`` and ``HOST_BF16_EAGER_BAR`` of
    bfloat16 ``Serving`` and at least ``HOST_BF16_FLOOR`` from float32
    ``Serving``),
    with the kernels each request launched inside
    the host (``HOST_LAUNCHES``); the host's p50 ms beside
    ``LoadedServing``'s and ``Serving``'s.  Returns the host's launches by
    label and the operators' device times (``native_op_checks``)."""
    (serving, vit_vae, conv_vae, mlp_vae, trandom, rope, knative) = mods
    t_phase = time.perf_counter()
    host, lib, build_s = built()
    check(not host_libpython(host) and not host_libpython(lib),
          f"native: the host or the operator library links libpython: "
          f"{host_libpython(host) + host_libpython(lib)}")
    knative.load(True)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    # no Inductor worker pools beside the compile processes
    env["TORCHINDUCTOR_COMPILE_THREADS"] = "1"

    def start(label):
        spec = os.path.join(work, f"{label}.json")
        with open(spec, "w") as f:
            json.dump({"label": label, "fns": list(bundles[label]),
                       "out": os.path.join(work, label)}, f)
        log = open(os.path.join(work, f"{label}.log"), "w+")
        return subprocess.Popen(
            [sys.executable, os.path.join(root, "chip_smoke.py"),
             "--native-export-child", spec], stdout=log,
            stderr=subprocess.STDOUT, env=env), log

    def finish(label, child):
        proc, log = child
        log.seek(0)
        text = log.read()
        log.close()
        check(proc.returncode == 0,
              f"native export {label} failed:\n{text[-4000:]}")
        exports[label] = json.loads(text.strip().splitlines()[-1])

    # every bundle at once; the operators run on the card meanwhile
    t0 = time.perf_counter()
    exports = {}
    children = {label: start(label) for label in bundles}
    gen = torch.Generator(device=DEVICE).manual_seed(HOST_SEED)
    op_errs, op_ms = native_op_checks(knative, rope, gen)

    images = {img: np.asarray(torch.rand(
        HOST_BATCH, *img, generator=gen, device=DEVICE).cpu(), np.float32)
        for img in ((32, 32, 1), (28, 28, 1))}
    images[(32, 32, 1)] = images[(32, 32, 1)] * 2 - 1
    rng_path = os.path.join(work, "rng.npy")
    np.save(rng_path, np.asarray(HOST_RNG, np.uint32))
    host_env = {k: v for k, v in os.environ.items()
                if not k.startswith("PYTHON")}
    runs, errs, errs_f32, host_ms, loaded_ms, served_ms, launches = (
        {}, {}, {}, {}, {}, {}, {})
    bit_equal = {}  # a bfloat16 package's answer equals bfloat16 Serving's

    def serve(label, fns):
        d = os.path.join(work, label)
        x = images[host_img(label)]
        x_path = os.path.join(work, f"{label}.x.npy")
        np.save(x_path, x)
        outs, launches[label] = {}, {}
        for fn in ("encode_mu", "encode_z", "decode"):
            if fn not in fns:
                continue
            ins = {"encode_mu": [x_path], "encode_z": [rng_path, x_path],
                   "decode": [os.path.join(work, f"{label}.encode_z.npy")]
                   }[fn]
            out_path = os.path.join(work, f"{label}.{fn}.npy")
            proc = subprocess.run(
                [host, "--ops", lib, "--bundle", d, "--fn", fn, "--device",
                 "cuda", *[a for p in ins for a in ("--input", p)],
                 "--output", out_path, "--bench", str(HOST_BENCH),
                 "--warmup", str(HOST_WARMUP)], capture_output=True,
                text=True, timeout=300, env=host_env)
            # the error's message opens stderr, its backtrace follows
            check(proc.returncode == 0, f"native host {label} {fn} failed "
                                        f"(rc {proc.returncode}):\n"
                                        f"{proc.stderr[:3000]}\n...\n"
                                        f"{proc.stderr[-1000:]}")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[f"{label}/{fn}"] = run
            moved = {k: v for k, v in run["launches"].items() if v}
            launches[label][fn] = moved
            expected = host_expected(label, fn)
            check(moved == expected, f"native host {label} {fn}: launches "
                                     f"{moved}, expected {expected}")
            outs[fn] = np.load(out_path)
            host_ms[f"{label}/{fn}"] = run["p50_ms"]
        params = serving.load_params_npz(os.path.join(d, "params.npz"))
        srv = serving.Serving(host_model(label, (vit_vae, conv_vae,
                                                 mlp_vae)),
                              params=params, device=DEVICE)
        bf16 = label.endswith("bf16")
        # a bfloat16 package answers as eager bfloat16 does, and not as
        # float32 compute does
        ref = serving.Serving(host_model("flagship32_f32", (
            vit_vae, conv_vae, mlp_vae)), params=params,
            device=DEVICE) if bf16 else srv
        ld = serving.load_serving(d, DEVICE)
        key = trandom.sample_key(HOST_RNG)
        z = outs.get("encode_z")
        calls = {
            "encode_mu": (lambda s_: s_.encode_mu(x), lambda: ld.encode_mu(x)),
            "encode_z": (lambda s_: s_.encode_z(key, x),
                         lambda: ld.encode_z(HOST_RNG, x)),
            "decode": (lambda s_: s_.decode(z), lambda: ld.decode(z))}
        for fn, got in outs.items():
            want = calls[fn][0](srv).float().cpu().numpy()
            check(got.shape == want.shape and bool(np.isfinite(got).all()),
                  f"native host {label} {fn}: shape {got.shape} vs "
                  f"{want.shape}, or not finite")
            e = rel_err(got, want)
            errs[f"{label}/{fn}"] = e
            if bf16:
                e_ref = rel_err(got, calls[fn][0](ref).float().cpu().numpy())
                errs_f32[f"{label}/{fn}"] = e_ref
                check(e <= EXPORT_BF16_BAR,
                      f"native host {label} {fn}: host vs bfloat16 "
                      f"Serving {e} > {EXPORT_BF16_BAR}")
                check(e <= HOST_BF16_EAGER_BAR,
                      f"native host {label} {fn}: host vs bfloat16 "
                      f"Serving {e} > {HOST_BF16_EAGER_BAR}: not eager's "
                      f"calls")
                bit_equal[f"{label}/{fn}"] = bool(np.array_equal(got, want))
                check(e_ref >= HOST_BF16_FLOOR,
                      f"native host {label} {fn}: host vs float32 Serving "
                      f"{e_ref} < {HOST_BF16_FLOOR}: not bfloat16 compute")
            else:
                check(e <= EXPORT_BAR, f"native host {label} {fn}: host vs "
                                       f"Serving {e} > {EXPORT_BAR}")
            served_ms[f"{label}/{fn}"] = request_ms(
                lambda: calls[fn][0](srv), DEVICE)
            loaded_ms[f"{label}/{fn}"] = request_ms(calls[fn][1], DEVICE)
        del srv, ref, ld

    # each bundle served as soon as its child is done, while the others
    # still compile (its host times share the CPU with those compiles)
    export_wall_s, pending = None, dict(children)
    try:
        while pending:
            done = [label for label, (proc, _) in pending.items()
                    if proc.poll() is not None]
            check(done or time.perf_counter() - t0 <= HOST_EXPORT_TIMEOUT,
                  f"native export {sorted(pending)}: over "
                  f"{HOST_EXPORT_TIMEOUT} s")
            if not done:
                time.sleep(0.2)
            for label in done:
                finish(label, pending.pop(label))
                if not pending:
                    export_wall_s = time.perf_counter() - t0
                serve(label, bundles[label])
    finally:
        for proc, log in pending.values():
            proc.kill()
            proc.wait()
            log.close()
    torch.cuda.empty_cache()
    emit("native", batch=HOST_BATCH, bench=HOST_BENCH, warmup=HOST_WARMUP,
         bar=EXPORT_BAR, bf16_bar=EXPORT_BF16_BAR,
         bf16_eager_bar=HOST_BF16_EAGER_BAR,
         bf16_floor=HOST_BF16_FLOOR, op_bar=HOST_OP_BAR,
         build_s=build_s, export_wall_s=export_wall_s,
         export_s={k: v["export_s"] for k, v in exports.items()},
         compile_s={k: v["compile_s"] for k, v in exports.items()},
         op_cuda_vs_cpu=op_errs, host_vs_serving_rel_err=errs,
         op_ms={"/".join(map(str, k)).replace("torch.", ""): v
                for k, v in op_ms.items()},
         bf16_host_vs_f32_serving_rel_err=errs_f32,
         bf16_host_bit_equal=bit_equal,
         launches=launches, host_p50_ms=host_ms,
         loaded_serving_ms=loaded_ms, serving_ms=served_ms,
         host_runs=runs, phase_s=time.perf_counter() - t_phase)
    return launches, op_ms


NATIVE_BATCH = 256
NATIVE_EPOCHS = 5  # timed epochs per engine, after one


def epoch_ms(batches) -> float:
    """Median wall time of one epoch drawn from ``batches()``."""
    for _ in batches():
        pass
    times = []
    for _ in range(NATIVE_EPOCHS):
        t0 = time.perf_counter()
        for _ in batches():
            pass
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def native_data_phase(root, work):
    """The native data engine built on the card's host; the committed digit
    shard written as idx files, read back natively and in Python; the
    batch stream at batch 256 against the numpy path, keyed and not; the
    ms per epoch of both."""
    from cliffordtpu_torch.data import loaders, native
    from cliffordtpu_torch.native import build as native_build

    t0 = time.perf_counter()
    lib = native_build.build()
    build_s = time.perf_counter() - t0
    shard = np.load(os.path.join(root, "tests", "data", "mnist",
                                 "mnist.npz"))
    saved = os.environ.get("CLIFFORDTPU_DATA_ENGINE")

    def engine(mode):
        os.environ["CLIFFORDTPU_DATA_ENGINE"] = mode

    try:
        reads = {}
        for split in ("x_train", "y_train", "x_test", "y_test"):
            arr = shard[split].astype(np.uint8)
            for gz in (False, True):
                path = os.path.join(work, split + (".gz" if gz else ""))
                header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
                    ">" + "I" * arr.ndim, *arr.shape)
                with (gzip.open if gz else open)(path, "wb") as f:
                    f.write(header + arr.tobytes())
                engine("python")
                plain = loaders._read_idx(path)
                engine("native")
                fast = native.read_idx(path)
                reads[os.path.basename(path)] = bool(
                    np.array_equal(fast, arr) and np.array_equal(plain, arr))
        check(all(reads.values()), f"native_data: idx reads {reads}")
        x = (shard["x_train"].reshape(len(shard["x_train"]), -1)
             .astype(np.float32) / 255.0)
        y = shard["y_train"].astype(np.int64)
        same, ms = {}, {}
        for keyed in (False, True):
            key = (0, 3) if keyed else None
            label = "keyed" if keyed else "unkeyed"

            def numpy_path():
                engine("python")
                return loaders.iterate_batches(x, y, NATIVE_BATCH, key=key)

            def native_path():
                engine("native")
                return loaders.iterate_batches(x, y, NATIVE_BATCH, key=key)

            want, got_ = list(numpy_path()), list(native_path())
            same[label] = len(got_) == len(want) and all(
                np.array_equal(a, c) and np.array_equal(b, e)
                for (a, b), (c, e) in zip(got_, want))
            ms[label] = {"numpy": epoch_ms(numpy_path),
                         "native": epoch_ms(native_path)}
        check(all(same.values()), f"native_data: streams equal {same}")
    finally:
        if saved is None:
            os.environ.pop("CLIFFORDTPU_DATA_ENGINE", None)
        else:
            os.environ["CLIFFORDTPU_DATA_ENGINE"] = saved
    emit("native_data", library=os.path.basename(lib), build_s=build_s,
         idx_reads_equal=reads, batch=NATIVE_BATCH, rows=len(x),
         streams_equal=same, epoch_ms=ms, cpu_count=os.cpu_count())


# the parallel phase: parallel/ on the card (a world of 1 under NCCL, two
# ranks sharing the card under gloo), flagship32 in the ViT's fused and
# stacked layouts, --mesh through the Fashion runner, and a data-parallel
# bundle of cnn4096
PARALLEL_BATCH = 256  # runner_fashion4096: CNNVAE(4096, 1), batch 256
PARALLEL_STEPS = 3
PARALLEL_LR = 1e-3  # AdamW, clip 1: the runner's step
PARALLEL_SEED = 23
PARALLEL_WORLD1_BAR = 1e-6  # world 1 vs the single-device step, relative
PARALLEL_RANKS_BAR = 1e-5  # two ranks' losses (half batches) vs the same
# two ranks' parameters after the steps, held by their update against the
# single device's: over all parameters (L2), and leaf by leaf (the worst
# leaf).  A first Adam step moves a weight by lr * g / (|g| + eps), so a
# weight whose gradient is near rounding moves by up to lr either way
# when half-batch convolutions round it otherwise (1.4e-3 and 3.5e-3
# measured on an H100).  Each run also plants the faults these bars are
# for, from the same init, and fails unless the update bars catch every
# one: "rows", every rank drawing rows 0..B/n of the draw (L2 0.97);
# "unreduced", no gradient all-reduced (0.84); "one_leaf", one small leaf
# (PARALLEL_FAULT_LEAF) left out of the all-reduce (L2 5.1e-2, worst
# leaf 8.9e-2)
PARALLEL_RANKS_UPDATE_BAR = 1e-2
PARALLEL_RANKS_LEAF_BAR = 2e-2
PARALLEL_FAULTS = ("rows", "unreduced", "one_leaf")
PARALLEL_FAULT_LEAF = "encoder.kappa.weight"
PARALLEL_CHILD_TIMEOUT = 600
LAYOUTS = {"split": (False, False), "fused": (True, False),
           "scan": (False, True), "fused_scan": (True, True)}
LAYOUT_F32_BAR = 5e-4  # the full-stack bar, relative to the largest value
LAYOUT_REQUESTS = {"encode_mu": {"attention_fwd": 4},
                   "encode_z": {"attention_fwd": 4, "sampler_keyed": 1},
                   "decode": {"attention_fwd": 8}}
LAYOUT_STEPS = 3  # timed steps per layout, after the first
DP_BUNDLE = 2
DP_BUNDLE_BATCHES = (8, 64)
# replicas vs Serving, relative to the largest value: a replica's
# convolutions run at half the batch and cuDNN may take other algorithms
# there (1.8e-6 measured at batch 64); a replica that drew other rows of
# the draw would be off by O(1)
DP_BUNDLE_BAR = 1e-5
GEMM_OPS = ("mm", "addmm", "bmm", "baddbmm")


def parallel_model(conv_vae, route="keyed"):
    return conv_vae.CNNVAE(latent_dim=CNN_LATENT, in_channels=1, img_size=32,
                           sampler=route, seed=0)


def parallel_images(device):
    gen = torch.Generator(device=device).manual_seed(PARALLEL_SEED)
    return torch.rand(PARALLEL_BATCH, 32, 32, 1, generator=gen,
                      device=device) * 2 - 1


def l2_rel(got, want) -> float:
    """||got - want|| / ||want|| over two dicts of tensors."""
    num = sum((got[n].double() - want[n].double()).pow(2).sum().item()
              for n in want)
    den = sum(want[n].double().pow(2).sum().item() for n in want)
    return math.sqrt(num / den)


def max_rel(got, want) -> float:
    """The largest difference over the largest reference value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def parallel_child(spec_path: str) -> int:
    """One process of the parallel phase (``chip_smoke.py
    --parallel-child SPEC``): part "world1" takes ``PARALLEL_STEPS`` steps
    of runner_fashion4096 on the single-device step, then under
    ``make_sharded_cnn_train_step`` in "replicated" (DDP) and "fsdp"
    (FSDP2) mode from the same init, in a group of one rank (NCCL); part
    "ranks" is one of two ranks that share the card (gloo, DDP): its u, v
    from F against rows r0:r0+128 of the whole batch's draw, the same
    steps on its 128 rows, and one step of the Philox route (E at row0
    128 on rank 1), then the planted faults of ``PARALLEL_FAULTS`` from
    the same init.  Writes its numbers to the spec's JSON per rank."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.distributed as dist

    from cliffordtpu_torch import parallel, random
    from cliffordtpu_torch.kernels import attention, sampler, torus
    from cliffordtpu_torch.nn import conv_vae
    from cliffordtpu_torch.parallel import sharding
    from cliffordtpu_torch.train import loop, state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    with open(spec_path) as f:
        spec = json.load(f)
    kmods = (attention, sampler, torus)
    device = parallel.init_distributed("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = parallel_images(device)
    keys = [random.sample_key(random.fold_in_words((0, 0), i))
            for i in range(PARALLEL_STEPS)]
    beta = torch.ones((), device=device)
    out = {"rank": rank, "world": world, "backend": dist.get_backend()}

    def run(step, xs):
        hist, ms = [], []
        for key in keys:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = step(xs, key, beta)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append({k: float(losses[k]) for k in (
                "total_loss", "recon_loss", "kld_loss", "grad_norm")})
        return hist, ms

    def whole(model):
        return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                .detach().float().cpu() for n, p in model.named_parameters()}

    def fresh(route="keyed"):
        return state.create_train_state(parallel_model(conv_vae, route),
                                        "adamw", PARALLEL_LR, device=device)

    if spec["part"] == "world1":
        st = fresh()
        zero_counts(*kmods)
        out["single"], out["single_ms"] = run(
            loop.make_cnn_train_step(st.model, st.optimizer), x)
        out["single_launches"] = launched_since_zero(kmods)
        single = whole(st.model)
        torch.save(single, spec["single_params"])
        del st
        for mode in ("replicated", "fsdp"):
            mesh = parallel.create_mesh((1, 1), "cuda")
            st = parallel.shard_state(fresh(), mesh, mode)
            step = parallel.make_sharded_cnn_train_step(st.sharded,
                                                        st.optimizer, mesh)
            zero_counts(*kmods)
            out[mode], out[f"{mode}_ms"] = run(step, x)
            out[f"{mode}_launches"] = launched_since_zero(kmods)
            out[f"{mode}_param_l2_rel"] = l2_rel(whole(st.model), single)
            del st, step
            torch.cuda.empty_cache()
    else:
        mesh = parallel.create_mesh((world, 1), "cuda")
        r0, r1 = parallel.global_batch_rows(mesh, PARALLEL_BATCH)
        out["rows"] = [r0, r1]
        st = fresh()
        with torch.no_grad():  # the draw of the first step, before it
            mu, kap = st.model.encode(x)
            whole_draw = sampler.sample_embed_keyed(keys[0], mu, kap)
            mine = sampler.sample_embed_keyed(keys[0], mu[r0:r1],
                                              kap[r0:r1],
                                              rows=(r0, PARALLEL_BATCH))
            out["draw_rows_equal"] = all(
                torch.equal(whole_draw[i][r0:r1], mine[i]) for i in (2, 3))
            del whole_draw, mine, mu, kap
        st = parallel.shard_state(st, mesh, "replicated")
        step = parallel.make_sharded_cnn_train_step(st.sharded, st.optimizer,
                                                    mesh)
        zero_counts(*kmods)
        out["steps"], out["ms"] = run(step, x[r0:r1])
        out["launches"] = launched_since_zero(kmods)
        if rank == 0:
            torch.save(whole(st.model), spec["ranks_params"])
        del st, step
        st = parallel.shard_state(fresh("rng"), mesh, "replicated")
        step = parallel.make_sharded_cnn_train_step(st.sharded, st.optimizer,
                                                    mesh)
        zero_counts(*kmods)
        rng_losses = step(x[r0:r1], keys[0], beta)
        torch.cuda.synchronize()
        out["rng_launches"] = launched_since_zero(kmods)
        out["rng_loss"] = float(rng_losses["total_loss"])
        del st, step
        out["faults"] = {}
        for fault in PARALLEL_FAULTS:  # after the counted runs
            st = parallel.shard_state(fresh(), mesh, "replicated")
            if fault == "rows":
                rank_of = sharding.data_rank
                sharding.data_rank = lambda mesh: 0
            step = parallel.make_sharded_cnn_train_step(
                st.sharded, st.optimizer, mesh)
            if fault == "rows":
                sharding.data_rank = rank_of
            if fault == "one_leaf":  # all-reduced by hand, but this leaf
                st.sharded._unreduced = [
                    p for n, p in st.model.named_parameters()
                    if n != PARALLEL_FAULT_LEAF]
            with (contextlib.nullcontext() if fault == "rows"
                  else st.sharded.module.no_sync()):
                out["faults"][fault] = run(step, x[r0:r1])[0]
            if rank == 0:
                torch.save(whole(st.model),
                           f"{spec['ranks_params']}.{fault}")
            del st, step
    with open(spec["out"].format(rank=rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_parallel_children(root, work, part, world, extra):
    """Start ``world`` parallel children of ``part`` (two ranks with
    torchrun's environment), wait for all, and return their reports; a
    child that fails fails the phase.  Every child is ended here."""
    spec = {"part": part, "out": os.path.join(work, f"{part}{{rank}}.json"),
            **extra}
    spec_path = os.path.join(work, f"{part}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ)
            for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                      "MASTER_ADDR", "MASTER_PORT"):
                env.pop(k, None)
            if world > 1:
                env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE=str(world),
                           LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--parallel-child", spec_path], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        texts = [p.communicate(timeout=PARALLEL_CHILD_TIMEOUT)[0]
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, texts)):
        sys.stdout.write(text[-3000:])
        check(p.returncode == 0, f"parallel {part} rank {rank} exited "
                                 f"{p.returncode}")
    reports = []
    for rank in range(world):
        with open(spec["out"].format(rank=rank)) as f:
            reports.append(json.load(f))
    return reports


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def stack_blocks(sd, model):
    """A state dict of unrolled blocks (``layers.i``) as ``model``'s, whose
    blocks are stacked (``scan.block``): block i's parameter is slice i."""
    out = {}
    for k in model.state_dict():
        if ".scan.block." not in k:
            out[k] = sd[k]
            continue
        prefix, rest = k.split(".scan.block.")
        n = sum(1 for key in sd if key.startswith(f"{prefix}.layers.")
                and key.endswith(f".{rest}") and key.count(".") ==
                prefix.count(".") + rest.count(".") + 3)
        out[k] = torch.stack([sd[f"{prefix}.layers.{i}.{rest}"]
                              for i in range(n)])
    return out


def layout_models(vit_vae, param_import, param_convert, dtype):
    """flagship32 in every layout from one init: the split model, its
    weights fused by ``param_convert`` and stacked by ``stack_blocks``."""
    split = flagship(vit_vae, dtype)
    tree = param_convert.nest(param_import.to_jax(split))
    param_convert.fuse_vit_params(tree, split.encoder_vit.layers[0].attn
                                  .n_heads)
    models = {"split": split}
    for name, (fused, scan) in LAYOUTS.items():
        if name == "split":
            continue
        m = vit_vae.CliffordARVAE(latent_dim=16, image_size=32,
                                  in_channels=1, compute_dtype=dtype,
                                  seed=1, fused_proj=fused,
                                  scan_layers=scan)
        src = (param_import.from_jax(param_convert.flatten(tree))
               if fused else split.state_dict())
        if scan:
            src = stack_blocks(models["fused"].state_dict() if fused
                               else src, m)
        m.load_state_dict(src)
        models[name] = m
    return models


class GemmCount:
    """Counts the matrix products (``GEMM_OPS``) that reach the dispatcher
    while it is entered: one launch each."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func._overloadpacket.__name__ in GEMM_OPS:
                    counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def layouts_phase(kmods, mods, images):
    """(c): flagship32 split / fused_proj / scan_layers / both, float32 and
    bfloat16, weights converted from one init: requests (encode_mu,
    encode_z, decode at batch 64) against the split model's in float32
    (``LAYOUT_F32_BAR``; bfloat16 against float32 split at ``BF16_BARS``),
    A 4 / 4 / 8 and F 0 / 1 / 0 per request; a train step's losses against
    the split step's, A 12 + B 12 per step; the GEMM launches of a step,
    and the step wall and device ms of each layout.  Returns the launches
    per (dtype, layout)."""
    serving, vit_vae, param_import, param_convert, state, loop = mods
    report, counts = {}, {}
    key = (0, 11)
    ref = ref_step = None
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        models = layout_models(vit_vae, param_import, param_convert, dtype)
        for name, model in models.items():
            srv = serving.Serving(model, device=DEVICE)
            outs, per_request = {}, {}
            zero_counts(*kmods)
            with torch.inference_mode():
                outs["encode_mu"] = srv.encode_mu(images)
                per_request["encode_mu"] = launched_since_zero(kmods)
                zero_counts(*kmods)
                outs["encode_z"] = srv.encode_z(key, images)
                per_request["encode_z"] = launched_since_zero(kmods)
                zero_counts(*kmods)
                z_in = ref["encode_z"] if ref is not None else outs[
                    "encode_z"]
                outs["decode"] = srv.decode(z_in)
                per_request["decode"] = launched_since_zero(kmods)
            for fn, want in LAYOUT_REQUESTS.items():
                check(per_request[fn] == want,
                      f"layouts {label} {name} {fn}: launches "
                      f"{per_request[fn]}, want {want}")
            if ref is None:
                ref = {k: v.float() for k, v in outs.items()}
            errs = {}
            for fn in outs:
                diff = outs[fn].float() - ref[fn]
                if fn == "encode_mu":  # angles: modulo 2 pi
                    diff = torch.remainder(diff + math.pi, 2 * math.pi) \
                        - math.pi
                errs[fn] = diff.abs().max().item()
                if dtype == torch.float32:
                    bar = LAYOUT_F32_BAR * ref[fn].abs().max().item()
                else:
                    bar = BF16_BARS[fn]
                check(errs[fn] <= bar, f"layouts {label} {name} {fn}: "
                                       f"{errs[fn]} > {bar} against split "
                                       f"float32")
            del srv
            st = state.create_train_state(model, "adamw", TRAIN_LR,
                                          device=DEVICE)
            step = loop.make_cnn_train_step(st.model, st.optimizer)
            zero_counts(*kmods)
            with GemmCount() as gemm:
                first = step(images, (0, 0), 1.0)
            step_counts = launched_since_zero(kmods)
            first = {k: float(v) for k, v in first.items()}
            check(step_counts.get("attention_fwd") == 12
                  and step_counts.get("attention_bwd") == 12,
                  f"layouts {label} {name}: step launches {step_counts}")
            if ref_step is None:
                ref_step = first
            loss_rel = abs(first["total_loss"] - ref_step["total_loss"]) \
                / abs(ref_step["total_loss"])
            bar = (LAYOUT_F32_BAR if dtype == torch.float32
                   else TRAIN_BARS["bf16_loss_rel"])
            check(loss_rel <= bar, f"layouts {label} {name}: first loss "
                                   f"{first['total_loss']} vs split float32 "
                                   f"{ref_step['total_loss']}: {loss_rel}")
            wall, dev_ms = [], []
            for i in range(LAYOUT_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                step(images, (0, i + 1), 1.0)
                end.record()
                end.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
                dev_ms.append(start.elapsed_time(end))
            report[f"{label},{name}"] = dict(
                request_errors=errs, per_request=per_request,
                step_launches=step_counts, gemm_per_step=gemm.n,
                first_loss=first["total_loss"], first_loss_rel=loss_rel,
                step_wall_ms=statistics.median(wall),
                step_device_ms=statistics.median(dev_ms))
            counts[label, name] = dict(step_counts)
            for pr in per_request.values():
                for k, v in pr.items():
                    counts[label, name][k] = counts[label, name].get(k, 0) + v
            del st, step
        del models
        torch.cuda.empty_cache()
    emit("parallel_layouts", batch=images.shape[0], layouts=report,
         f32_bar=LAYOUT_F32_BAR, bf16_bars=BF16_BARS)
    return counts


def dp_bundle_phase(kmods, mods, work):
    """(e): cnn4096 exported with ``data_parallel=2``, both replicas on
    cuda:0: requests at batch 8 and 64 against in-process ``Serving``
    (``DP_BUNDLE_BAR``), F once per replica per ``encode_z``.  Returns the
    launches."""
    serving, conv_vae, trandom = mods
    model = cnn4096(conv_vae, torch.float32)
    bundle = os.path.join(work, "dp_bundle")
    serving.export_serving(model, None, (32, 32, 1), out_dir=bundle,
                           platforms=("cuda",), data_parallel=DP_BUNDLE)
    ld = serving.load_serving(bundle, devices=["cuda:0"] * DP_BUNDLE)
    srv = serving.Serving(model, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(PARALLEL_SEED)
    report, total = {}, {}
    for b in DP_BUNDLE_BATCHES:
        x = torch.rand(b, 32, 32, 1, generator=gen, device=DEVICE) * 2 - 1
        rng = (0, 100 + b)
        zero_counts(*kmods)
        got = {"encode_mu": ld.encode_mu(x), "encode_z": ld.encode_z(rng, x)}
        z_launches = launched_since_zero(kmods)
        got["decode"] = ld.decode(got["encode_z"])
        launches = launched_since_zero(kmods)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(z_launches == {"sampler_keyed": DP_BUNDLE},
              f"dp bundle batch {b}: encode_z launches {z_launches}, want "
              f"one F per replica")
        with torch.inference_mode():
            want = {"encode_mu": srv.encode_mu(x),
                    "encode_z": srv.encode_z(trandom.sample_key(rng), x)}
            want["decode"] = srv.decode(got["encode_z"])
        errs = {k: max_rel(got[k], want[k]) for k in want}
        report[b] = errs
        for k, e in errs.items():
            check(e <= DP_BUNDLE_BAR, f"dp bundle batch {b} {k}: {e} > "
                                      f"{DP_BUNDLE_BAR} against Serving")
    emit("parallel_dp_bundle", replicas=DP_BUNDLE, devices=["cuda:0"] *
         DP_BUNDLE, errors=report, bar=DP_BUNDLE_BAR, launches=total)
    return total


def parallel_runner_runs(root, work):
    """(d): ``fashion_train`` at latent 4096 on the digit shard, one epoch,
    without ``--mesh``, with ``--mesh dp`` and with ``--mesh dp
    --mesh_mode fsdp`` (a world of 1, no launcher), best losses within
    ``PARALLEL_WORLD1_BAR``; beside them ``--arch vit --fused_proj
    --scan_layers`` with ``--eval_subprocess``, whose child reads the
    stacked, fused checkpoint: four processes side by side."""
    env = dict(os.environ, CLIFFORDTPU_DATA_DIR=os.path.join(
        root, "tests", "data"))
    light = ["--vsa_trials", "1", "--fid_samples", "256"]
    runs = {"plain": [], "dp": ["--mesh", "dp"],
            "fsdp": ["--mesh", "dp", "--mesh_mode", "fsdp"]}

    def start(name, argv):
        """(outdir, log, process): the log a file, so that no child waits
        on a full pipe while another is read."""
        outdir = os.path.join(work, f"runner_{name}")
        log = open(f"{outdir}.log", "w+")
        return outdir, log, subprocess.Popen(
            [sys.executable, "-m", "cliffordtpu_torch.scripts.fashion_train",
             *argv, "--outdir", outdir], cwd=root, env=env, stdout=log,
            stderr=subprocess.STDOUT)

    def finish(name, outdir, log, proc):
        try:
            proc.wait(timeout=PARALLEL_CHILD_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
        check(proc.returncode == 0, f"runner {name} exited "
                                    f"{proc.returncode}: {text[-2000:]}")
        check("subprocess eval failed" not in text
              and "subprocess eval errored" not in text,
              f"runner {name}: the eval child failed: {text[-2000:]}")
        exp = [d for d in os.listdir(os.path.join(outdir, "results"))
               if d != "comparisons"]
        with open(os.path.join(outdir, "results", exp[0],
                               "metrics.json")) as f:
            return json.load(f), text

    best, wall = {}, {}
    t0 = time.perf_counter()
    started = {name: start(name, runner_argv("fashion", 1, *light, *extra))
               for name, extra in runs.items()}
    # the ViT arm beside them: four processes on the card at once
    started["vit"] = start("vit", arm_argv("vit", os.path.join(
        work, "runner_vit"))[:-2] + [
        "--fused_proj", "--scan_layers", "--eval_subprocess", *light])
    metrics = {}
    try:
        for name, child in started.items():
            metrics[name], text = finish(name, *child)
            best[name] = metrics[name]["final_best_total_loss"]
            check("mesh:" in text if name in ("dp", "fsdp") else True,
                  f"runner {name}: no mesh line")
    finally:
        for _, log, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall["runs_s"] = time.perf_counter() - t0
    rel = {name: abs(best[name] - best["plain"]) / abs(best["plain"])
           for name in ("dp", "fsdp")}
    for name, r in rel.items():
        check(r <= PARALLEL_WORLD1_BAR, f"runner --mesh {name}: best loss "
                                        f"{best[name]} vs {best['plain']}: "
                                        f"{r}")
    check(math.isfinite(best["vit"]) and "knn_acc_100" in metrics["vit"],
          f"runner vit fused scan: the child wrote no battery: "
          f"{metrics['vit']}")
    vit_best = best.pop("vit")
    emit("parallel_runner", best_loss=best, rel=rel,
         bar=PARALLEL_WORLD1_BAR, vit_best_loss=vit_best, wall_s=wall)


def parallel_phase(kmods, mods, root, work, images):
    """The slice's path: (a) runner_fashion4096's step at a world of 1
    (NCCL), DDP and FSDP2 against the single-device step; (b) the same
    step on two ranks sharing the card (gloo, DDP), each drawing its rows
    of the global draw; (c) flagship32's layouts; (d) ``--mesh`` through
    the Fashion runner; (e) a data-parallel bundle.  (a) and (b) run in
    child processes, so no process group reaches the other phases.
    Returns the launches of its paths."""
    t_phase = time.perf_counter()
    single_params = os.path.join(work, "single.pt")
    ranks_params = os.path.join(work, "ranks.pt")
    (w1,) = run_parallel_children(root, work, "world1", 1,
                                  {"single_params": single_params})
    check(w1["backend"] == "nccl", f"world 1: backend {w1['backend']}")
    world1 = {}
    for mode in ("replicated", "fsdp"):
        rel = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(
            w1[mode], w1["single"]) for k in b)
        world1[mode] = {"loss_grad_norm_rel": rel,
                        "param_l2_rel": w1[f"{mode}_param_l2_rel"],
                        "ms": w1[f"{mode}_ms"],
                        "launches": w1[f"{mode}_launches"]}
        check(rel <= PARALLEL_WORLD1_BAR and w1[f"{mode}_param_l2_rel"]
              <= PARALLEL_WORLD1_BAR,
              f"world 1 {mode}: {world1[mode]} > {PARALLEL_WORLD1_BAR}")
        check(w1[f"{mode}_launches"] == {
            "sampler_keyed": PARALLEL_STEPS, "torus_bwd": PARALLEL_STEPS},
            f"world 1 {mode}: launches {w1[f'{mode}_launches']}")
    ranks = run_parallel_children(root, work, "ranks", 2,
                                  {"ranks_params": ranks_params})
    check(all(r["backend"] == "gloo" for r in ranks),
          "two ranks on one card: not gloo")
    check(all(r["draw_rows_equal"] for r in ranks),
          "two ranks: a rank's u, v are not its rows of the global draw")

    def loss_rel(hists):
        return max(abs(a[k] - b[k]) / abs(b[k]) for h in hists for a, b in
                   zip(h, w1["single"]) for k in b)

    single = torch.load(single_params)
    init = {n: p.detach().float().cpu() for n, p in parallel_model(
        mods["bundle"][1]).named_parameters()}

    def update_rel(path):
        """The update's L2 error over all parameters and the worst leaf's
        (its name and error), against the single device's update."""
        got = torch.load(path)
        want = {n: single[n] - init[n] for n in init}
        leaves = {n: l2_rel({n: got[n] - init[n]}, {n: want[n]})
                  for n in init}
        worst = max(leaves, key=leaves.get)
        return {"l2": l2_rel({n: got[n] - init[n] for n in init}, want),
                "leaf": leaves[worst], "worst_leaf": worst}

    rank_rel = loss_rel([r["steps"] for r in ranks])
    param_rel = l2_rel(torch.load(ranks_params), single)
    sound = update_rel(ranks_params)
    faults = {}
    for fault in PARALLEL_FAULTS:
        faults[fault] = {"loss_rel": loss_rel([r["faults"][fault]
                                               for r in ranks]),
                         **update_rel(f"{ranks_params}.{fault}")}
    emit("parallel_ranks_update", sound=sound, faults=faults,
         fault_leaf=PARALLEL_FAULT_LEAF,
         bars={"loss": PARALLEL_RANKS_BAR, "l2": PARALLEL_RANKS_UPDATE_BAR,
               "leaf": PARALLEL_RANKS_LEAF_BAR})
    check(rank_rel <= PARALLEL_RANKS_BAR, f"two ranks vs single device: "
                                          f"losses {rank_rel} > "
                                          f"{PARALLEL_RANKS_BAR}")
    check(sound["l2"] <= PARALLEL_RANKS_UPDATE_BAR
          and sound["leaf"] <= PARALLEL_RANKS_LEAF_BAR,
          f"two ranks vs single device: the parameters' update differs by "
          f"{sound} > {PARALLEL_RANKS_UPDATE_BAR}, "
          f"{PARALLEL_RANKS_LEAF_BAR}")
    for fault, got in faults.items():
        check(got["l2"] > PARALLEL_RANKS_UPDATE_BAR
              or got["leaf"] > PARALLEL_RANKS_LEAF_BAR,
              f"two ranks: the planted fault {fault!r} passes the update "
              f"bars ({got})")
    for r in ranks:
        check(r["launches"] == {"sampler_keyed": PARALLEL_STEPS,
                                "torus_bwd": PARALLEL_STEPS},
              f"rank {r['rank']}: launches {r['launches']}")
        check(r["rng_launches"] == {"sampler_rng": 1, "torus_bwd": 1},
              f"rank {r['rank']}: rng launches {r['rng_launches']}")
    emit("parallel_world", world1=world1, single_ms=w1["single_ms"],
         ranks={r["rank"]: {"rows": r["rows"], "ms": r["ms"],
                            "launches": r["launches"],
                            "rng_launches": r["rng_launches"]}
                for r in ranks},
         ranks_loss_rel=rank_rel, ranks_param_l2_rel=param_rel,
         ranks_update_l2_rel=sound["l2"], ranks_update_leaf_rel=sound["leaf"],
         bars={"world1": PARALLEL_WORLD1_BAR, "ranks": PARALLEL_RANKS_BAR,
               "ranks_update": PARALLEL_RANKS_UPDATE_BAR,
               "ranks_update_leaf": PARALLEL_RANKS_LEAF_BAR})
    layout_counts = layouts_phase(kmods, mods["layouts"], images)
    parallel_runner_runs(root, work)
    bundle_counts = dp_bundle_phase(kmods, mods["bundle"], work)
    emit("parallel_phase", seconds=time.perf_counter() - t_phase)
    world1_counts = {}
    for mode in ("replicated", "fsdp"):
        for k, v in w1[f"{mode}_launches"].items():
            world1_counts[k] = world1_counts.get(k, 0) + v
    return {"world1": world1_counts,
            "ranks_keyed_row0": ranks[1]["launches"],
            "ranks_rng_row0": ranks[1]["rng_launches"],
            "layouts": layout_counts, "dp_bundle": bundle_counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cliffordtpu_torch import random as trandom
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.eval import (
        adapters,
        binding,
        class_means,
        fid,
        inception,
        knn,
        plots,
    )
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.kernels import native as knative
    from cliffordtpu_torch.native import build as nbuild
    from cliffordtpu_torch.nn import (
        conv_vae,
        hybrid_vae,
        losses,
        mlp_vae,
        vit_vae,
    )
    from cliffordtpu_torch.ops import rope
    from cliffordtpu_torch.ops import torus as ops_torus
    from cliffordtpu_torch.runners import cnn_runner, mnist_runner
    from cliffordtpu_torch.scripts import (
        binding_depth_heatmap,
        bundle_heatmap,
        cifar10_train,
        eval_battery_timing,
        fashion_train,
        mnist_clifpws,
        mnist_vmf,
        paper_bind_bundle_figure,
        rolefiller_heatmap,
        sample_viz,
    )
    from cliffordtpu_torch.nn import param_convert, param_import
    from cliffordtpu_torch.train import checkpoint, loop, schedules, state
    from cliffordtpu_torch.vsa import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock = [time.perf_counter()]
    start, phase_s = clock[0], {}

    def lap(name):
        """The wall seconds since the last lap, as phase ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    per_source = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         sources=build.sources())
    for name in build.sources():
        log = build.build_log(name)
        # each kernel's registers, stack frame and spill stores and loads
        emit("ptxas", source=name, report=[
            line.strip() for line in log
            if "ptxas info" in line or "bytes stack frame" in line])
    # the native phase's operator library and host build meanwhile
    native_built = native_builds(build, nbuild)
    lap("build")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    att = {}
    for label, S, dtype, use_rope in (("f32", 68, torch.float32, True),
                                      ("bf16", 68, torch.bfloat16, True),
                                      ("f32_s17_norope", 17, torch.float32,
                                       False)):
        att[label] = attention_case(attention, rope, BATCH, S, 8, 64, dtype,
                                    use_rope, gen)
        emit("kernel", kernel="attention_fwd", **att[label])
    att_b = {}
    for label, S, dtype, use_rope in (("f32", 68, torch.float32, True),
                                      ("bf16", 68, torch.bfloat16, True),
                                      ("f32_s17_norope", 17, torch.float32,
                                       False),
                                      ("bf16_s17_norope", 17, torch.bfloat16,
                                       False)):
        att_b[label] = attention_bwd_case(attention, rope, BATCH, S, 8, 64,
                                          dtype, use_rope, gen)
        emit("kernel", kernel="attention_bwd", **att_b[label])
    tor_f = {}
    for label, R, d in (("cnn4096", BATCH, CNN_LATENT), ("d2048", BATCH, 2048),
                        ("d513", BATCH, 513), ("flagship32", BATCH * 64, 16)):
        tor_f[label] = torus_fwd_case(torus, ops_torus, R, d, gen)
        emit("kernel", kernel="torus_fwd", **tor_f[label])
    tor = {}
    for label, R, d, epilogue in (("flagship32", BATCH * 64, 16, True),
                                  ("d513", BATCH, 513, False),
                                  ("cnn4096", BATCH, CNN_LATENT, True)):
        tor[label] = torus_bwd_case(torus, sampler, ops_torus, R, d, epilogue,
                                    gen)
        emit("kernel", kernel="torus_bwd", **tor[label])
    smp = {}
    for route, label, R, d, per_row in (
            ("keyed", "flagship32", BATCH * 64, 16, True),
            ("keyed", "d513", BATCH, 513, False),
            ("keyed", "cnn4096", BATCH, CNN_LATENT, True),
            ("rng", "flagship32", BATCH * 64, 16, True),
            ("rng", "d513", BATCH, 513, False),
            ("rng", "d2048", BATCH, 2048, True),
            ("rng", "cnn4096", BATCH, CNN_LATENT, True)):
        smp[route, label] = sampler_case(sampler, route, R, d, per_row, gen)
        emit("kernel", kernel=f"sampler_{route}", **smp[route, label])
    # F and D at the MNIST MLP's shapes: batch 128, one kappa per row; the
    # table form at d 5 and 40, d 256 a power of two
    mnist = {}
    for d in MNIST_KERNEL_DIMS:
        mnist["sampler_keyed", d] = sampler_case(sampler, "keyed", MLP_BATCH,
                                                 d, True, gen)
        emit("kernel", kernel="sampler_keyed", shape="mnist_mlp",
             **mnist["sampler_keyed", d])
        mnist["torus_bwd", d] = torus_bwd_case(torus, sampler, ops_torus,
                                               MLP_BATCH, d, True, gen)
        emit("kernel", kernel="torus_bwd", shape="mnist_mlp",
             **mnist["torus_bwd", d])
    # F and D at the hybrid's shape: R = batch x tokens rows of d 256, one
    # kappa per row (per token) read in place over the angles
    hybrid_rows = HYBRID_BATCH * HYBRID_TOKENS
    hybrid = {
        "sampler_keyed": sampler_case(sampler, "keyed", hybrid_rows,
                                      HYBRID_LATENT, True, gen),
        "torus_bwd": torus_bwd_case(torus, sampler, ops_torus, hybrid_rows,
                                    HYBRID_LATENT, True, gen)}
    for name, case in hybrid.items():
        emit("kernel", kernel=name, shape="hybrid_fashion4096", **case)
    # C and F at cifar_fid4096's shapes: a prior batch (R 256 of d 4096) and
    # the decoded bundles' encode batch (R 200, one kappa per row)
    fid_cases = {
        "torus_fwd": torus_fwd_case(torus, ops_torus, FID_BATCH, FID_LATENT,
                                    gen),
        "sampler_keyed": sampler_case(sampler, "keyed", FID_ENCODE_ROWS,
                                      FID_LATENT, True, gen)}
    for name, case in fid_cases.items():
        emit("kernel", kernel=name, shape="cifar_fid4096", **case)
    # F, D and C at the runner's shape: a batch of 256 rows of d 4096, one
    # kappa per row (the train step, the battery's encodes, the prior
    # batches of compute_fid)
    runner_cases = {
        "sampler_keyed": sampler_case(sampler, "keyed", RUNNER_BATCH,
                                      RUNNER_LATENT, True, gen),
        "torus_bwd": torus_bwd_case(torus, sampler, ops_torus, RUNNER_BATCH,
                                    RUNNER_LATENT, True, gen),
        "torus_fwd": torus_fwd_case(torus, ops_torus, RUNNER_BATCH,
                                    RUNNER_LATENT, gen)}
    for name, case in runner_cases.items():
        emit("kernel", kernel=name, shape="runner_fashion4096", **case)
    # the runner's other arms at latent 128, batch 256: the ViT's attention
    # (float32, S 68, 8 heads of 64) and the hybrid's F and D (R = batch x
    # 64 tokens of d 8, one kappa per token)
    arm_cases = {
        ("attention_fwd", "runner_vit128"): attention_case(
            attention, rope, RUNNER_BATCH, 68, 8, 64, torch.float32, True,
            gen),
        ("attention_bwd", "runner_vit128"): attention_bwd_case(
            attention, rope, RUNNER_BATCH, 68, 8, 64, torch.float32, True,
            gen),
        ("sampler_keyed", "runner_hybrid128"): sampler_case(
            sampler, "keyed", RUNNER_BATCH * HYBRID_TOKENS,
            max(4, ARM_LATENT // 16), True, gen),
        ("torus_bwd", "runner_hybrid128"): torus_bwd_case(
            torus, sampler, ops_torus, RUNNER_BATCH * HYBRID_TOKENS,
            max(4, ARM_LATENT // 16), True, gen)}
    for (name, shape), case in arm_cases.items():
        emit("kernel", kernel=name, shape=shape, **case)
    # F and D at the sweep phase's trials (CNNVAE d 128, batch 256, one
    # kappa per row), and F at sample_viz's draw (4000 rows of d 4, a kappa
    # per angle)
    sweep_cases = {
        "sampler_keyed": sampler_case(sampler, "keyed", RUNNER_BATCH,
                                      SWEEP_LATENT, True, gen),
        "torus_bwd": torus_bwd_case(torus, sampler, ops_torus, RUNNER_BATCH,
                                    SWEEP_LATENT, True, gen)}
    for name, case in sweep_cases.items():
        emit("kernel", kernel=name, shape=f"sweep_cnn{SWEEP_LATENT}", **case)
    viz_case = sampler_case(sampler, "keyed", sample_viz.N_SAMPLES, 4, False,
                            gen)
    emit("kernel", kernel="sampler_keyed", shape="sample_viz", **viz_case)
    # the parallel phase's forms: F and E at a nonzero row base (rank 1 of
    # two: rows 128.. of 256, d 4096, one kappa per row), A and B on the
    # packed q/k/v of a fused_proj projection (flagship32's shape)
    half = PARALLEL_BATCH // 2
    par_cases = {
        ("sampler_keyed", "row0"): sampler_case(
            sampler, "keyed", half, CNN_LATENT, True, gen, row0=half),
        ("sampler_rng", "row0"): sampler_case(
            sampler, "rng", half, CNN_LATENT, True, gen, row0=half),
        **{(name, label): case(attention, rope, BATCH, 68, 8, 64, dtype,
                               True, gen, packed=True)
           for name, case in (("attention_fwd", attention_case),
                              ("attention_bwd", attention_bwd_case))
           for label, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16))}}
    for (name, tag), case in par_cases.items():
        emit("kernel", kernel=name, shape="parallel", **case)
    lap("kernels")

    kmods = (attention, sampler, torus)
    images = torch.rand(BATCH, 32, 32, 1, generator=gen, device=DEVICE) * 2 - 1
    runs = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        srv, outs, lat, counts = serve_flagship(kmods, serving, vit_vae,
                                                dtype, images)
        runs[label] = (srv, outs, counts)
        emit("serve", compute_dtype=label, batch=BATCH, requests=REQUESTS,
             launches=counts,
             median_ms={k: statistics.median(v[1:]) for k, v in lat.items()},
             first_ms={k: v[0] for k, v in lat.items()})
    serve_check(kmods, ops_torus, "serve", *runs["float32"][:2],
                runs["bfloat16"][1], FLAGSHIP_REQUESTS, images)
    lap("serve")

    trained = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        st = state.create_train_state(flagship(vit_vae, dtype),
                                      optimizer="adamw", lr=TRAIN_LR,
                                      device=DEVICE)
        per_step = {k: v for k, v in PER_STEP.items() if v}
        history, ms, counts = train(
            kmods, st, loop.make_cnn_train_step(st.model, st.optimizer),
            per_step, TRAIN_STEPS, images, f"flagship32 {label}")
        trained[label] = counts
        emit("train", compute_dtype=label, batch=BATCH, steps=TRAIN_STEPS,
             optimizer="adamw", lr=TRAIN_LR, launches=counts,
             per_step_launches=per_step,
             median_ms_per_step=statistics.median(ms[1:]),
             min_ms_per_step=min(ms[1:]), first_ms=ms[0],
             first_losses=history[0], last_losses=history[-1])
        del st
    train_check(kmods, ops_torus, conv_vae,
                lambda dtype: flagship(vit_vae, dtype), images, "train")
    runs = {k: v[2] for k, v in runs.items()}  # keep the counts only
    torch.cuda.empty_cache()
    lap("train")

    cnn_runs = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        srv, outs, lat, counts = serve_cnn(kmods, serving, conv_vae, dtype,
                                           images)
        cnn_runs[label] = (srv, outs, counts)
        emit("cnn_serve", compute_dtype=label, batch=BATCH,
             requests=REQUESTS, launches=counts,
             median_ms={k: statistics.median(v[1:]) for k, v in lat.items()},
             first_ms={k: v[0] for k, v in lat.items()})
    serve_check(kmods, ops_torus, "cnn_serve", *cnn_runs["float32"][:2],
                cnn_runs["bfloat16"][1], CNN_REQUESTS, images)
    cnn_runs = {k: v[2] for k, v in cnn_runs.items()}
    lap("cnn_serve")

    cnn_trained = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for route in ROUTES:
            st = state.create_train_state(cnn4096(conv_vae, dtype, route),
                                          optimizer="adamw", lr=1e-4,
                                          device=DEVICE)
            per_step = {ROUTE_KERNEL[route]: 1, "torus_bwd": 1}
            history, ms, counts = train(
                kmods, st, loop.make_cnn_train_step(st.model, st.optimizer),
                per_step, CNN_TRAIN_STEPS, images,
                f"cnn4096 {label} {route}")
            cnn_trained[label, route] = counts
            emit("cnn_train", compute_dtype=label, sampler=route, batch=BATCH,
                 steps=CNN_TRAIN_STEPS, optimizer="adamw", lr=1e-4,
                 launches=counts, per_step_launches=per_step,
                 params_m=sum(p.numel() for p in st.model.parameters()) / 1e6,
                 median_ms_per_step=statistics.median(ms[1:]),
                 min_ms_per_step=min(ms[1:]), first_ms=ms[0],
                 first_losses=history[0], last_losses=history[-1])
            del st
    first = {}
    for route in ROUTES:
        first[route] = train_check(
            kmods, ops_torus, conv_vae,
            lambda dtype, route=route: cnn4096(conv_vae, dtype, route),
            images, f"cnn_train[{route}]", bf16=route == "keyed")
    rel = abs(first["keyed"]["total_loss"] - first["unfused"]["total_loss"]) \
        / abs(first["keyed"]["total_loss"])
    rng_model = cnn4096(conv_vae, torch.float32, "rng")
    again, _ = first_step(conv_vae, rng_model, images)
    other, _ = first_step(conv_vae, rng_model, images, key=(0, 1))
    emit("cnn_train_routes", keyed_vs_unfused_loss_rel=rel,
         rng_loss=first["rng"]["total_loss"], rng_loss_again=again[
             "total_loss"], rng_loss_other_key=other["total_loss"])
    check(rel <= 1e-5, f"cnn4096: the keyed and the unfused first loss "
                       f"differ by {rel}")
    check(again["total_loss"] == first["rng"]["total_loss"],
          "cnn4096 rng: one key gave two losses")
    check(other["total_loss"] != first["rng"]["total_loss"],
          "cnn4096 rng: another key gave the same loss")
    del rng_model
    torch.cuda.empty_cache()
    lap("cnn_train")

    attention_route(attention, rope, gen)
    lap("attention_route")
    image_counts = image256_phase(kmods, serving, vit_vae, state, loop, gen)
    lap("image256")
    head_counts = heads_phase(kmods, serving, conv_vae, vit_vae, state, loop,
                              trandom, images, gen)
    lap("heads")
    mlp_counts = mlp_phase(
        kmods, (loop, state, mlp_vae, losses, schedules, trandom))
    lap("mlp")
    hybrid_images = torch.rand(HYBRID_BATCH, 32, 32, 1, generator=gen,
                               device=DEVICE) * 2 - 1
    hybrid_counts, hybrid_state = hybrid_phase(
        kmods, ops_torus, serving, conv_vae, hybrid_vae, state, loop,
        hybrid_images)
    lap("hybrid")
    checkpoint_phase(kmods, checkpoint, hybrid_vae, state, loop,
                     hybrid_images, root)
    lap("checkpoint")
    eval_counts = eval_phase(
        kmods, (adapters, binding, capacity, class_means, knn),
        hybrid_state.model)
    lap("eval")
    fid_counts = fid_phase(kmods, (adapters, fid, inception, plots),
                           ops_torus, conv_vae, hybrid_state.model)
    del hybrid_state
    torch.cuda.empty_cache()
    lap("fid")
    runner_counts, arm_counts = runner_phase(
        kmods, (cnn_runner, fashion_train, cifar10_train, plots, conv_vae,
                loop, state, trandom, ops_torus), root)
    lap("runner")
    mnist_runner_counts = mnist_runners_phase(
        kmods, (cnn_runner, mnist_runner, mnist_clifpws, mnist_vmf, mlp_vae,
                ops_torus), root)
    lap("mnist_runners")
    with tempfile.TemporaryDirectory() as work:
        sweep_counts, ckpts = sweep_phase(kmods, (cnn_runner, fashion_train),
                                          root, work)
        viz_counts = figures_phase(
            kmods, (bundle_heatmap, rolefiller_heatmap,
                    binding_depth_heatmap, sample_viz,
                    paper_bind_bundle_figure, eval_battery_timing),
            ckpts, work)
    lap("sweep, figures")
    with tempfile.TemporaryDirectory() as work:
        export_counts = export_phase((serving, vit_vae, conv_vae, trandom),
                                     root, work)
    lap("export")
    with tempfile.TemporaryDirectory() as work:
        native_counts, native_op_ms = native_phase(
            (serving, vit_vae, conv_vae, mlp_vae, trandom, rope, knative),
            root, work, HOST_EXPORTS, native_built)
    lap("native")
    with tempfile.TemporaryDirectory() as work:
        native_data_phase(root, work)
    lap("native_data")
    with tempfile.TemporaryDirectory() as work:
        par = parallel_phase(kmods, {
            "layouts": (serving, vit_vae, param_import, param_convert, state,
                        loop),
            "bundle": (serving, conv_vae, trandom)}, root, work, images)
    lap("parallel")
    emit("mnist_runner_kernels", shape="mnist_mlp", R=MLP_BATCH,
         cases={f"{name},d{d}": {k: mnist[name, d][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
             for name in ("sampler_keyed", "torus_bwd")
             for d in MNIST_RUNNER_DIMS})
    # A and B at image 256's shape (B 4, S 260, 8 heads of 64): the
    # whole-sequence bfloat16 forward of serving, the tiled forms of float32
    # serving and of every train step, and the bfloat16 tiled forward timed
    # beside the whole one; then the tiled forms at flagship32's shape, for
    # the record (the route gives that shape the whole-sequence forms)
    i256 = (attention, rope, IMAGE256_BATCH, 260, 8, 64)
    att["bf16_image256"] = attention_case(*i256, torch.bfloat16, True, gen)
    att["f32_image256"] = attention_case(*i256, torch.float32, True, gen)
    att["bf16_image256_tiled"] = attention_case(*i256, torch.bfloat16, True,
                                                gen, tiled=True)
    for label in ("bf16_image256", "f32_image256", "bf16_image256_tiled"):
        emit("kernel", kernel="attention_fwd", shape="image256",
             **att[label])
    for label, dtype in (("f32_image256", torch.float32),
                         ("bf16_image256", torch.bfloat16)):
        att_b[label] = attention_bwd_case(*i256, dtype, True, gen)
        emit("kernel", kernel="attention_bwd", shape="image256",
             **att_b[label])
    for dtype in (torch.float32, torch.bfloat16):
        for name, case in (("attention_fwd", attention_case),
                           ("attention_bwd", attention_bwd_case)):
            emit("kernel", kernel=name, shape="flagship32 (tiled form, for "
                                              "the record)",
                 **case(attention, rope, BATCH, 68, 8, 64, dtype, True, gen,
                        tiled=True))

    def launched(name, path, dtype=None):
        """Launches on a main path, serving plus training, in one compute
        dtype or in both."""
        if path == "flagship32_heads":
            return sum(c[name] for (p, _, label), pair in head_counts.items()
                       if p == "flagship32" and dtype == label
                       for c in pair)
        if path == "image256":
            return sum(c[name] for c in image_counts[dtype])
        if path == "hybrid_fashion4096":  # the path and the eval battery
            return hybrid_counts.get(name, 0) + eval_counts.get(name, 0)
        if path == "cifar_fid4096":  # compute_fid and the plots
            return fid_counts.get(name, 0)
        if path == "runner_fashion4096":  # both runs and the eval child
            return runner_counts.get(name, 0)
        if path in ("runner_hybrid128", "runner_vit128"):
            return arm_counts[path[len("runner_"):-len("128")]].get(name, 0)
        if path == f"sweep_cnn{SWEEP_LATENT}":  # the children and in process
            return sweep_counts.get(name, 0)
        if path == "sample_viz":
            return viz_counts.get(name, 0)
        if path.startswith("export_"):  # the loaded programs' launches
            suffix = {"float32": "_f32", "bfloat16": "_bf16", None: ""}[dtype]
            return sum(c.get(name, 0) for label, c in export_counts.items()
                       if label.startswith(path[len("export_"):])
                       and label.endswith(suffix))
        if path.startswith("native_"):  # inside the C++ host's requests
            suffix = {"float32": "_f32", "bfloat16": "_bf16", None: ""}[dtype]
            return sum(c.get(name, 0) for label, fns in native_counts.items()
                       if label.startswith(path[len("native_"):])
                       and label.endswith(suffix) for c in fns.values())
        if path == "parallel_layouts_packed":  # the fused layouts' A and B
            return sum(c.get(name, 0) for (label, lay), c in
                       par["layouts"].items()
                       if label == dtype and lay.startswith("fused"))
        if path.startswith("parallel_"):
            return par[path[len("parallel_"):]].get(name, 0)
        if path.startswith("mnist_runner"):  # "mnist_runner,d<d>"
            return mnist_runner_counts[int(path.split(",d")[1])].get(name, 0)
        if path.startswith("mnist_mlp"):  # "mnist_mlp,d<d>"
            return mlp_counts[int(path.split(",d")[1])].get(name, 0)
        served, stepped = ((runs, trained) if path == "flagship32"
                           else (cnn_runs, cnn_trained))
        return sum(c[name] for group in (served, stepped)
                   for label, c in group.items()
                   if dtype in (None, label, label[0]))

    def entry(name, path, source, replaces, case, dtype=None):
        tag = f"{dtype},{path}" if dtype else path
        launches = launched(name, path, dtype)
        if name in ("attention_fwd", "attention_bwd"):
            # the whole-sequence form's share; the tiled form has its rows
            launches -= launched(f"{name}_tiled", path, dtype)
        return {"name": f"{name}[{tag}]", "route": "cuda",
                "source": f"cliffordtpu_torch/csrc/{source}",
                "replaces": f"cliffordtpu/kernels/{replaces}",
                "launches": launches,
                **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                **({"form": case["form"]} if "form" in case else {})}

    att_src, att_tpu = "attention_fwd.cu", "attention_pallas.py:139"
    att_b_src, att_b_tpu = "attention_bwd.cu", "attention_pallas.py:157"
    kernels = [
        entry("attention_fwd", "flagship32", att_src, att_tpu, att["f32"],
              "float32"),
        entry("attention_fwd", "flagship32", att_src, att_tpu, att["bf16"],
              "bfloat16"),
        entry("attention_bwd", "flagship32", att_b_src, att_b_tpu,
              att_b["f32"], "float32"),
        entry("attention_bwd", "flagship32", att_b_src, att_b_tpu,
              att_b["bf16"], "bfloat16"),
        entry("attention_fwd", "flagship32_heads", att_src, att_tpu,
              att["f32"], "float32"),
        entry("attention_fwd", "flagship32_heads", att_src, att_tpu,
              att["bf16"], "bfloat16"),
        entry("attention_bwd", "flagship32_heads", att_b_src, att_b_tpu,
              att_b["f32"], "float32"),
        entry("attention_bwd", "flagship32_heads", att_b_src, att_b_tpu,
              att_b["bf16"], "bfloat16"),
        entry("attention_fwd", "image256", att_src, att_tpu,
              att["bf16_image256"], "bfloat16"),
        entry("attention_fwd_tiled", "image256", att_src, att_tpu,
              att["f32_image256"], "float32"),
        entry("attention_fwd_tiled", "image256", att_src, att_tpu,
              att["bf16_image256_tiled"], "bfloat16"),
        entry("attention_bwd_tiled", "image256", att_b_src, att_b_tpu,
              att_b["f32_image256"], "float32"),
        entry("attention_bwd_tiled", "image256", att_b_src, att_b_tpu,
              att_b["bf16_image256"], "bfloat16"),
        entry("torus_fwd", "cnn4096", "torus_fwd.cu", "torus_pallas.py:126",
              tor_f["cnn4096"]),
        entry("torus_bwd", "flagship32", "torus_bwd.cu",
              "torus_pallas.py:154", tor["flagship32"]),
        entry("torus_bwd", "cnn4096", "torus_bwd.cu", "torus_pallas.py:154",
              tor["cnn4096"]),
        entry("sampler_rng", "cnn4096", "sampler_rng.cu",
              "sampler_pallas.py:212", smp["rng", "cnn4096"]),
        entry("sampler_keyed", "flagship32", "sampler_keyed.cu",
              "sampler_pallas.py:356", smp["keyed", "flagship32"]),
        entry("sampler_keyed", "cnn4096", "sampler_keyed.cu",
              "sampler_pallas.py:356", smp["keyed", "cnn4096"]),
    ]
    for (name, d), case in mnist.items():
        kernels.append({
            **entry(name, f"mnist_mlp,d{d}",
                    "sampler_keyed.cu" if name == "sampler_keyed"
                    else "torus_bwd.cu",
                    "sampler_pallas.py:356" if name == "sampler_keyed"
                    else "torus_pallas.py:154", case),
            "shape": "mnist_mlp", "R": case["R"], "d": d})
    for name, case in hybrid.items():
        kernels.append({
            **entry(name, "hybrid_fashion4096", f"{name}.cu",
                    "sampler_pallas.py:356" if name == "sampler_keyed"
                    else "torus_pallas.py:154", case),
            "shape": "hybrid_fashion4096", "R": case["R"], "d": case["d"]})
    for name, case in fid_cases.items():
        kernels.append({
            **entry(name, "cifar_fid4096", f"{name}.cu",
                    "torus_pallas.py:126" if name == "torus_fwd"
                    else "sampler_pallas.py:356", case),
            "shape": "cifar_fid4096", "R": case["R"], "d": case["d"]})
    for name, case in runner_cases.items():
        kernels.append({
            **entry(name, "runner_fashion4096", f"{name}.cu", {
                "torus_fwd": "torus_pallas.py:126",
                "torus_bwd": "torus_pallas.py:154",
                "sampler_keyed": "sampler_pallas.py:356"}[name], case),
            "shape": "runner_fashion4096", "R": case["R"], "d": case["d"]})
    for (name, path), case in arm_cases.items():
        kernels.append({
            **entry(name, path, f"{name}.cu", {
                "attention_fwd": att_tpu, "attention_bwd": att_b_tpu,
                "torus_bwd": "torus_pallas.py:154",
                "sampler_keyed": "sampler_pallas.py:356"}[name], case,
                "float32" if name.startswith("attention") else None),
            "shape": path, **{k: case[k] for k in ("B", "S", "H", "hd", "R",
                                                   "d") if k in case}})
    for name in ("sampler_keyed", "torus_bwd"):
        for d in MNIST_RUNNER_DIMS:
            kernels.append({
                **entry(name, f"mnist_runner,d{d}", f"{name}.cu",
                        "sampler_pallas.py:356" if name == "sampler_keyed"
                        else "torus_pallas.py:154", mnist[name, d]),
                "shape": "mnist_mlp", "R": MLP_BATCH, "d": d})
    for name, case in sweep_cases.items():
        kernels.append({
            **entry(name, f"sweep_cnn{SWEEP_LATENT}", f"{name}.cu",
                    "sampler_pallas.py:356" if name == "sampler_keyed"
                    else "torus_pallas.py:154", case),
            "shape": f"sweep_cnn{SWEEP_LATENT}", "R": case["R"],
            "d": case["d"]})
    kernels.append({
        **entry("sampler_keyed", "sample_viz", "sampler_keyed.cu",
                "sampler_pallas.py:356", viz_case),
        "shape": "sample_viz", "R": viz_case["R"], "d": viz_case["d"]})
    # the kernels inside the exported programs, loaded without model code
    kernels += [
        {**entry("attention_fwd", "export_flagship32", att_src, att_tpu,
                 att["f32"], "float32"), "shape": "flagship32 bundle"},
        {**entry("attention_fwd", "export_flagship32", att_src, att_tpu,
                 att["bf16"], "bfloat16"), "shape": "flagship32 bundle"},
        {**entry("sampler_keyed", "export_flagship32", "sampler_keyed.cu",
                 "sampler_pallas.py:356", smp["keyed", "flagship32"]),
         "shape": "flagship32 bundle"},
        {**entry("sampler_keyed", "export_cnn4096", "sampler_keyed.cu",
                 "sampler_pallas.py:356", smp["keyed", "cnn4096"]),
         "shape": "cnn4096 bundle"}]
    # the kernels inside the Python-free host's requests: launches are the
    # operator library's own counts, read by the host; ms, plain_ms and
    # the error are the kernel phase's, of the ctypes build of the same
    # source and nvcc flags; op_ms is the library's operator on the card
    # (for torus_fwd the whole unfused sample_embed: the threefry
    # uniforms and the circle formula before C)
    timed = ("ms, plain_ms, max_abs_err: the ctypes build of the same "
             "source and flags; op_ms: the cliffordtpu_native operator")

    def native_row(name, path, source, replaces, case, op, shape,
                   dtype=None):
        return {**entry(name, path, source, replaces, case, dtype),
                "shape": shape, "op_ms": native_op_ms[op], "timed": timed}

    R_f, R_c = BATCH * 64, BATCH
    kernels += [
        native_row("attention_fwd", "native_flagship32", att_src, att_tpu,
                   att["f32"], ("attention_fwd", torch.float32),
                   "flagship32 native host", "float32"),
        native_row("attention_fwd", "native_flagship32", att_src, att_tpu,
                   att["bf16"], ("attention_fwd", torch.bfloat16),
                   "flagship32 native host", "bfloat16"),
        native_row("sampler_keyed", "native_flagship32", "sampler_keyed.cu",
                   "sampler_pallas.py:356", smp["keyed", "flagship32"],
                   ("sample_embed", "keyed", R_f), "flagship32 native host"),
        native_row("sampler_keyed", "native_cnn4096", "sampler_keyed.cu",
                   "sampler_pallas.py:356", smp["keyed", "cnn4096"],
                   ("sample_embed", "keyed", R_c), "cnn4096 native host"),
        native_row("sampler_rng", "native_cnn4096", "sampler_rng.cu",
                   "sampler_pallas.py:212", smp["rng", "cnn4096"],
                   ("sample_embed", "rng", R_c), "cnn4096 native host"),
        native_row("torus_fwd", "native_cnn4096", "torus_fwd.cu",
                   "torus_pallas.py:126", tor_f["cnn4096"],
                   ("sample_embed", "unfused", R_c), "cnn4096 native host")]
    # the parallel phase's paths: F and E at a row base (rank 1 of two), A
    # and B on the packed layout, F and D at a world of 1, F in the
    # data-parallel bundle
    for (name, tag), case in par_cases.items():
        if tag == "row0":
            kernels.append({
                **entry(name, f"parallel_ranks_{name[8:]}_row0",
                        f"{name}.cu", "sampler_pallas.py:356"
                        if name == "sampler_keyed"
                        else "sampler_pallas.py:212", case),
                "shape": "runner_fashion4096 rank 1 of 2", "R": case["R"],
                "d": case["d"], "row0": case["row0"]})
        else:
            kernels.append({
                **entry(name, "parallel_layouts_packed", f"{name}.cu",
                        att_tpu if name == "attention_fwd" else att_b_tpu,
                        case, tag),
                "shape": "flagship32 fused_proj", "layout": "packed"})
    kernels += [
        {**entry("sampler_keyed", "parallel_world1", "sampler_keyed.cu",
                 "sampler_pallas.py:356", runner_cases["sampler_keyed"]),
         "shape": "runner_fashion4096 world 1"},
        {**entry("torus_bwd", "parallel_world1", "torus_bwd.cu",
                 "torus_pallas.py:154", runner_cases["torus_bwd"]),
         "shape": "runner_fashion4096 world 1"},
        {**entry("sampler_keyed", "parallel_dp_bundle", "sampler_keyed.cu",
                 "sampler_pallas.py:356", smp["keyed", "cnn4096"]),
         "shape": "cnn4096 data_parallel=2 bundle"}]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    lap("last cases")
    emit("seconds", total=time.perf_counter() - start,
         longest=dict(sorted(phase_s.items(), key=lambda kv: -kv[1])[:6]),
         phases=phase_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--export-child"]:
        sys.exit(export_child(sys.argv[2]))
    if sys.argv[1:2] == ["--native-export-child"]:
        sys.exit(native_export_child(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2]))
    sys.exit(main())
