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
            256), with the form that
            ran (attention forward and backward: "mma" or "simt"; torus
            forward and Philox sampler: "fft" or "table"), its device time
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
5. train    the same model takes ``TRAIN_STEPS`` AdamW steps (lr 1e-4,
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
            gradient: the bfloat16 forward without a gradient must take
            kernel A, every other case the dense route (``attention_dense``,
            SDPA after the rotation), read from the counts; outputs and
            gradients against the plain versions at the attention bars;
9. image256  ``CliffordARVAE(image_size=256)`` (``default_config(256)``: 6
            + 12 blocks of S 260), clifford latent 16, batch 4: one request
            of each entry point and one train step per dtype; bfloat16
            serving launches A 6 / 6 / 12 times, float32 serving takes the
            dense route 6 / 6 / 12 times, and every step 18 times with no
            launch of A or B; the bfloat16 first loss within
            ``TRAIN_BARS`` of the float32 one;
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

then the table of all six kernels as one JSON line (the attention kernels
also on the heads' path and at image 256; the keyed sampler and the torus
backward also at the MNIST shapes and at the hybrid's, R 16384 rows of d
256; the torus forward and the keyed sampler at cifar_fid4096's, R 256 and
R 200 of d 4096), the ``nvidia-smi`` line, and
last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

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


def attention_case(attention, rope, B, S, H, hd, dtype, use_rope, gen):
    dev = DEVICE
    q, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    cos = sin = None
    if use_rope:
        c, s = rope.rope_2d_cos_sin(32, math.isqrt(S - 4), hd,
                                    cls_token_num=4)
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev)
    got = attention.fused_attention(q, k, v, cos, sin)
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
    kernel = cuda_ms(lambda: attention.fused_attention(q, k, v, cos, sin))
    plain = cuda_ms(lambda: attention.attention_plain(q, k, v, cos, sin))
    library = cuda_ms(lambda: sdpa(qh, kh, vh))
    # a checkout from before the tensor-core form had the CUDA-core one only
    form = getattr(attention, "fwd_form", lambda dt: "simt")(dtype)
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, form=form, max_abs_err=err, ms=kernel, plain_ms=plain,
        library_ms=library, bound_ms=b_ms, bound_by=b_by)


def attention_bwd_case(attention, rope, B, S, H, hd, dtype, use_rope, gen):
    dev = DEVICE
    q, k, v, d_out = (torch.randn(B, S, H, hd, generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
    cos = sin = None
    if use_rope:
        c, s = rope.rope_2d_cos_sin(32, math.isqrt(S - 4), hd,
                                    cls_token_num=4)
        cos, sin = torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev)
    got = attention.fused_attention_bwd(q, k, v, cos, sin, d_out)
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
    # through autograd, as the model reaches the kernel
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = attention.bwd_launches
    auto = torch.autograd.grad(
        attention.fused_attention(qg, kg, vg, cos, sin), (qg, kg, vg), d_out)
    check(attention.bwd_launches == before + 1,
          "autograd of fused_attention did not launch the backward kernel")
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
    kernel = cuda_ms(
        lambda: attention.fused_attention_bwd(q, k, v, cos, sin, d_out))
    plain = cuda_ms(
        lambda: attention.attention_bwd_plain(q, k, v, cos, sin, d_out))
    library = cuda_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    # a checkout from before the redesign had one scalar form
    form = getattr(attention, "bwd_form", lambda dt: "scalar")(dtype)
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, form=form, max_abs_err=max(errs.values()), errors=errs,
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


def torus_bound_ms(nbytes, R, d):
    """(bound ms, what binds, the dense form's bound ms) of a kernel that
    embeds R rows of d angles or differentiates that embedding.  The
    function is a real FFT of length n = 2d per row (about 2.5 n log2 n
    operations), so it is bound by its bytes; the kernels here compute it
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
    # a checkout from before the FFT form had the table form only
    form = getattr(torus, "fwd_form", lambda d_: "table")(d)
    return dict(R=R, d=d, form=form, max_abs_err=err,
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
    return dict(R=R, d=d, epilogue=epilogue, form="table",
                max_abs_err=max(errs.values()), errors=errs, ms=cuda_ms(run),
                plain_ms=cuda_ms(run_plain, reps=5),
                matmul_ms=matmul_yardstick_ms(ops_torus, theta, g),
                library_ms=cuda_ms(run_fft), bound_ms=b_ms, bound_by=b_by,
                dense_bound_ms=dense)


def sampler_case(sampler, route, R, d, per_row_kappa, gen):
    """A fused sampler + embedding kernel ("keyed" or "rng") against its
    plain version: u and v bit for bit, theta and x to 1e-5."""
    dev = DEVICE
    fused = getattr(sampler, f"sample_embed_{route}")
    plain = getattr(sampler, f"sample_embed_{route}_plain")
    loc = (torch.rand(R, d, generator=gen, device=dev) * 2 - 1) * math.pi
    kshape = (R, 1) if per_row_kappa else (R, d)
    kappa = torch.rand(kshape, generator=gen, device=dev) * 10 + 0.03
    key = (0, 1234 + R + d)
    got = fused(key, loc, kappa)
    want = plain(key, loc, kappa)
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
    # the keyed kernel, and a checkout from before the FFT form, have the
    # table form only
    form = getattr(sampler, "rng_form", lambda d_: "table")(d) \
        if route == "rng" else "table"
    return dict(
        route=route, R=R, d=d, per_row_kappa=per_row_kappa, form=form,
        max_abs_err=errs["x"], errors=errs,
        ms=cuda_ms(lambda: fused(key, loc, kappa)),
        plain_ms=cuda_ms(lambda: plain(key, loc, kappa), reps=5),
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
            "attention_dense": attention.dense_calls,
            "torus_fwd": torus.fwd_launches, "torus_bwd": torus.launches,
            "sampler_keyed": sampler.launches,
            "sampler_rng": sampler.rng_launches}


def zero_counts(attention, sampler, torus):
    attention.launches = attention.bwd_launches = attention.dense_calls = 0
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
    RoPE) in each dtype, with and without a gradient: the route each took
    (read from the counts), against the expected ones, and the outputs and
    gradients against the plain versions at the attention bars."""
    B, S, H, hd = 4, 260, 8, 64
    c, s_ = rope.rope_2d_cos_sin(256, 16, hd, cls_token_num=4)
    cos, sin = torch.from_numpy(c).to(DEVICE), torch.from_numpy(s_).to(DEVICE)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, d_out = (torch.randn(B, S, H, hd, generator=gen,
                                      device=DEVICE).to(dtype)
                          for _ in range(4))
        for grad in (False, True):
            qg, kg, vg = (t.clone().requires_grad_(grad) for t in (q, k, v))
            before = (attention.launches, attention.bwd_launches,
                      attention.dense_calls)
            out = attention.fused_attention(qg, kg, vg, cos, sin)
            grads = (torch.autograd.grad(out, (qg, kg, vg), d_out) if grad
                     else None)
            torch.cuda.synchronize()
            moved = tuple(a - b for a, b in zip(
                (attention.launches, attention.bwd_launches,
                 attention.dense_calls), before))
            route = {(1, 0, 0): "kernel", (1, 1, 0): "kernel",
                     (0, 0, 1): "dense"}.get(moved, f"counts {moved}")
            want_route = ("kernel" if dtype == torch.bfloat16 and not grad
                          else "dense")
            check(route == want_route, f"attention_route {dtype} grad={grad}"
                                       f": took {route}, expected "
                                       f"{want_route}")
            want = attention.attention_plain(q, k, v, cos, sin)
            err = (out.detach().float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            bar = 1e-5 if dtype == torch.float32 else 2e-2 * scale
            check(err <= bar, f"attention_route {dtype} grad={grad}: output "
                              f"error {err} > {bar}")
            row = dict(dtype=str(dtype).replace("torch.", ""), grad=grad,
                       route=route, max_abs_err=err, bar=bar)
            if grad:
                ref = attention.attention_bwd_plain(q, k, v, cos, sin, d_out)
                errs = {}
                for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
                    errs[name] = (a.float() - b.float()).abs().max().item()
                    gbar = (1e-5 if dtype == torch.float32 else 2e-2) * max(
                        1.0, b.float().abs().max().item())
                    check(errs[name] <= gbar,
                          f"attention_route {dtype}: {name} error "
                          f"{errs[name]} > {gbar}")
                row["grad_errors"] = errs
            rows.append(row)
    emit("attention_route", B=B, S=S, H=H, hd=hd, cases=rows,
         smem_bytes={"fwd_f32": attention.smem_bytes(S, hd),
                     "fwd_bf16": attention.smem_bytes(S, hd, torch.bfloat16),
                     "bwd_f32": attention.bwd_smem_bytes(S, hd),
                     "bwd_bf16": attention.bwd_smem_bytes(
                         S, hd, torch.bfloat16)},
         smem_max=attention._SMEM_MAX)


IMAGE256_BATCH = 4


def image256(vit_vae, dtype):
    """``CliffordARVAE(image_size=256)`` at ``default_config(256)``: 6
    encoder and 12 decoder blocks of S 260, clifford latent 16."""
    return vit_vae.CliffordARVAE(latent_dim=16, image_size=256,
                                 compute_dtype=dtype, seed=0)


def image256_phase(kmods, serving, vit_vae, state, loop, gen):
    """Serve one request of each entry point and take one train step per
    dtype: bfloat16 serving takes the forward kernel (it fits at S 260),
    float32 serving and every train step the dense route."""
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
                          {"attention_dense": 6}),
            "encode_z": (FLAGSHIP_REQUESTS["encode_z"][0],
                         {"attention_dense": 6, "sampler_keyed": 1}),
            "decode": (FLAGSHIP_REQUESTS["decode"][0],
                       {"attention_dense": 12})},
    }
    per_step = {"attention_dense": 18, "sampler_keyed": 1, "torus_bwd": 1}
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
    from cliffordtpu_torch.nn import (
        conv_vae,
        hybrid_vae,
        losses,
        mlp_vae,
        rope,
        vit_vae,
    )
    from cliffordtpu_torch.ops import torus as ops_torus
    from cliffordtpu_torch.train import checkpoint, loop, schedules, state
    from cliffordtpu_torch.vsa import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
        emit("ptxas", source=name, report=[line.strip() for line in log
                                           if "ptxas info" in line])

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

    trained = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        st = state.create_train_state(flagship(vit_vae, dtype),
                                      optimizer="adamw", lr=1e-4,
                                      device=DEVICE)
        per_step = {k: v for k, v in PER_STEP.items() if v}
        history, ms, counts = train(
            kmods, st, loop.make_cnn_train_step(st.model, st.optimizer),
            per_step, TRAIN_STEPS, images, f"flagship32 {label}")
        trained[label] = counts
        emit("train", compute_dtype=label, batch=BATCH, steps=TRAIN_STEPS,
             optimizer="adamw", lr=1e-4, launches=counts,
             per_step_launches=per_step,
             median_ms_per_step=statistics.median(ms[1:]),
             min_ms_per_step=min(ms[1:]), first_ms=ms[0],
             first_losses=history[0], last_losses=history[-1])
        del st
    train_check(kmods, ops_torus, conv_vae,
                lambda dtype: flagship(vit_vae, dtype), images, "train")
    runs = {k: v[2] for k, v in runs.items()}  # keep the counts only
    torch.cuda.empty_cache()

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

    attention_route(attention, rope, gen)
    image_counts = image256_phase(kmods, serving, vit_vae, state, loop, gen)
    head_counts = heads_phase(kmods, serving, conv_vae, vit_vae, state, loop,
                              trandom, images, gen)
    mlp_counts = mlp_phase(
        kmods, (loop, state, mlp_vae, losses, schedules, trandom))
    hybrid_images = torch.rand(HYBRID_BATCH, 32, 32, 1, generator=gen,
                               device=DEVICE) * 2 - 1
    hybrid_counts, hybrid_state = hybrid_phase(
        kmods, ops_torus, serving, conv_vae, hybrid_vae, state, loop,
        hybrid_images)
    checkpoint_phase(kmods, checkpoint, hybrid_vae, state, loop,
                     hybrid_images, root)
    eval_counts = eval_phase(
        kmods, (adapters, binding, capacity, class_means, knn),
        hybrid_state.model)
    fid_counts = fid_phase(kmods, (adapters, fid, inception, plots),
                           ops_torus, conv_vae, hybrid_state.model)
    del hybrid_state
    torch.cuda.empty_cache()
    att["bf16_image256"] = attention_case(attention, rope, IMAGE256_BATCH,
                                          260, 8, 64, torch.bfloat16, True,
                                          gen)
    emit("kernel", kernel="attention_fwd", **att["bf16_image256"])

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
        if path.startswith("mnist_mlp"):  # "mnist_mlp,d<d>"
            return mlp_counts[int(path.split(",d")[1])].get(name, 0)
        served, stepped = ((runs, trained) if path == "flagship32"
                           else (cnn_runs, cnn_trained))
        return sum(c[name] for group in (served, stepped)
                   for label, c in group.items()
                   if dtype in (None, label, label[0]))

    def entry(name, path, source, replaces, case, dtype=None):
        tag = f"{dtype},{path}" if dtype else path
        return {"name": f"{name}[{tag}]", "route": "cuda",
                "source": f"cliffordtpu_torch/csrc/{source}",
                "replaces": f"cliffordtpu/kernels/{replaces}",
                "launches": launched(name, path, dtype),
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
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
