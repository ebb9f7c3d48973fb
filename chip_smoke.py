#!/usr/bin/env python3
"""Drive the PyTorch port (``cliffordtpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line and each fatal when it fails:

1. env      the card (``nvidia-smi`` name and power limit), torch, CUDA;
2. build    every ``cliffordtpu_torch/csrc/*.cu`` compiled from the
            checkout, all at once, into ``build/cliffordtpu_torch``;
3. kernels  each CUDA kernel (attention forward and backward, keyed
            sampler, torus backward) against its plain PyTorch version on
            the card at the main paths' shapes, with its device time (CUDA
            events, median after warm-up; see ``cuda_ms``), the plain
            version's, a PyTorch library call's where one computes the same
            function, and its bound;
4. serve    the flagship32 ``CliffordARVAE`` (``default_config(32)``: 32 px,
            latent 16, 8 heads of 64, 4 + 8 blocks) at full width with
            seeded random weights answers batch-64 requests through
            ``CliffordARServing.encode_mu`` / ``encode_z`` / ``decode`` in
            float32 and in bfloat16 compute.  The launch counts are set to 0
            before each dtype's requests and read after; every request must
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

then the kernel table as one JSON line, the ``nvidia-smi`` line, and last
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
import time

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
PER_STEP = {"attention_fwd": 12, "attention_bwd": 12, "sampler_keyed": 1,
            "torus_bwd": 1}
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
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, max_abs_err=err, ms=kernel, plain_ms=plain,
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
    return dict(
        B=B, S=S, H=H, hd=hd, dtype=str(dtype).replace("torch.", ""),
        rope=use_rope, max_abs_err=max(errs.values()), errors=errs,
        scales=scales, ms=kernel, plain_ms=plain, library_ms=library,
        bound_ms=b_ms, bound_by=b_by)


def torus_bwd_case(torus, sampler, R, d, epilogue, gen):
    """The torus backward kernel alone (``torus_bwd``), or with the keyed
    sampler's concentration epilogue (``sampler_bwd``) on the residuals of
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
        names = ("dloc", "dkappa")
        # theta, u, v, g, kappa read; dloc, dkappa (R, d) written
        nbytes = 4 * (3 * theta.numel() + g.numel() + kappa.numel()
                      + 2 * R * d)
    else:
        theta = (torch.rand(R, d - 1, generator=gen, device=dev) * 2 - 1) \
            * math.pi
        run = lambda: (torus.torus_bwd(theta, g),)
        run_plain = lambda: (torus.torus_bwd_plain(theta, g),)
        names = ("dtheta",)
        nbytes = 4 * (2 * theta.numel() + g.numel())
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(names, got, want):
        errs[name] = (a - b).abs().max().item()
        bar = 1e-5 * max(1.0, b.abs().max().item())
        check(a.shape == b.shape and bool(torch.isfinite(a).all())
              and errs[name] <= bar,
              f"torus_bwd R={R} d={d} {name}: err {errs[name]} > {bar}")
    if epilogue:
        check(bool((got[0][:, 0] == 0).all() and (got[1][:, 0] == 0).all()),
              "sampler_bwd: column 0 (the pinned angle) is not zero")
        # through autograd, as the model reaches the kernel
        lg, kg = loc.clone().requires_grad_(), kappa.clone().requires_grad_()
        before = torus.launches
        x, _, _, _ = sampler.sample_embed_keyed((0, 77 + R + d), lg, kg)
        a_loc, a_kap = torch.autograd.grad(x, (lg, kg), g)
        check(torus.launches == before + 1,
              "autograd of sample_embed_keyed did not launch torus_bwd")
        check(torch.equal(a_loc, got[0]) and bool(torch.allclose(
            a_kap, got[1].sum(1, keepdim=True), rtol=1e-5, atol=1e-6)),
            "autograd of sample_embed_keyed differs from sampler_bwd")
    # two float32 multiply-adds per (row, angle, column)
    b_ms, b_by = bound_ms(nbytes, 8.0 * R * (d - 1) * d, torch.float32)
    return dict(R=R, d=d, epilogue=epilogue, max_abs_err=max(errs.values()),
                errors=errs, ms=cuda_ms(run), plain_ms=cuda_ms(run_plain),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def sampler_case(sampler, R, d, per_row_kappa, gen):
    dev = DEVICE
    loc = (torch.rand(R, d, generator=gen, device=dev) * 2 - 1) * math.pi
    kshape = (R, 1) if per_row_kappa else (R, d)
    kappa = torch.rand(kshape, generator=gen, device=dev) * 10 + 0.03
    key = (0, 1234 + R + d)
    got = sampler.sample_embed_keyed(key, loc, kappa)
    want = sampler.sample_embed_keyed_plain(key, loc, kappa)
    torch.cuda.synchronize()
    names = ("x", "theta", "u", "v")
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(names, got, want)}
    for i, name in ((2, "u"), (3, "v")):
        check(torch.equal(got[i], want[i]),
              f"sampler R={R} d={d}: {name} not bit-exact")
    check(errs["theta"] <= 1e-5 and errs["x"] <= 1e-5,
          f"sampler R={R} d={d}: theta/x errors {errs} > 1e-5")
    # loc + kappa read; x, theta, u, v written (float32)
    nbytes = 4 * (loc.numel() + kappa.numel() + R * 2 * d + 3 * R * (d - 1))
    # the embedding's float32 multiply-adds, 2 terms per (row, angle, col)
    b_ms, b_by = bound_ms(nbytes, 8.0 * R * (d - 1) * d, torch.float32)
    kernel = cuda_ms(lambda: sampler.sample_embed_keyed(key, loc, kappa))
    plain = cuda_ms(lambda: sampler.sample_embed_keyed_plain(key, loc, kappa))
    return dict(
        R=R, d=d, per_row_kappa=per_row_kappa, max_abs_err=errs["x"],
        errors=errs, ms=kernel, plain_ms=plain, library_ms=None,
        bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def plain_versions(attention, sampler):
    """Swap the plain PyTorch versions in for the kernels, so the same
    requests can be answered, and the same step taken, without them on the
    card: autograd then differentiates the plain forward versions, and no
    backward kernel is reached either."""
    saved = attention.fused_attention, sampler.sample_embed_keyed
    attention.fused_attention = attention.attention_plain
    sampler.sample_embed_keyed = sampler.sample_embed_keyed_plain
    try:
        yield
    finally:
        attention.fused_attention, sampler.sample_embed_keyed = saved


def flagship(vit_vae, dtype):
    return vit_vae.CliffordARVAE(latent_dim=16, image_size=32, in_channels=1,
                                 compute_dtype=dtype, seed=0)


def serve(serving, vit_vae, attention, sampler, dtype, images):
    """Answer REQUESTS batch-64 requests per entry point; returns the
    outputs of the last request, latencies and the launch counts."""
    srv = serving.CliffordARServing(flagship(vit_vae, dtype), device=DEVICE)
    per_request = {"encode_mu": (4, 0), "encode_z": (4, 1), "decode": (8, 0)}
    lat = {name: [] for name in per_request}
    attention.launches = sampler.launches = 0
    for i in range(REQUESTS):
        key = (0, i)
        calls = {"encode_mu": lambda: srv.encode_mu(images),
                 "encode_z": lambda: srv.encode_z(key, images)}
        outs = {}
        for name in ("encode_mu", "encode_z", "decode"):
            fn = calls.get(name) or (lambda: srv.decode(outs["encode_z"]))
            before = (attention.launches, sampler.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
            moved = (attention.launches - before[0],
                     sampler.launches - before[1])
            check(moved == per_request[name],
                  f"{name} {dtype}: launches moved {moved}, "
                  f"expected {per_request[name]}")
    counts = {"attention_fwd": attention.launches,
              "sampler_keyed": sampler.launches}
    check(outs["encode_mu"].shape == (BATCH, 1024), "encode_mu shape")
    check(outs["encode_z"].shape == (BATCH, 2048), "encode_z shape")
    check(outs["decode"].shape == (BATCH, 32, 32, 1), "decode shape")
    for name, out in outs.items():
        check(bool(torch.isfinite(out).all()), f"{name} {dtype}: not finite")
    norms = outs["encode_z"].reshape(BATCH, 64, 32).norm(dim=-1)
    check((norms - 1).abs().max().item() < 1e-4,
          "encode_z: torus points are not of unit norm")
    return srv, outs, lat, counts


def launch_counts(attention, sampler, torus):
    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            "sampler_keyed": sampler.launches, "torus_bwd": torus.launches}


def train(mods, dtype, images):
    """One warm-up and TRAIN_STEPS timed AdamW steps on one batch; returns
    the per-step losses, the step times and the launch counts."""
    vit_vae, state, loop, attention, sampler, torus = mods
    st = state.create_train_state(flagship(vit_vae, dtype), optimizer="adamw",
                                  lr=1e-4, device=DEVICE)
    step = loop.make_cnn_train_step(st.model, st.optimizer)
    beta = torch.ones((), device=DEVICE)
    attention.launches = attention.bwd_launches = 0
    sampler.launches = torus.launches = 0
    history, ms = [], []
    for i in range(TRAIN_STEPS + 1):
        before = launch_counts(attention, sampler, torus)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(images, (0, i), beta)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts(attention, sampler, torus)
        moved = {k: after[k] - before[k] for k in after}
        check(moved == PER_STEP,
              f"train step {i} {dtype}: launches moved {moved}, expected "
              f"{PER_STEP}")
        history.append({k: v.item() for k, v in losses.items()})
        check(all(math.isfinite(v) for v in history[-1].values()),
              f"train step {i} {dtype}: losses not finite: {history[-1]}")
    counts = launch_counts(attention, sampler, torus)
    check(history[-1]["total_loss"] < history[0]["total_loss"],
          f"train {dtype}: total loss did not fall: "
          f"{history[0]['total_loss']} -> {history[-1]['total_loss']}")
    for p in st.model.parameters():
        check(p.dtype == torch.float32 and p.grad.dtype == torch.float32,
              f"train {dtype}: a parameter or gradient is not float32")
    for moments in st.optimizer.inner.state.values():
        check(moments["exp_avg"].dtype == torch.float32
              and moments["exp_avg_sq"].dtype == torch.float32,
              f"train {dtype}: an Adam moment is not float32")
    return history, ms, counts


def first_step(vit_vae, conv_vae, dtype, images):
    """Loss pieces and gradients of the first train step (seeded weights,
    key (0, 0), beta 1), without the update."""
    model = flagship(vit_vae, dtype).to(DEVICE).train()
    x_recon, q_z, p_z, _ = model(images, (0, 0))
    losses = conv_vae.cnn_vae_loss(
        images, x_recon, q_z, p_z, model.distribution, beta=1.0,
        recon_loss_type=model.recon_loss_type, l1_weight=model.l1_weight)
    losses["total_loss"].backward()
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


def train_check(mods, conv_vae, images):
    vit_vae, _, _, attention, sampler, torus = mods
    losses, grads = first_step(vit_vae, conv_vae, torch.float32, images)
    bf16_losses, bf16_grads = first_step(vit_vae, conv_vae, torch.bfloat16,
                                         images)
    before = launch_counts(attention, sampler, torus)
    with plain_versions(attention, sampler):
        p_losses, p_grads = first_step(vit_vae, conv_vae, torch.float32,
                                       images)
    check(launch_counts(attention, sampler, torus) == before,
          "the plain step launched a kernel")
    loss_rel = {k: abs(losses[k] - p_losses[k]) / max(abs(p_losses[k]), 1e-12)
                for k in losses}
    norm = math.sqrt(sum(g.double().pow(2).sum().item()
                         for g in p_grads.values()))
    err = math.sqrt(sum((grads[n] - p_grads[n]).double().pow(2).sum().item()
                        for n in grads))
    worst_name, worst = max(
        ((n, (grads[n] - p_grads[n]).abs().max().item()) for n in grads),
        key=lambda t: t[1])
    bf16_rel = abs(bf16_losses["total_loss"] - losses["total_loss"]) / abs(
        losses["total_loss"])
    bf16_err = math.sqrt(sum(
        (bf16_grads[n] - grads[n]).double().pow(2).sum().item()
        for n in grads))
    emit("train_check", loss_rel=loss_rel, grad_norm=norm,
         grad_l2_rel=err / norm, grad_max_rel=worst / norm,
         grad_max_param=worst_name, bf16_loss_rel=bf16_rel,
         bf16_grad_l2_rel=bf16_err / norm, bars=TRAIN_BARS)
    check(max(loss_rel.values()) <= TRAIN_BARS["loss_rel"],
          f"float32 step, kernels vs plain: losses differ {loss_rel}")
    check(err / norm <= TRAIN_BARS["grad_l2_rel"],
          f"float32 step, kernels vs plain: gradient l2 error {err / norm}")
    check(worst / norm <= TRAIN_BARS["grad_max_rel"],
          f"float32 step, kernels vs plain: {worst_name} gradient error "
          f"{worst / norm} of the global norm")
    check(bf16_rel <= TRAIN_BARS["bf16_loss_rel"],
          f"bfloat16 first loss {bf16_losses['total_loss']} vs float32 "
          f"{losses['total_loss']}: {bf16_rel}")
    check(bf16_err / norm <= TRAIN_BARS["bf16_grad_l2_rel"],
          f"bfloat16 gradients vs float32: l2 error {bf16_err / norm} of "
          f"the gradient norm")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cliffordtpu_torch import serving
    from cliffordtpu_torch.kernels import attention, build, sampler, torus
    from cliffordtpu_torch.nn import conv_vae, rope, vit_vae
    from cliffordtpu_torch.train import loop, state

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
                                       False)):
        att_b[label] = attention_bwd_case(attention, rope, BATCH, S, 8, 64,
                                          dtype, use_rope, gen)
        emit("kernel", kernel="attention_bwd", **att_b[label])
    tor = {}
    for label, R, d, epilogue in (("flagship", BATCH * 64, 16, True),
                                  ("d513", 64, 513, False)):
        tor[label] = torus_bwd_case(torus, sampler, R, d, epilogue, gen)
        emit("kernel", kernel="torus_bwd", **tor[label])
    smp = {}
    for label, R, d, per_row in (("flagship", BATCH * 64, 16, True),
                                 ("d513", 64, 513, False)):
        smp[label] = sampler_case(sampler, R, d, per_row, gen)
        emit("kernel", kernel="sampler_keyed", **smp[label])

    images = torch.rand(BATCH, 32, 32, 1, generator=gen, device=DEVICE) * 2 - 1
    runs = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        srv, outs, lat, counts = serve(serving, vit_vae, attention, sampler,
                                       dtype, images)
        runs[label] = (srv, outs, counts)
        emit("serve", compute_dtype=label, batch=BATCH, requests=REQUESTS,
             launches=counts,
             median_ms={k: statistics.median(v[1:]) for k, v in lat.items()},
             first_ms={k: v[0] for k, v in lat.items()})

    srv, outs, _ = runs["float32"]
    with plain_versions(attention, sampler), torch.inference_mode():
        plain = {"encode_mu": srv.encode_mu(images),
                 "encode_z": srv.encode_z((0, REQUESTS - 1), images),
                 "decode": srv.decode(outs["encode_z"])}
    diffs = {k: (outs[k] - plain[k]).abs().max().item() for k in plain}
    bf16_vs_f32 = {}
    for k in outs:
        diff = runs["bfloat16"][1][k].float() - outs[k]
        if k == "encode_mu":  # angles: compare them modulo 2 pi
            diff = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
        bf16_vs_f32[k] = diff.abs().max().item()
    emit("serve_check", kernels_vs_plain_f32=diffs, bf16_vs_f32=bf16_vs_f32,
         bf16_bars=BF16_BARS)
    check(max(diffs.values()) <= 5e-4,
          f"float32 serving with kernels vs plain: {diffs} > 5e-4")
    for k, bar in BF16_BARS.items():
        check(bf16_vs_f32[k] <= bar,
              f"{k}: bfloat16 vs float32 compute {bf16_vs_f32[k]} > {bar}")

    mods = (vit_vae, state, loop, attention, sampler, torus)
    trained = {}
    for label, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        history, ms, counts = train(mods, dtype, images)
        trained[label] = (history, counts)
        emit("train", compute_dtype=label, batch=BATCH, steps=TRAIN_STEPS,
             optimizer="adamw", lr=1e-4, launches=counts,
             per_step_launches=PER_STEP,
             median_ms_per_step=statistics.median(ms[1:]),
             min_ms_per_step=min(ms[1:]), first_ms=ms[0],
             first_losses=history[0], last_losses=history[-1])
    train_check(mods, conv_vae, images)

    def launched(name, *labels):
        """Launches on the main paths: serving plus training."""
        return sum(runs[d][2].get(name, 0) + trained[d][1][name]
                   for d in labels)

    def entry(name, source, replaces, case, launches):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}}

    att_src = "cliffordtpu_torch/csrc/attention_fwd.cu"
    att_tpu = "cliffordtpu/kernels/attention_pallas.py:139"
    att_b_src = "cliffordtpu_torch/csrc/attention_bwd.cu"
    att_b_tpu = "cliffordtpu/kernels/attention_pallas.py:157"
    kernels = [
        entry("attention_fwd[float32]", att_src, att_tpu, att["f32"],
              launched("attention_fwd", "float32")),
        entry("attention_fwd[bfloat16]", att_src, att_tpu, att["bf16"],
              launched("attention_fwd", "bfloat16")),
        entry("attention_bwd[float32]", att_b_src, att_b_tpu, att_b["f32"],
              launched("attention_bwd", "float32")),
        entry("attention_bwd[bfloat16]", att_b_src, att_b_tpu, att_b["bf16"],
              launched("attention_bwd", "bfloat16")),
        entry("torus_bwd", "cliffordtpu_torch/csrc/torus_bwd.cu",
              "cliffordtpu/kernels/torus_pallas.py:154", tor["flagship"],
              launched("torus_bwd", "float32", "bfloat16")),
        entry("sampler_keyed", "cliffordtpu_torch/csrc/sampler_keyed.cu",
              "cliffordtpu/kernels/sampler_pallas.py:356", smp["flagship"],
              launched("sampler_keyed", "float32", "bfloat16")),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
