#!/usr/bin/env python3
"""Hold the attention kernels' key-tiled forms against their plain versions
over a grid of shapes, on one GPU.

    python3 scripts/torch_attention_forms.py

Kernels A and B (``cliffordtpu_torch/csrc/attention_fwd.cu``,
``attention_bwd.cu``) in their key-tiled forms, launched directly whatever
form the route would give the shape: for float32 at head_dim 8, 24, 64,
128 and 256 and bfloat16 at 16, 32, 64 and 128, each at S 17, 68, 130,
260 and 331 (ragged tiles, one tile, several), with and without RoPE and
on the packed q/k/v of a ``fused_proj`` projection, batch 2.  Each case
holds the forward's output and log-sum-exp against ``attention_lse_plain``
and the backward's gradients against ``attention_bwd_plain`` (float32
1e-5; bfloat16 2e-2 of the magnitude, as chip_smoke's bars), and the
backward against itself run again (the same bits: one block writes each
gradient row, no atomics).  Then ``fused_attention`` under autograd at
image 256's shape (B 4, S 260, 8 heads of 64) in both dtypes.  Prints one
JSON line a case, a summary line last; exits non-zero when a case fails.
The first line names the card and its power limit as ``nvidia-smi`` gives
them.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_DIMS = {torch.float32: (8, 24, 64, 128, 256),
             torch.bfloat16: (16, 32, 64, 128)}
SEQUENCES = ((17, 3), (68, 2), (130, 2), (260, 8), (331, 1))  # (S, H)


def err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bar(dtype, want) -> float:
    """Float32 1e-5; bfloat16 2e-2 of max(1, the magnitude)."""
    return (1e-5 if dtype == torch.float32 else 2e-2) * max(
        1.0, want.float().abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cliffordtpu_torch.kernels import attention, build
    from cliffordtpu_torch.ops import rope

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "build_s": build.build_all()}),
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def tables(S, hd):
        grid = math.ceil(math.sqrt(S - 4))
        c, s = rope.rope_2d_cos_sin(256, grid, hd, cls_token_num=4)
        return (torch.from_numpy(c)[:S].contiguous().to(dev),
                torch.from_numpy(s)[:S].contiguous().to(dev))

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    failed, n = 0, 0
    for dtype, hds in HEAD_DIMS.items():
        for hd in hds:
            for S, H in SEQUENCES:
                for use_rope, packed in ((True, False), (True, True),
                                         (False, False)):
                    n += 1
                    if packed:
                        q, k, v = randn(2, S, H, 3, hd, dtype=dtype).unbind(3)
                    else:
                        q, k, v = (randn(2, S, H, hd, dtype=dtype)
                                   for _ in range(3))
                    d_out = randn(2, S, H, hd, dtype=dtype)
                    cos, sin = tables(S, hd) if use_rope else (None, None)
                    out, lse = attention._launch_fwd_tiled(q, k, v, cos, sin)
                    grads = attention._launch_bwd_tiled(q, k, v, cos, sin,
                                                        out, lse, d_out)
                    again = attention._launch_bwd_tiled(q, k, v, cos, sin,
                                                        out, lse, d_out)
                    torch.cuda.synchronize()
                    want, want_lse = attention.attention_lse_plain(
                        q, k, v, cos, sin)
                    ref = attention.attention_bwd_plain(q, k, v, cos, sin,
                                                        d_out)
                    errs = {"out": err(out, want), "lse": err(lse, want_lse)}
                    ok = (errs["out"] <= bar(dtype, want)
                          and errs["lse"] <= bar(dtype, want_lse))
                    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
                        errs[name] = err(g, r)
                        ok = (ok and errs[name] <= bar(dtype, r)
                              and bool(torch.isfinite(g).all()))
                    same = all(torch.equal(a, b)
                               for a, b in zip(grads, again))
                    ok = ok and same and (not packed
                                          or grads[0]._base is not None)
                    failed += not ok
                    print(json.dumps({
                        "dtype": str(dtype).replace("torch.", ""), "hd": hd,
                        "S": S, "H": H, "rope": use_rope, "packed": packed,
                        "ok": ok, "same_bits": same, **errs}), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        n += 1
        q, k, v, d_out = (randn(4, 260, 8, 64, dtype=dtype)
                          for _ in range(4))
        cos, sin = tables(260, 64)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        tiled = (attention.tiled_launches, attention.tiled_bwd_launches)
        out = attention.fused_attention(qg, kg, vg, cos, sin)
        grads = torch.autograd.grad(out, (qg, kg, vg), d_out)
        moved = (attention.tiled_launches - tiled[0],
                 attention.tiled_bwd_launches - tiled[1])
        want = attention.attention_plain(q, k, v, cos, sin)
        ref = attention.attention_bwd_plain(q, k, v, cos, sin, d_out)
        errs = {"out": err(out, want), **{
            name: err(g, r) for name, g, r in zip(("dq", "dk", "dv"), grads,
                                                   ref)}}
        ok = moved == (1, 1) and errs["out"] <= bar(dtype, want) and all(
            errs[name] <= bar(dtype, r)
            for name, r in zip(("dq", "dk", "dv"), ref))
        failed += not ok
        print(json.dumps({"autograd": str(dtype).replace("torch.", ""),
                          "S": 260, "tiled_launches": moved, "ok": ok,
                          **errs}), flush=True)
    print(json.dumps({"cases": n, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
