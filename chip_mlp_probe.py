#!/usr/bin/env python3
"""Where the bf16 MLP forward's time goes on the card.

    python3 chip_mlp_probe.py

Builds csrc/fused_mlp_residual.cu alone (nvcc's time, ptxas's registers
and spills; "already built" when its library is there). For
fused_mlp_residual at the shapes of PERF.md §6's #2 and #3 rows: the
call's time as chip_smoke.py times it (CUDA events around one call,
median of 20: the wrapper's host time before its first launch
included), its launches' device times a call (torch.profiler over 10
calls: each kernel's mean launch times its launches a call, since the
profiler may keep fewer), the wrapper's host time a call (200 calls at
128 rows, which the card finishes first), and, as yardsticks the
port never calls, torch.matmul of the two products alone. Prints the
card's name and power limit first and one JSON object last. Needs one
CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs

# (rows, C, hidden, z form, reg flags)
SHAPES = ((18816, 768, 3072, False, None), (37632, 768, 3072, True, None),
          (3200, 384, 1536, False, None), (6400, 384, 1536, False, None),
          (6400, 384, 1536, True, None),
          (37632, 768, 3072, False, dict(drop=cs.DROP)),
          (37632, 768, 3072, True, dict(drop=cs.DROP)),
          (18816, 768, 3072, False, {}), (269696, 768, 3072, False, None))


def launch_name(key):
    """A profiler kernel name -> ln, fc1 or fc2."""
    if "ln_kernel" in key:
        return "ln"
    return "fc1" if "gemm_sm90<0>" in key else "fc2"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from duoformer_tcga_tpu_torch.ops import _build
    from duoformer_tcga_tpu_torch.ops import fused_attention as fa

    print(cs.card_line(), flush=True)
    t = time.perf_counter()
    log = _build.build_all(["fused_mlp_residual"])["fused_mlp_residual"]
    print(f"nvcc: {time.perf_counter() - t:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print("  " + line.strip()[-150:], flush=True)
    results = []
    for i, (rows, c, hidden, z_form, reg) in enumerate(SHAPES):
        gen = torch.Generator().manual_seed(cs.SEED + i)

        def rnd(*shape, std=1.0, mean=0.0):
            return torch.randn(*shape, generator=gen) * std + mean

        x = rnd(rows, c).to("cuda", torch.bfloat16)
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
        w1 = rnd(c, hidden, std=c ** -0.5).to("cuda", torch.bfloat16)
        b1 = rnd(hidden, std=0.01).cuda()
        w2 = rnd(hidden, c, std=hidden ** -0.5).to("cuda", torch.bfloat16)
        b2 = rnd(c, std=0.01).cuda()
        flags = cs.reg_flags(torch, gen, c, reg)

        def call():
            return fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2,
                                         return_hidden=z_form, **flags)

        ms = cs.median_ms(call, torch)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        # the profiler may keep fewer than the 10 calls' launches: a
        # kernel's time a call is its mean launch times its launches a call
        chunks = len(fa.mlp_row_chunks(rows, c, hidden))
        total, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                    "gemm_sm90" in e.key or "ln_kernel" in e.key):
                name = launch_name(e.key)
                total[name] = total.get(name, 0.0) + e.device_time_total
                counts[name] = counts.get(name, 0) + e.count
        split = {k: v / counts[k] / 1e3 * chunks for k, v in total.items()}
        h = x.new_empty(rows, hidden)
        res = dict(rows=rows, C=c, hidden=hidden, z_form=z_form,
                   reg=reg, ms=ms, launch_ms=split, chunks=chunks,
                   matmul_fc1_ms=cs.median_ms(lambda: x @ w1, torch),
                   matmul_fc2_ms=cs.median_ms(lambda: h @ w2, torch))
        results.append(res)
        print(json.dumps(res), flush=True)
        del x, w1, w2, h
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(cs.SEED)
    x = torch.randn(128, 768, generator=gen).to("cuda", torch.bfloat16)
    lns, lnb = torch.ones(768).cuda(), torch.zeros(768).cuda()
    w1 = (torch.randn(768, 3072, generator=gen) * 0.036).to(
        "cuda", torch.bfloat16)
    w2 = (torch.randn(3072, 768, generator=gen) * 0.018).to(
        "cuda", torch.bfloat16)
    b1, b2 = torch.zeros(3072).cuda(), torch.zeros(768).cuda()
    for _ in range(10):
        fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call_at_128_rows": host_us,
                      "shapes": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
