#!/usr/bin/env python3
"""Where the bf16 MLP forward's and recompute-from-x backward's time goes
on the card.

    python3 chip_mlp_probe.py [fwd] [bwd] [dz]

(fwd and bwd without arguments). Builds csrc/fused_mlp_residual.cu (fwd) and
csrc/fused_mlp_bwd.cu (bwd) (nvcc's time, ptxas's registers and spills;
"already built" when a library is there). For fused_mlp_residual at the
shapes of PERF.md §6's #2 and #3 rows, and fused_mlp_bwd at #5's: the
call's time as chip_smoke.py times it (CUDA events around one call,
median of 20: the wrapper's host time before its first launch
included), its launches' device times a call (torch.profiler over 10
calls: each kernel's mean launch times its launches a call, since the
profiler may keep fewer; the backward's LN, z/dh product, dln product,
LN backward and sums, with the two products' TFLOP/s), the wrapper's
host time a call (200 calls at 128 rows, which the card finishes
first), and, as yardsticks the port never calls, torch.matmul of the
forward's two products alone. For the backward also its host ms at each
shape (one call on an idle card, median of 20), its Python side's µs a
call at 128 rows (the C entry a no-op) and the call's time with
MLP_BWD_SCRATCH_BYTES at 24, 48, 96 and 192 MiB. Prints the
card's name and power limit first and one JSON object last. Needs one
CUDA device and nvcc; imports nothing of JAX.

With `dz`: the save-hidden backward's dz pass (mlp_dz, csrc/mlp_dz.cu) at
#6's rows (37,632 x 768 x 3072, 6400 x 384 x 1536): the call's time as
chip_smoke.py times it, its host ms (one call on an idle card, median of
20), its launches' device ms a call (the product with the gelu' epilogue,
the partial sums of db1) and the product's TFLOP/s, the two halves of its
library yardstick alone (torch.matmul of g w2^T, aten.gelu_backward), and
the wrapper's host µs a call at 128 rows.
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


# fused_mlp_bwd: (rows, C, hidden): the release lean step's, the R50ViT
# lean step's and the 4-scale lean step's
BWD_SHAPES = ((37632, 768, 3072), (6400, 384, 1536), (539392, 768, 3072))
BWD_SCRATCH_MIB = (24, 48, 96, 192)
# a part of a profiler kernel name -> the launch, first match
FWD_LAUNCHES = (("ln_kernel", "ln"), ("gemm_sm90<0>", "fc1"),
                ("gemm_sm90", "fc2"))
BWD_LAUNCHES = (("ln_stats_kernel", "ln"), ("dgelu_sm90", "z/dh"),
                ("gemm_sm90", "dln"), ("ln_bwd_rows_kernel", "ln_bwd"),
                ("sum_rows_kernel", "sums"))
# mlp_dz: (rows, C, hidden) of PERF.md §6's #6 rows, and its launches
DZ_SHAPES = ((37632, 768, 3072), (6400, 384, 1536))
DZ_LAUNCHES = (("sum_partials", "sums"), ("mlp_dz_kernel", "product"),
               ("gemm_sm90", "product"))


def build(_build, name):
    t = time.perf_counter()
    log = _build.build_all([name])[name]
    print(f"nvcc {name}: {time.perf_counter() - t:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print("  " + line.strip()[-150:], flush=True)


def split_by_launch(torch, prof, names, per_call):
    """{launch: device ms a call}: each kernel's mean launch (names: (part
    of a profiler key, launch)) times per_call[launch] launches a call."""
    total, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, name in names:
            if part in e.key:
                total[name] = total.get(name, 0.0) + e.device_time_total
                counts[name] = counts.get(name, 0) + e.count
                break
    return {k: v / counts[k] / 1e3 * per_call[k] for k, v in total.items()}


def probe_bwd(torch, fa, _build):
    """fused_mlp_bwd at BWD_SHAPES: call ms, the wrapper's host ms (median
    of 20 calls on an idle card), device ms by launch, the products'
    TFLOP/s, the scratch bound's sweep; its host µs a call at 128 rows,
    and those of its Python side alone (the C entry a no-op)."""
    results = []
    for i, (rows, c, hidden) in enumerate(BWD_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + i)

        def rnd(*shape, std=1.0, mean=0.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * std
                    + mean)

        x, g = rnd(rows, c).bfloat16(), rnd(rows, c).bfloat16()
        lns, lnb = rnd(c, std=0.1, mean=1.0), rnd(c, std=0.1)
        w1 = rnd(c, hidden, std=c ** -0.5).bfloat16()
        b1 = rnd(hidden, std=0.01)
        w2 = rnd(hidden, c, std=hidden ** -0.5).bfloat16()

        def call():
            return fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)

        ms = cs.median_ms(call, torch)
        enqueue = []           # the wrapper's host time, the card idle
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            enqueue.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        chunks = len(fa.mlp_bwd_row_chunks(rows, c))
        per_call = {name: chunks for _, name in BWD_LAUNCHES}
        per_call["sums"] = chunks + 1
        split = split_by_launch(torch, prof, BWD_LAUNCHES, per_call)
        flops = 2 * rows * c * hidden        # one product's
        tflops = {k: m * flops / split[k] / 1e9
                  for k, m in (("z/dh", 2), ("dln", 1)) if k in split}
        sweep, bound_was = {}, fa.MLP_BWD_SCRATCH_BYTES
        try:
            for mib in BWD_SCRATCH_MIB:
                fa.MLP_BWD_SCRATCH_BYTES = mib << 20
                sweep[mib] = dict(
                    chunks=len(fa.mlp_bwd_row_chunks(rows, c)),
                    ms=cs.median_ms(call, torch))
        finally:
            fa.MLP_BWD_SCRATCH_BYTES = bound_was
        res = dict(kernel="fused_mlp_bwd", rows=rows, C=c, hidden=hidden,
                   ms=ms, host_ms=sorted(enqueue)[10], launch_ms=split,
                   device_ms=sum(split.values()), chunks=chunks,
                   tflops=tflops, scratch_sweep_mib=sweep)
        results.append(res)
        print(json.dumps(res), flush=True)
        del x, g, w1, w2
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(cs.SEED)
    x = torch.randn(128, 768, generator=gen).to("cuda", torch.bfloat16)
    g = torch.randn(128, 768, generator=gen).to("cuda", torch.bfloat16)
    lns, lnb = torch.ones(768).cuda(), torch.zeros(768).cuda()
    w1 = (torch.randn(768, 3072, generator=gen) * 0.036).to(
        "cuda", torch.bfloat16)
    w2 = (torch.randn(3072, 768, generator=gen) * 0.018).to(
        "cuda", torch.bfloat16)
    b1 = torch.zeros(3072).cuda()
    for _ in range(10):
        fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    # the same calls with the C entry a no-op: the wrapper's Python side
    entry = _build.entry
    _build.entry = lambda *a, **kw: (lambda *args: 0)
    try:
        t = time.perf_counter()
        for _ in range(200):
            fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)
        python_us = (time.perf_counter() - t) / 200 * 1e6
    finally:
        _build.entry = entry
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "fused_mlp_bwd",
                      "host_us_per_call_at_128_rows": host_us,
                      "python_us_per_call_at_128_rows": python_us}),
          flush=True)
    return results


def probe_dz(torch, fa):
    """mlp_dz at DZ_SHAPES: call ms, host ms, device ms by launch, the
    product's TFLOP/s, its library yardstick's halves; its host µs a call
    at 128 rows."""
    results = []
    for i, (rows, c, hidden) in enumerate(DZ_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 50 + i)

        def rnd(*shape, std=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * std

        g, z = rnd(rows, c).bfloat16(), rnd(rows, hidden).bfloat16()
        w2 = rnd(hidden, c, std=hidden ** -0.5).bfloat16()

        def call():
            return fa.mlp_dz(g, z, w2)

        ms = cs.median_ms(call, torch)
        enqueue = []           # the wrapper's host time, the card idle
        for _ in range(20):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            enqueue.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        split = split_by_launch(torch, prof, DZ_LAUNCHES,
                                {"product": 1, "sums": 1})
        dh = g @ w2.t()
        res = dict(kernel="mlp_dz", rows=rows, C=c, hidden=hidden, ms=ms,
                   host_ms=sorted(enqueue)[10], launch_ms=split,
                   device_ms=sum(split.values()),
                   product_tflops=(2 * rows * c * hidden
                                   / split.get("product", float("nan"))
                                   / 1e9),
                   matmul_ms=cs.median_ms(lambda: g @ w2.t(), torch),
                   gelu_backward_ms=cs.median_ms(
                       lambda: torch.ops.aten.gelu_backward(dh, z), torch))
        results.append(res)
        print(json.dumps(res), flush=True)
        del g, z, w2, dh
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(cs.SEED)
    g = torch.randn(128, 768, generator=gen).to("cuda", torch.bfloat16)
    z = torch.randn(128, 3072, generator=gen).to("cuda", torch.bfloat16)
    w2 = (torch.randn(3072, 768, generator=gen) * 0.018).to(
        "cuda", torch.bfloat16)
    for _ in range(10):
        fa.mlp_dz(g, z, w2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        fa.mlp_dz(g, z, w2)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "mlp_dz",
                      "host_us_per_call_at_128_rows": host_us}), flush=True)
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from duoformer_tcga_tpu_torch.ops import _build
    from duoformer_tcga_tpu_torch.ops import fused_attention as fa

    parts = sys.argv[1:] or ["fwd", "bwd"]
    print(cs.card_line(), flush=True)
    bwd, dz = [], []
    if "dz" in parts:
        build(_build, "mlp_dz")
        dz = probe_dz(torch, fa)
    if "bwd" in parts:
        build(_build, "fused_mlp_bwd")
        bwd = probe_bwd(torch, fa, _build)
    if "fwd" not in parts:
        print(json.dumps({"bwd_shapes": len(bwd), "dz_shapes": len(dz)}))
        return 0
    build(_build, "fused_mlp_residual")
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
        split = split_by_launch(torch, prof, FWD_LAUNCHES,
                                {name: chunks for _, name in FWD_LAUNCHES})
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
                      "shapes": len(results), "bwd_shapes": len(bwd)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
