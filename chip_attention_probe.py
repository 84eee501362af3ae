#!/usr/bin/env python3
"""Where the attention branch's time goes on the card.

    python3 chip_attention_probe.py

Builds csrc/attention_sm90.cu alone (nvcc's time, ptxas's registers and
spills; "already built" when its library is there). For the core's
wrapper (attention_core_s86 / attention_core_long: per chunk of segments
a LayerNorm pass, the qkv product and the attention core), the proj
(attention_proj), the whole branch up to 64 tokens (fused_attention_residual:
the core's chain and the proj in one wrapper call, the core's units
packing 64 // S segments) and the block-diagonal op
(block_diag_attention_fwd) at the shapes of PERF.md §6's #1 and #10 rows
(S=6, 22, 50, 86, 197): the call's time as
chip_smoke.py times it (CUDA events around one call, median of 20: the
wrapper's host time included), its steady time (events around 10 calls
back to back, median of 5, over 10) and its launches' device times by
kernel a call (torch.profiler over 10 calls: each kernel's mean launch
times its launches a call, since the profiler may keep fewer). Then the
core's call at S=86 (3136 segments) and S=197 (128), and the branch at
S=22 (3136) and S=6 (6272), with ATTN_SCRATCH_BYTES from 16 to 256 MiB,
in two rounds of opposite order (the chunk that keeps qkv in L2 against
the launches and tails of more chunks), and the wrappers' host time a
call (200 calls of the core at 7 segments of 86 tokens, and of the bare
branch at 3 of 50 and its two internal calls, the chain and the proj's
launch, which the card finishes first). Prints the
card's name and power limit first and one JSON object last. Needs one
CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs

C, HEADS = 768, 12
# (call, n_seg, S, bare, attention dropout)
SHAPES = (("branch", 3136, 6, False, 0.0), ("branch", 6272, 6, False, cs.DROP),
          ("branch", 3136, 22, False, 0.0), ("branch", 64, 50, True, 0.0),
          ("branch", 128, 50, True, cs.DROP), ("op", 3136, 6, False, 0.0),
          ("op", 64, 50, False, 0.0),
          ("core", 3136, 86, False, 0.0), ("core", 3136, 86, True, 0.0),
          ("core", 3136, 86, False, cs.DROP), ("core", 128, 197, False, 0.0),
          ("core", 128, 197, True, 0.0), ("core", 64, 197, False, 0.0),
          ("proj", 3136, 86, False, 0.0), ("proj", 64, 197, False, 0.0),
          ("proj", 128, 197, False, 0.0), ("op", 3136, 86, False, 0.0),
          ("op", 128, 197, False, 0.0), ("op", 1024, 197, False, 0.0),
          ("op", 3136, 65, False, 0.0))
SCRATCH_MIB = (16, 32, 64, 128, 192, 256)
# (call, n_seg, S) of the scratch sweep
SWEEP = (("core", 3136, 86), ("core", 128, 197), ("branch", 3136, 22),
         ("branch", 6272, 6))


def launch_name(key):
    """A profiler kernel name -> ln, qkv, core or proj."""
    if "ln_kernel" in key:
        return "ln"
    if "attention_core" in key:
        return "core"
    return "qkv" if "gemm_sm90<2>" in key else "proj"


def inputs(torch, gen, n_seg, S, bare):
    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    bf16 = torch.bfloat16
    x = rnd(n_seg, S, C).to("cuda", bf16)
    if bare:
        lns, lnb = torch.zeros(C).cuda(), torch.zeros(C).cuda()
    else:
        lns, lnb = rnd(C, std=0.1, mean=1.0).cuda(), rnd(C, std=0.1).cuda()
    return dict(x=x, lns=lns, lnb=lnb,
                wqkv=rnd(C, 3 * C, std=cs.QKV_STD * C ** -0.5).to("cuda",
                                                                  bf16),
                bqkv=rnd(3 * C, std=0.01).cuda(),
                wproj=rnd(C, C, std=C ** -0.5).to("cuda", bf16),
                bproj=rnd(C, std=0.01).cuda(),
                qkv=(rnd(n_seg, S, 3 * C) * cs.QKV_STD).to("cuda", bf16))


def make_call(fa, kind, t, n_seg, S, bare, drop):
    scale = (C // HEADS) ** -0.5
    if kind == "op":
        return lambda: fa.block_diag_attention_fwd(t["qkv"], HEADS, S, scale)
    if kind == "proj":
        return lambda: fa.attention_proj(t["x"], t["x"], t["wproj"],
                                         t["bproj"], use_residual=not bare)
    if kind == "chain":      # the branch's first internal call, uncounted
        return lambda: fa._attention_core_chain(
            t["x"], t["lns"], t["lnb"], t["wqkv"], t["bqkv"], HEADS, scale,
            1e-6, not bare, 0, 0.0, "chain")
    if kind == "proj_launch":   # its second, on x as o, uncounted
        return lambda: fa._attention_proj_launch(
            t["x"], t["x"], t["wproj"], t["bproj"], not bare, None, 0, 0.0)
    if kind == "branch":
        kw = dict(seed=cs.DROP_SEED, attn_drop=drop) if drop else {}
        return lambda: fa.fused_attention_residual(
            t["x"], t["lns"], t["lnb"], t["wqkv"], t["bqkv"], t["wproj"],
            t["bproj"], HEADS, S, scale, use_ln=not bare,
            use_residual=not bare, **kw)
    core = (fa.attention_core_s86 if S <= fa.ATTN_SERVE_MAX_SEG_LEN
            else fa.attention_core_long)
    kw = dict(seed=cs.DROP_SEED, attn_drop=drop) if drop else {}
    return lambda: core(t["x"], t["lns"], t["lnb"], t["wqkv"], t["bqkv"],
                        HEADS, S, scale, use_ln=not bare, **kw)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from duoformer_tcga_tpu_torch.ops import _build
    from duoformer_tcga_tpu_torch.ops import fused_attention as fa

    print(cs.card_line(), flush=True)
    t = time.perf_counter()
    log = _build.build_all(["attention_sm90"])["attention_sm90"]
    print(f"nvcc: {time.perf_counter() - t:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print("  " + line.strip()[-150:], flush=True)
    results = []
    for i, (kind, n_seg, S, bare, drop) in enumerate(SHAPES):
        t = inputs(torch, torch.Generator().manual_seed(cs.SEED + i), n_seg,
                   S, bare)
        call = make_call(fa, kind, t, n_seg, S, bare, drop)
        ms = cs.median_ms(call, torch)
        steady = cs.median_ms(lambda: [call() for _ in range(10)], torch,
                              5) / 10
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        # the profiler may keep fewer than the 10 calls' launches: a
        # kernel's time a call is its mean launch times its launches a call
        # (a core or branch call: ln, qkv and core once a chunk; proj once)
        chunks = (len(fa.attention_seg_chunks(n_seg, S, C, not bare))
                  if kind in ("core", "branch") else 1)
        total, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and any(
                    k in e.key for k in ("ln_kernel", "gemm_sm90",
                                         "attention_core")):
                name = launch_name(e.key)
                total[name] = total.get(name, 0.0) + e.device_time_total
                counts[name] = counts.get(name, 0) + e.count
        split = {k: v / counts[k] / 1e3 * (1 if k == "proj" else chunks)
                 for k, v in total.items()}
        res = dict(kind=kind, n_seg=n_seg, S=S, bare=bare, attn_drop=drop,
                   ms=ms, steady_ms=steady, launch_ms=split,
                   launches_profiled=counts, chunks=chunks)
        results.append(res)
        print(json.dumps(res), flush=True)
        del t
        torch.cuda.empty_cache()

    sweep = {}
    saved = fa.ATTN_SCRATCH_BYTES
    for i, (kind, n_seg, S) in enumerate(SWEEP):
        t = inputs(torch, torch.Generator().manual_seed(cs.SEED + 100 + i),
                   n_seg, S, False)
        call = make_call(fa, kind, t, n_seg, S, False, 0.0)
        times = {m: [] for m in SCRATCH_MIB}
        try:
            for order in (SCRATCH_MIB, SCRATCH_MIB[::-1]):
                for mib in order:
                    fa.ATTN_SCRATCH_BYTES = mib << 20
                    times[mib].append(cs.median_ms(call, torch))
        finally:
            fa.ATTN_SCRATCH_BYTES = saved
        key = f"{kind} S={S} n_seg={n_seg}"
        sweep[key] = {}
        for mib, v in times.items():
            fa.ATTN_SCRATCH_BYTES = mib << 20
            sweep[key][f"{mib} MiB"] = dict(
                ms=v, chunks=len(fa.attention_seg_chunks(n_seg, S, C)))
        fa.ATTN_SCRATCH_BYTES = saved
        print(json.dumps({key: sweep[key]}), flush=True)
        del t
        torch.cuda.empty_cache()

    host_us = {}
    for kind, n_seg, S, bare in (("core", 7, 86, False),
                                 ("branch", 3, 50, True),
                                 ("chain", 3, 50, True),
                                 ("proj_launch", 3, 50, True)):
        t = inputs(torch, torch.Generator().manual_seed(cs.SEED), n_seg, S,
                   bare)
        call = make_call(fa, kind, t, n_seg, S, bare, 0.0)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us[f"{kind} S={S} n_seg={n_seg}"] = (
            (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({"host_us_a_call": host_us, "shapes": len(results),
                      "scratch_mib_default": saved >> 20}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
