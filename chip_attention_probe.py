#!/usr/bin/env python3
"""Where the attention branch's time goes on the card, forward and
backward, and the LayerNorm kernel's host and device time.

    python3 chip_attention_probe.py

Builds csrc/attention_sm90.cu, csrc/attention_bwd_sm90.cu and
csrc/layernorm.cu (nvcc's time, ptxas's registers and spills; "already
built" when a library is there). For the core's
wrapper (attention_core_s86 / attention_core_long: per chunk of segments
a LayerNorm pass, the qkv product and the attention core), the proj
(attention_proj), the whole branch up to 64 tokens (fused_attention_residual:
the core's chain and the proj in one wrapper call, the core's units
packing 64 // S segments) and the block-diagonal op
(block_diag_attention_fwd) at the shapes of PERF.md §6's #1 and #10 rows
(S=6, 22, 50, 86, 197), and the backward up to 64 tokens
(fused_attention_residual_bwd: one chain a call, per chunk of segments
geff (reg), LN, the qkv and dattn products, the backward core, the dln
product, the LN backward, the dw form's weight products and the sums) at
#4's rows (S=6 and 22 over 6272 segments, bare S=50 over 128, S=50 at
C=384 over 128; dw=False and dw; at S=6 also every reg flag): the call's
time as
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
launch, which the card finishes first). Last, #11 (fused_layernorm) at
[128, 768] and [6400, 384]: the call's time as chip_smoke.py times it,
the wrapper's host time a call (200 calls back to back, host clock, no
synchronise in between) and its launch's device time (torch.profiler).
Prints the card's name and power limit first and one JSON object last.
Needs one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs

C, HEADS = 768, 12
# (call, n_seg, S, bare, attention dropout; the backward's reg form: both
# dropouts at that rate and gamma); C=384 (6 heads) where the call ends in
# "_c384"
SHAPES = (("bwd", 6272, 6, False, 0.0), ("bwd_dw", 6272, 6, False, 0.0),
          ("bwd", 6272, 6, False, cs.DROP), ("bwd_dw", 6272, 6, False, cs.DROP),
          ("bwd", 6272, 22, False, 0.0), ("bwd_dw", 6272, 22, False, 0.0),
          ("bwd", 128, 50, True, 0.0), ("bwd_dw", 128, 50, True, 0.0),
          ("bwd_c384", 128, 50, False, 0.0),
          ("bwd_dw_c384", 128, 50, False, 0.0),
          ("branch", 3136, 6, False, 0.0), ("branch", 6272, 6, False, cs.DROP),
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


# a profiler kernel name's part -> its launch, and how many a call makes
# (chunks: the call's chunks of segments)
LAUNCHES = (("ln_stats_kernel", "ln", lambda ch: ch),
            ("ln_kernel", "ln", lambda ch: ch),
            ("geff_kernel", "geff", lambda ch: ch),
            ("attention_bwd_core", "core", lambda ch: ch),
            ("attention_core", "core", lambda ch: ch),
            ("gemm_sm90<2, false, false>", "qkv", lambda ch: ch),
            ("gemm_sm90<2, false, true>", "dattn", lambda ch: ch),
            ("gemm_sm90<3, false, true>", "dln", lambda ch: ch),
            ("gemm_sm90<4, true, false>", "dw", lambda ch: ch),
            ("gemm_sm90<1, false, false>", "proj", lambda ch: 1),
            ("ln_bwd_rows_kernel", "ln_bwd", lambda ch: ch),
            ("sum_rows_kernel", "sums", lambda ch: 2 * ch + 1),
            ("layernorm_kernel", "layernorm", lambda ch: 1))


def launch_name(key):
    """A profiler kernel name -> (its launch, launches a call of chunks)."""
    for part, name, per_call in LAUNCHES:
        if part in key:
            return name, per_call
    return None, None


def inputs(torch, gen, n_seg, S, bare, C=C):
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
                qkv=(rnd(n_seg, S, 3 * C) * cs.QKV_STD).to("cuda", bf16),
                g=rnd(n_seg, S, C).to("cuda", bf16),
                gamma=rnd(C, std=0.1, mean=1.0).cuda())


def make_call(fa, kind, t, n_seg, S, bare, drop):
    heads = t["x"].shape[-1] // 64
    scale = 64 ** -0.5
    if kind.startswith("bwd"):
        kw = (dict(gamma=t["gamma"], seed=cs.DROP_SEED, attn_drop=drop,
                   proj_drop=drop) if drop else {})
        return lambda: fa.fused_attention_residual_bwd(
            t["x"], t["g"], t["lns"], t["lnb"], t["wqkv"], t["bqkv"],
            t["wproj"], heads, S, scale, use_ln=not bare,
            use_residual=not bare, dw="_dw" in kind, **kw)
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

    from duoformer_tcga_tpu_torch.ops import nn as tnn

    print(cs.card_line(), flush=True)
    t = time.perf_counter()
    logs = _build.build_all(["attention_sm90", "attention_bwd_sm90",
                             "layernorm"])
    print(f"nvcc: {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  {name}: " + line.strip()[-150:], flush=True)
    results = []
    for i, (kind, n_seg, S, bare, drop) in enumerate(SHAPES):
        t = inputs(torch, torch.Generator().manual_seed(cs.SEED + i), n_seg,
                   S, bare, 384 if kind.endswith("_c384") else C)
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
        # (a core or branch call: ln, qkv and core once a chunk; proj once;
        # a backward call: each launch once a chunk, the sums twice a
        # chunk and once more)
        width = t["x"].shape[-1]
        if kind.startswith("bwd"):
            reg = drop > 0.0
            chunks = len(fa.attention_bwd_seg_chunks(
                n_seg, S, width, "_dw" in kind, not bare, reg,
                reg and "_dw" in kind))
        elif kind in ("core", "branch"):
            chunks = len(fa.attention_seg_chunks(n_seg, S, width, not bare))
        else:
            chunks = 1
        total, counts, per = {}, {}, {}
        for e in prof.key_averages():
            name, per_call = launch_name(e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                total[name] = total.get(name, 0.0) + e.device_time_total
                counts[name] = counts.get(name, 0) + e.count
                per[name] = per_call(chunks)
        split = {k: v / counts[k] / 1e3 * per[k] for k, v in total.items()}
        res = dict(kind=kind, n_seg=n_seg, S=S, C=width, bare=bare,
                   attn_drop=drop, ms=ms, steady_ms=steady, launch_ms=split,
                   device_ms=sum(split.values()),
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
    layernorm = {}
    for rows, width in ((128, 768), (6400, 384)):
        gen = torch.Generator().manual_seed(cs.SEED)
        x = (torch.randn(rows, width, generator=gen) * 2.0 + 0.5).to(
            "cuda", torch.bfloat16)
        scale = (torch.randn(width, generator=gen) * 0.1 + 1.0).cuda()
        bias = (torch.randn(width, generator=gen) * 0.1).cuda()

        def call():
            return tnn.fused_layernorm(x, scale, bias)

        ms = cs.median_ms(call, torch)
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        dev = [e.device_time_total / e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "layernorm_kernel" in e.key]
        layernorm[f"[{rows}, {width}]"] = dict(
            ms=ms, host_us_a_call=host, device_us=dev[0] if dev else None)
        print(json.dumps({"fused_layernorm": layernorm}), flush=True)
    print(json.dumps({"host_us_a_call": host_us, "shapes": len(results),
                      "scratch_mib_default": saved >> 20,
                      "fused_layernorm": layernorm}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
