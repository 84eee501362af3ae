#!/usr/bin/env python3
"""Drive the PyTorch port (duoformer_tcga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds both CUDA kernels from the checkout's sources (one nvcc each,
   started together) and prints each kernel's register and spill report.
2. Holds every kernel against its plain PyTorch version on the card, at
   the serving path's shapes (C=768, 12 heads, B=64), at the bare form's
   shape for B=256, and at one small odd shape each: kernel in bf16, plain
   version on the same inputs upcast to float32. A case passes when both
   hold: atol = rtol = 0.08 elementwise (the repo's bf16 kernel bar,
   tests/test_tpu_hw.py:110), and the relative L2 error of the branch (the
   output less the residual x, where the form adds one) is at most 1e-2,
   twice what bf16 rounding at the kernels' rounding points gives. The
   weights are drawn so that the attention scores spread about 2 units and
   the branch is as large as x, so a wrong score, softmax, mask or head
   moves the branch by far more than that. Times kernel, plain version and
   one PyTorch library composition of the same function (a yardstick the
   port never calls) with CUDA events, median of 20 launches each.
3. Serves the release DuoFormer at full width (768/12/12, depth 12, 2
   scales, bf16, random weights from a fixed seed) through
   build_model_no_extra_params -> Predictor: 3 batches of 64 uint8 tiles.
   Launch counts are zeroed just before and read just after; each kernel
   form must have run exactly 12 times per forward. Checks logits shape
   and finiteness, and embed() on 2 tiles against the same weights run by
   the port on the CPU in float32 (relative L2 error <= 0.05: bf16 weights
   and activations through 53 convolutions and 24 transformer blocks, each
   rounding at 2^-9 relative). Then times the forward at B=64: the
   median, least and greatest of 7 host-clock windows of 5 forwards.

Prints the card's name and power limit, one JSON line {"kernels": [...]},
and as its last line {"ok": true, "device": {...}}. Exits non-zero, with
no result line, when there is no CUDA device, when the port is not beside
this script, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 0.08                 # bf16 kernel bar, tests/test_tpu_hw.py:110
BRANCH_REL_TOL = 1e-2      # relative L2 error of the branch (see above)
QKV_STD = 1.5              # wqkv std in units of C**-0.5: scores std ~2.3
EMBED_REL_TOL = 0.05
SEED = 0
B = 64
C, HEADS, HIDDEN = 768, 12, 3072
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
REPEATS = 20


def log(*a):
    print(*a, flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def median_ms(fn, torch, repeats=REPEATS):
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(torch, out, ref, residual):
    """out (kernel, bf16) against ref (plain, float32): max |out - ref|, the
    relative L2 error of the branch ref - residual, and both bars."""
    torch.cuda.synchronize()
    out = out.float()
    branch = ref if residual is None else ref - residual.float()
    rel = ((out - ref).norm() / branch.norm().clamp_min(1e-30)).item()
    close = bool(torch.allclose(out, ref, atol=TOL, rtol=TOL))
    return dict(max_abs_err=(out - ref).abs().max().item(), rel_err=rel,
                branch_rms=branch.pow(2).mean().sqrt().item(), close=close,
                ok=close and rel <= BRANCH_REL_TOL)


def attention_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed):
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, bf16)
    if bare:
        lns = torch.zeros(c, device=dev)
        lnb = torch.zeros(c, device=dev)
    else:
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5).to(dev, bf16)
    bqkv = rnd(3 * c, std=0.01).cuda()
    wproj = rnd(c, c, std=c ** -0.5).to(dev, bf16)
    bproj = rnd(c, std=0.01).cuda()
    scale = (c // heads) ** -0.5
    flags = dict(use_ln=not bare, use_residual=not bare)

    def kernel():
        return fa.fused_attention_residual(x, lns, lnb, wqkv, bqkv, wproj,
                                           bproj, heads, S, scale, **flags)

    f32 = [t.float() for t in (x, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_plain(
            f32[0], lns, lnb, f32[1], bqkv, f32[2], bproj, heads, S, scale,
            **flags)

    res = compare(torch, kernel(), plain(), None if bare else x)
    if not timed:
        return res
    wqkv_t, wproj_t = wqkv.t().contiguous(), wproj.t().contiguous()
    bqkv_b, bproj_b = bqkv.to(bf16), bproj.to(bf16)
    lns_b, lnb_b = lns.to(bf16), lnb.to(bf16)
    D = c // heads

    def library():
        h = x if bare else F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)
        qkv = F.linear(h, wqkv_t, bqkv_b).view(n_seg, S, 3, heads, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        y = F.linear(o.transpose(1, 2).reshape(n_seg, S, c), wproj_t,
                     bproj_b)
        return y if bare else y + x

    rows = n_seg * S
    flops = 2 * rows * c * 4 * c + 4 * n_seg * S * S * c
    nbytes = 2 * (2 * rows * c + 4 * c * c) + 4 * (2 * c + 4 * c)
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_case(torch, F, fa, gen, rows, c, hidden, timed):
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(rows, c).to(dev, bf16)
    lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    w1 = rnd(c, hidden, std=c ** -0.5).to(dev, bf16)
    b1 = rnd(hidden, std=0.01).cuda()
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, bf16)
    b2 = rnd(c, std=0.01).cuda()

    def kernel():
        return fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2)

    f32 = [t.float() for t in (x, w1, w2)]

    def plain():
        return fa.fused_mlp_residual_plain(f32[0], lns, lnb, f32[1], b1,
                                           f32[2], b2)

    res = compare(torch, kernel(), plain(), x)
    if not timed:
        return res
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
    b1_b, b2_b, lns_b, lnb_b = (t.to(bf16) for t in (b1, b2, lns, lnb))

    def library():
        h = F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)
        h = F.gelu(F.linear(h, w1_t, b1_b))
        return F.linear(h, w2_t, b2_b) + x

    flops = 4 * rows * c * hidden
    nbytes = 2 * (2 * rows * c + 2 * c * hidden) + 4 * (3 * c + hidden)
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def kernel_checks(torch, F, fa, timed):
    """-> (the serving path's cases by kernel name, the other cases by
    description); `timed` adds the times and bounds."""
    gen = torch.Generator().manual_seed(SEED)
    cases = {
        "fused_attention_residual": attention_case(
            torch, F, fa, gen, B * 49, 6, C, HEADS, False, timed),
        "fused_attention_residual_bare": attention_case(
            torch, F, fa, gen, B, 50, C, HEADS, True, timed),
        "fused_mlp_residual": mlp_case(torch, F, fa, gen, B * 49 * 6, C,
                                       HIDDEN, timed),
    }
    others = {
        "fused_attention_residual_bare n_seg=256 S=50 (B=256)":
            attention_case(torch, F, fa, gen, 256, 50, C, HEADS, True, timed),
        "fused_attention_residual n_seg=13 S=6 C=256 H=4": attention_case(
            torch, F, fa, gen, 13, 6, 256, 4, False, False),
        "fused_attention_residual_bare n_seg=3 S=50 C=256 H=4":
            attention_case(torch, F, fa, gen, 3, 50, 256, 4, True, False),
        "fused_mlp_residual rows=222 C=256 hidden=1024": mlp_case(
            torch, F, fa, gen, 222, 256, 1024, False),
    }
    return cases, others


def rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import duoformer_tcga_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported {port.__file__}, not the port beside "
              f"this script", file=sys.stderr)
        return 3
    from duoformer_tcga_tpu_torch.inference import Predictor
    from duoformer_tcga_tpu_torch.ops import _build
    from duoformer_tcga_tpu_torch.ops import fused_attention as fa

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # float32 on the card: full precision for the plain versions and the
    # CPU-vs-card reference (hopper-kernels guide §6)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # ---- 1. build ----
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} kernels")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----
    cases, others = kernel_checks(torch, F, fa, timed=True)
    for name, res in list(cases.items()) + list(others.items()):
        log(f"check {name}: max_abs_err {res['max_abs_err']:.6g} "
            f"(atol=rtol={TOL}), branch rel L2 err {res['rel_err']:.4g} "
            f"(<= {BRANCH_REL_TOL}; branch rms {res['branch_rms']:.3g}) "
            f"{'ok' if res['ok'] else 'FAIL'}"
            + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
               f"ms, library {res['library_ms']:.4f} ms, bound "
               f"{res['bound_ms']:.4f} ms ({res['bound_by']})"
               if "ms" in res else ""))
        if not res["ok"]:
            failures.append(f"kernel check {name}")

    # ---- 3. the serving path ----
    t0 = time.perf_counter()
    model = port.build_model_no_extra_params(
        num_layers=2, embed_dim=C, proj_dim=C, num_heads=HEADS, depth=12,
        device="cuda", seed=SEED)
    pred = Predictor(model, dtype=torch.bfloat16)
    log(f"model: built and prepared in {time.perf_counter() - t0:.1f} s, "
        f"{port.count_parameters(model)[1]:.2f} M tensors' elements")
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    fa.reset_launch_counts()
    outs = [pred(t) for t in batches]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    log(f"serving: 3 batches of {B}; launches {launches}")
    for name in cases:
        if launches.get(name, 0) != 12 * len(batches):
            failures.append(f"{name}: {launches.get(name, 0)} launches, "
                            f"expected {12 * len(batches)}")
    for i, lg in enumerate(outs):
        if tuple(lg.shape) != (B, 2) or not bool(torch.isfinite(lg).all()):
            failures.append(f"batch {i}: logits {tuple(lg.shape)}, finite="
                            f"{bool(torch.isfinite(lg).all())}")

    two = batches[0][:2]
    g_logits, g_cls = pred.embed(two)
    ref_pred = Predictor(port.build_model_no_extra_params(
        num_layers=2, embed_dim=C, proj_dim=C, num_heads=HEADS, depth=12,
        device="cpu", seed=SEED), device="cpu", dtype=torch.float32)
    c_logits, c_cls = ref_pred.embed(two)
    e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
    log(f"embed vs CPU float32: rel L2 err cls {e_cls:.3e}, logits "
        f"{e_logits:.3e} (tolerance {EMBED_REL_TOL}); |cls| "
        f"{c_cls.norm().item():.3e}")
    if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
        failures.append(f"embed vs CPU: {e_cls:.3e} / {e_logits:.3e}")

    # one forward, stage by stage (CUDA events, median of 5)
    m = pred.model
    with torch.inference_mode():
        x = pred.prepare(batches[0])
        feats = m.features(x)
        toks = m.tokens(feats)
        sc = m.transformer.scale_stack(toks)
        cls = m.transformer.cls_embedding(sc)
        stages = {
            "preprocess": lambda: pred.prepare(batches[0]),
            "backbone": lambda: m.features(x),
            "projection+regroup": lambda: m.tokens(feats),
            "scale stack (24 kernels)": lambda: m.transformer.scale_stack(toks),
            "patch stack (12 kernels)":
                lambda: m.transformer.cls_embedding(sc),
            "head": lambda: m.transformer.head(cls),
        }
        breakdown = {k: median_ms(f, torch, 5) for k, f in stages.items()}
    log("stages at B=%d: %s" % (B, ", ".join(
        f"{k} {v:.3f} ms" for k, v in breakdown.items())))

    n, windows = 5, []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            pred(batches[0])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n)
    dt = float(np.median(windows))
    kernel_ms = sum(12 * cases[k]["ms"] for k in cases)
    log(f"throughput: {B / dt:.1f} tiles/s at B={B}, median of 7 windows "
        f"of {n} forwards (least {B / max(windows):.1f}, greatest "
        f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms, of which the "
        f"36 kernel launches ~{kernel_ms:.2f} ms by their timings above) on "
        f"{card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    replaces = {
        "fused_attention_residual":
            "duoformer_tcga_tpu/ops/pallas_attention.py:311",
        "fused_attention_residual_bare":
            "duoformer_tcga_tpu/ops/pallas_attention.py:311",
        "fused_mlp_residual":
            "duoformer_tcga_tpu/ops/pallas_attention.py:1306",
    }
    sources = {
        "fused_attention_residual":
            "duoformer_tcga_tpu_torch/csrc/fused_attention_residual.cu",
        "fused_attention_residual_bare":
            "duoformer_tcga_tpu_torch/csrc/fused_attention_residual.cu",
        "fused_mlp_residual":
            "duoformer_tcga_tpu_torch/csrc/fused_mlp_residual.cu",
    }
    kernels = [dict(name=name, route="cuda", source=sources[name],
                    replaces=replaces[name], launches=launches.get(name, 0),
                    max_abs_err=res["max_abs_err"], ms=res["ms"],
                    plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                    bound_by=res["bound_by"], library_ms=res["library_ms"])
               for name, res in cases.items()]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
