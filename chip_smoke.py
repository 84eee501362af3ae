#!/usr/bin/env python3
"""Drive the PyTorch port (duoformer_tcga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the ten CUDA kernel sources from the checkout (one nvcc each,
   started together) and prints each kernel's register and spill report.
2. Holds every kernel form against its plain PyTorch version on the card:
   the serving forms at the serving path's shapes (C=768, 12 heads, B=64),
   the training forms (the MLP's z form, the attention backward in both
   forms, the MLP's dz pass) at the training step's (B=128), the int8
   forms (attention full and bare, MLP) at the serving shapes, the reg
   forms (dropout 0.1 from one seed, gamma 0.5 + U(0, 1)) at the legacy
   training step's shapes and with gamma alone at the serving shapes,
   drop_ew in its three modes, the bare forms also at B=256, the
   memory-lean step's forms at its shapes (B=128: the recompute-from-x MLP
   backward, the attention backward's dw form inert, bare and reg, the
   LayerNorm on the CLS, also at [18816, 768]), the block-diagonal
   attention op at S=6 (3136 segments) and S=50 (64), and each at one
   small odd shape: kernel in bf16,
   plain version on the same inputs upcast to float32 (the int8 forms'
   plain versions take the same bf16 x and int8 weights, so both round at
   the same points, with the int8 products exact). Every output of a case
   must hold both bars: atol = rtol = 0.08 elementwise (the repo's bf16
   kernel bar, tests/test_tpu_hw.py:110), and a relative L2 error of at
   most 1e-2 (of the branch, the output less the residual, where the form
   adds one), twice what bf16 rounding at the kernels' rounding points
   gives. A column sum over n rows (dlns, dlnb, dbqkv, dbproj, db1) sums
   n terms that each carry their own bf16 rounding, so its elementwise
   atol is 0.08 * sqrt(n), the size of n independent errors of 0.08 (its
   relative L2 bar stays 1e-2). The weights are drawn so that the
   attention scores spread about 2 units and the branch is as large as x,
   so a wrong score, softmax, mask or head moves the branch by far more
   than that. Times kernel, plain version and one PyTorch library
   composition of the same function (a yardstick the port never calls;
   for the int8 forms F.layer_norm, a torch row quantization,
   torch._int_mm, SDPA or F.gelu, torch._int_mm and the dequantization)
   with CUDA events, median of 20 launches each (the reg forms' yardstick
   adds F.dropout and SDPA's dropout_p; drop_ew's is F.dropout with
   F.gelu or aten.gelu_backward). The bound of an int8 form counts its
   int8 operations at the int8 peak (1979 TOP/s) and its bf16 attention
   core at the bf16 peak; the bounds count tensor-core products and bytes
   (the dropout hash's integer operations are not counted: drop_ew is
   bound by its bytes). drop_ew is also held to a bf16 mismatch fraction
   of at most 1e-3 against its plain version (one float32 formula on both
   sides), and gm on a tensor of ones to none at all: the kernel's masks
   are the plain version's bit for bit. The dw form's dwqkv and dwA are
   also held within 1e-2 relative L2 of the dw=False kernel's row-space
   outputs multiplied by torch.matmul, and, summed with atomics in an
   order that varies, a second launch's within the bars of the first
   (every other output bit for bit). Yardsticks of the new forms:
   autograd through F.layer_norm, F.linear, F.gelu, F.linear (the MLP
   backward); the dw=False kernel plus its two torch.matmul products (the
   dw form); F.layer_norm; SDPA with the segments as the batch.
3. Serves the release DuoFormer at full width (768/12/12, depth 12, 2
   scales, bf16, random weights from a fixed seed) through
   build_model_no_extra_params -> Predictor: 3 batches of 64 uint8 tiles.
   Launch counts are zeroed just before and read just after; each serving
   form must have run exactly 12 times per forward. Checks logits shape
   and finiteness, and embed() on 2 tiles against the same weights run by
   the port on the CPU in float32 (relative L2 error <= 0.05: bf16 weights
   and activations through 53 convolutions and 24 transformer blocks, each
   rounding at 2^-9 relative). Then times the forward at B=64: the
   median, least and greatest of 7 host-clock windows of 5 forwards.
4. Trains the same model (float32 masters, bf16 compute, frozen backbone,
   Adam with L2 decay 1e-4, OneCycle at 1e-4 over 1000 steps) through
   train.make_train_step on 3 batches of 128 uint8 tiles with labels in
   {0, 1}. One step, counts zeroed just before: each of the six training
   forms must have run exactly 12 times and the serving MLP form never.
   Over 3 steps the loss is finite, every trainable tensor the loss
   reaches changed and every backbone tensor is bit-identical. The
   gradients of one backward on 2 tiles, on the card in bf16 and by the
   port on the CPU in float32 from the same weights, must agree to a
   relative L2 error of 0.05 (the embed() bar) for every tensor of scale
   blocks 0 and 11, qkv and proj of patch blocks 0 and 11, the head, the
   tokens, the position embeddings and the projection convs. Then times
   the step at B=128 (median, least and greatest of 7 host-clock windows
   of 3 steps), its forward / backward / optimizer split (CUDA events),
   its peak memory, and one step's device time by kernel
   (torch.profiler). No int8 form runs in the step.
5. Runs right after 3, before 4, beside 3's bf16 Predictor: serves the
   same model in int8 through Predictor(quantize=True), 3 batches of 64,
   counts zeroed just before; each int8 form must have run exactly 12
   times per forward and no bf16 serving form. Checks finite logits, the
   drift from the bf16 Predictor's logits on the same batch at the JAX
   package's bound max|diff| < 0.05 * (max|bf16| + 1)
   (tests/test_int8.py:58), printing the CLS's drift beside it, and
   embed() on 2 tiles against the port's CPU float32 int8 path of the
   same weights (relative L2 <= 0.05; both sides quantize, and bf16
   rounding on the card flips codes that compound through the 12
   PatchBlocks, which have no residual: the CLS reads about as far from
   the CPU int8 path as int8 is from float32). Prints the stage times of
   both stacks and the tiles/s of both Predictors at B=64, their windows
   interleaved.
6. Runs last: the legacy DuoFormer (build_model: channel token,
   LayerScale 1e-5, attention dropout 0.1, dropout 0.1, random weights
   from a fixed seed) served through Predictor at B=64 (3 forwards,
   counted: exactly 12 reg full, 12 reg MLP and 2 reg bare launches per
   forward and no other; finite logits; embed() on 2 tiles against the
   port's CPU float32 run, relative L2 <= 0.05; tiles/s in 7 windows) and
   trained at B=128 (one counted step: exactly 12 + 12 (z) + 2 forward,
   12 + 2 backward and 36 drop_ew launches; the gradients of one
   backward on 2 tiles with the same seeds on the card in bf16 and on the
   CPU in float32 within 0.05 relative L2; over 3 steps a finite loss,
   every trainable tensor moved, backbone and BN statistics unchanged;
   tiles/s, split, peak memory and profile as in 4).
7. Runs after 6: the memory-lean training step (make_train_step(
   mlp_save_hidden=False, attn_bwd_dw=True) on a model built with
   fused_ln=True) at full width and B=128, for the release DuoFormer with
   apply_fc_norm=True and for the legacy DuoFormer. Each: the gradients of
   one backward on 2 tiles against the port's CPU float32 run on the same
   routes (release 0.05; legacy 0.05 from the same tokens and 0.1 end to
   end, as phase 6) and against the default routes on the card (same
   state, batch and seeds; 0.05); one counted step with exactly the
   launches of LEAN_RELEASE_TRAIN / LEAN_LEGACY_TRAIN and no other form;
   over 3 steps a finite loss, every trainable tensor moved, the backbone
   bit-identical; tiles/s, split, peak memory and profile as in 4. Then
   the block_diag_attention op forward and backward at S=6 and S=50,
   counted (2 launches). Every kernel form must have launched on some
   path.
Prints the card's name and power limit, one JSON line {"kernels": [...]},
and as its last line {"ok": true, "device": {...}}. Exits non-zero, with
no result line, when there is no CUDA device, when the port is not beside
this script, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import functools
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
B = 64                     # serving batch
B_TRAIN = 128              # training batch (config.py:94)
C, HEADS, HIDDEN = 768, 12, 3072
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
REPEATS = 20
GRAD_REL_TOL = 0.05        # card (bf16) vs CPU (float32) gradients
LEGACY_E2E_GRAD_TOL = 0.1  # the same, legacy, end to end (see phase 6)
DROP = 0.1                 # the legacy family's dropout rates
DROP_SEED = 12345          # the kernel cases' dropout seed
# drop_ew computes one float32 formula on both sides; only erff, expf and
# fma contraction move a bf16 rounding, in about 1e-5 of the elements
DROP_EW_MISMATCH_TOL = 1e-3
CSRC = "duoformer_tcga_tpu_torch/csrc/"
PALLAS = "duoformer_tcga_tpu/ops/pallas_attention.py:"
# kernel form -> its CUDA source; REPLACES: -> the TPU kernel it replaces
SOURCES = {
    "fused_attention_residual": CSRC + "fused_attention_residual.cu",
    "fused_attention_residual_bare": CSRC + "fused_attention_residual.cu",
    "fused_mlp_residual": CSRC + "fused_mlp_residual.cu",
    "fused_mlp_residual_z": CSRC + "fused_mlp_residual.cu",
    "fused_attention_residual_bwd": CSRC + "fused_attention_residual_bwd.cu",
    "fused_attention_residual_bwd_bare":
        CSRC + "fused_attention_residual_bwd.cu",
    "mlp_dz": CSRC + "mlp_dz.cu",
    "fused_attention_residual_int8": CSRC + "fused_attention_residual_int8.cu",
    "fused_attention_residual_int8_bare":
        CSRC + "fused_attention_residual_int8.cu",
    "fused_mlp_residual_int8": CSRC + "fused_mlp_residual_int8.cu",
    "fused_attention_residual_reg": CSRC + "fused_attention_residual.cu",
    "fused_attention_residual_reg_bare": CSRC + "fused_attention_residual.cu",
    "fused_mlp_residual_reg": CSRC + "fused_mlp_residual.cu",
    "fused_mlp_residual_reg_z": CSRC + "fused_mlp_residual.cu",
    "fused_attention_residual_bwd_reg":
        CSRC + "fused_attention_residual_bwd.cu",
    "fused_attention_residual_bwd_reg_bare":
        CSRC + "fused_attention_residual_bwd.cu",
    "drop_ew_hd": CSRC + "drop_ew.cu",
    "drop_ew_dz": CSRC + "drop_ew.cu",
    "drop_ew_gm": CSRC + "drop_ew.cu",
    "fused_mlp_bwd": CSRC + "fused_mlp_bwd.cu",
    "fused_attention_residual_bwd_dw":
        CSRC + "fused_attention_residual_bwd.cu",
    "fused_attention_residual_bwd_dw_bare":
        CSRC + "fused_attention_residual_bwd.cu",
    "fused_attention_residual_bwd_reg_dw":
        CSRC + "fused_attention_residual_bwd.cu",
    "fused_attention_residual_bwd_reg_dw_bare":
        CSRC + "fused_attention_residual_bwd.cu",
    "fused_layernorm": CSRC + "layernorm.cu",
    "block_diag_attention": CSRC + "block_diag_attention.cu",
}
REPLACES = {
    "fused_attention_residual": PALLAS + "311",
    "fused_attention_residual_bare": PALLAS + "311",
    "fused_mlp_residual": PALLAS + "1306",
    "fused_mlp_residual_z": PALLAS + "1350",
    "fused_attention_residual_bwd": PALLAS + "723",
    "fused_attention_residual_bwd_bare": PALLAS + "723",
    "mlp_dz": PALLAS + "1727",
    "fused_attention_residual_int8": PALLAS + "442",
    "fused_attention_residual_int8_bare": PALLAS + "442",
    "fused_mlp_residual_int8": PALLAS + "1499",
    "fused_attention_residual_reg": PALLAS + "311",
    "fused_attention_residual_reg_bare": PALLAS + "311",
    "fused_mlp_residual_reg": PALLAS + "1306",
    "fused_mlp_residual_reg_z": PALLAS + "1350",
    "fused_attention_residual_bwd_reg": PALLAS + "723",
    "fused_attention_residual_bwd_reg_bare": PALLAS + "723",
    "drop_ew_hd": PALLAS + "1949",
    "drop_ew_dz": PALLAS + "1949",
    "drop_ew_gm": PALLAS + "1949",
    "fused_mlp_bwd": PALLAS + "1597",
    "fused_attention_residual_bwd_dw": PALLAS + "723",
    "fused_attention_residual_bwd_dw_bare": PALLAS + "723",
    "fused_attention_residual_bwd_reg_dw": PALLAS + "723",
    "fused_attention_residual_bwd_reg_dw_bare": PALLAS + "723",
    "fused_layernorm": "duoformer_tcga_tpu/ops/pallas_norm.py:47",
    "block_diag_attention": PALLAS + "175",
}
SERVING_FORMS = ("fused_attention_residual", "fused_attention_residual_bare",
                 "fused_mlp_residual")
# each runs 12 times in one training step; the serving MLP form none
TRAINING_FORMS = ("fused_attention_residual", "fused_attention_residual_bare",
                  "fused_mlp_residual_z", "fused_attention_residual_bwd",
                  "fused_attention_residual_bwd_bare", "mlp_dz")
# each runs 12 times in one int8 serving forward, and nowhere else
INT8_FORMS = ("fused_attention_residual_int8",
              "fused_attention_residual_int8_bare", "fused_mlp_residual_int8")
# launches per legacy serving forward and per legacy training step (12
# MultiscaleBlocks, 2 region passes); every other form none
LEGACY_SERVE = {"fused_attention_residual_reg": 12,
                "fused_mlp_residual_reg": 12,
                "fused_attention_residual_reg_bare": 2}
LEGACY_TRAIN = {"fused_attention_residual_reg": 12,
                "fused_mlp_residual_reg_z": 12,
                "fused_attention_residual_reg_bare": 2,
                "fused_attention_residual_bwd_reg": 12,
                "fused_attention_residual_bwd_reg_bare": 2,
                "drop_ew_hd": 12, "drop_ew_dz": 12, "drop_ew_gm": 12}
# launches per memory-lean training step (phase 7): release and legacy;
# every other form none
LEAN_RELEASE_TRAIN = {"fused_attention_residual": 12,
                      "fused_attention_residual_bare": 12,
                      "fused_mlp_residual": 12, "fused_layernorm": 1,
                      "fused_mlp_bwd": 12,
                      "fused_attention_residual_bwd_dw": 12,
                      "fused_attention_residual_bwd_dw_bare": 12}
LEAN_LEGACY_TRAIN = {"fused_attention_residual_reg": 12,
                     "fused_mlp_residual_reg": 12,
                     "fused_attention_residual_reg_bare": 2,
                     "fused_layernorm": 1,
                     "fused_attention_residual_bwd_reg_dw": 12,
                     "fused_attention_residual_bwd_reg_dw_bare": 2,
                     "drop_ew_hd": 12, "drop_ew_dz": 12, "drop_ew_gm": 12}
# the lean routes' gradients against the default routes' on the card, same
# state, batch and seeds: both bf16, rounded at other points (h from the
# float32 z, the weight gradients' sums in the kernel)
LEAN_ROUTE_TOL = GRAD_REL_TOL
# the serving-shape cases of the legacy forward's forms, with launches
LEGACY_SERVING_CASES = (
    ("fused_attention_residual_reg gamma alone n_seg=3136 (serving)", 12),
    ("fused_mlp_residual_reg gamma alone rows=18816 (serving)", 12),
    ("fused_attention_residual_reg_bare no dropout n_seg=64 (serving)", 2))


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


def bound(flops, nbytes, int8_ops=0):
    """The least time for the work: bf16 flops and int8 operations at
    their peaks (one after the other: they share the tensor cores) against
    the bytes at the memory rate. -> (ms, what bounds it)."""
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(torch, out, ref, residual, n_summed=1, scale=1.0):
    """out (kernel, bf16) against ref (plain, float32): max |out - ref|, the
    relative L2 error of the branch ref - residual, and both bars. A column
    sum over n_summed rows is held at atol = 0.08 * sqrt(n_summed): each
    row's term carries its own bf16 rounding, and n independent errors
    add up to sqrt(n) times one. scale: a reg form's largest factor on
    the branch (max gamma / (1 - rate)), by which its rounding errors grow
    with the values they round; atol is multiplied by it."""
    torch.cuda.synchronize()
    out = out.float()
    branch = ref if residual is None else ref - residual.float()
    rel = ((out - ref).norm() / branch.norm().clamp_min(1e-30)).item()
    close = bool(torch.allclose(out, ref, rtol=TOL,
                                atol=TOL * n_summed ** 0.5 * scale))
    return dict(max_abs_err=(out - ref).abs().max().item(), rel_err=rel,
                branch_rms=branch.pow(2).mean().sqrt().item(), close=close,
                ok=close and rel <= BRANCH_REL_TOL)


def compare_all(torch, outputs, scale=1.0):
    """{output: (kernel, plain, residual[, n_summed])} -> the worst of
    each output's compare(), with every output's own result under "outputs";
    the case passes when every output passes both bars."""
    each = {k: compare(torch, *v, scale=scale) for k, v in outputs.items()}
    return dict(max_abs_err=max(r["max_abs_err"] for r in each.values()),
                rel_err=max(r["rel_err"] for r in each.values()),
                branch_rms=min(r["branch_rms"] for r in each.values()),
                close=all(r["close"] for r in each.values()),
                ok=all(r["ok"] for r in each.values()), outputs=each)


def reg_flags(torch, gen, c, reg):
    """A reg case's keyword arguments for the kernel and its plain
    version: gamma 0.5 + U(0, 1) (so that the epilogue shows), or ones
    with reg["gamma"] False; the seed and the rates of `reg`."""
    if reg is None:
        return {}
    gamma = (torch.rand(c, generator=gen) + 0.5 if reg.get("gamma", True)
             else torch.ones(c)).cuda()
    rates = {k: v for k, v in reg.items() if k != "gamma"}
    return dict(gamma=gamma, seed=DROP_SEED if any(rates.values()) else 0,
                **rates)


def reg_scale(flags):
    """The largest factor a reg form's flags put on its branch: max gamma
    over the keep probability of its highest rate (1 for an inert form)."""
    if "gamma" not in flags:
        return 1.0
    rate = max([v for k, v in flags.items() if k.endswith("drop")] + [0.0])
    return flags["gamma"].max().item() / (1.0 - rate)


def attention_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                   reg=None):
    """The attention kernel; reg: the reg form's flags (gamma, attn_drop,
    proj_drop; see reg_flags)."""
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
    flags = dict(use_ln=not bare, use_residual=not bare,
                 **reg_flags(torch, gen, c, reg))

    def kernel():
        return fa.fused_attention_residual(x, lns, lnb, wqkv, bqkv, wproj,
                                           bproj, heads, S, scale, **flags)

    f32 = [t.float() for t in (x, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_plain(
            f32[0], lns, lnb, f32[1], bqkv, f32[2], bproj, heads, S, scale,
            **flags)

    res = compare(torch, kernel(), plain(), None if bare else x,
                  scale=reg_scale(flags))
    if not timed:
        return res
    wqkv_t, wproj_t = wqkv.t().contiguous(), wproj.t().contiguous()
    bqkv_b, bproj_b = bqkv.to(bf16), bproj.to(bf16)
    lns_b, lnb_b = lns.to(bf16), lnb.to(bf16)
    D = c // heads
    a_drop, p_drop = flags.get("attn_drop", 0.0), flags.get("proj_drop", 0.0)
    gamma_b = flags["gamma"].to(bf16) if reg is not None else None

    def library():
        h = x if bare else F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)
        qkv = F.linear(h, wqkv_t, bqkv_b).view(n_seg, S, 3, heads, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, dropout_p=a_drop,
                                           scale=scale)
        y = F.linear(o.transpose(1, 2).reshape(n_seg, S, c), wproj_t,
                     bproj_b)
        if reg is not None:
            y = F.dropout(y, p_drop) * gamma_b
        return y if bare else y + x

    rows = n_seg * S
    flops = 2 * rows * c * 4 * c + 4 * n_seg * S * S * c
    nbytes = (2 * (2 * rows * c + 4 * c * c) + 4 * (2 * c + 4 * c)
              + (4 * c if reg is not None else 0))
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_case(torch, F, fa, gen, rows, c, hidden, timed, z_form=False,
             reg=None):
    """The MLP kernel: the branch (out less x); the z form also z. reg:
    the reg form's flags (gamma, drop; see reg_flags)."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(rows, c).to(dev, bf16)
    lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    w1 = rnd(c, hidden, std=c ** -0.5).to(dev, bf16)
    b1 = rnd(hidden, std=0.01).cuda()
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, bf16)
    b2 = rnd(c, std=0.01).cuda()
    flags = reg_flags(torch, gen, c, reg)

    def kernel():
        return fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2,
                                     return_hidden=z_form, **flags)

    f32 = [t.float() for t in (x, w1, w2)]

    def plain():
        return fa.fused_mlp_residual_plain(f32[0], lns, lnb, f32[1], b1,
                                           f32[2], b2, return_hidden=z_form,
                                           **flags)

    if z_form:
        (out, z), (ref, zref) = kernel(), plain()
        res = compare_all(torch, {"out": (out, ref, x), "z": (z, zref, None)},
                          scale=reg_scale(flags))
    else:
        res = compare(torch, kernel(), plain(), x, scale=reg_scale(flags))
    if not timed:
        return res
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
    b1_b, b2_b, lns_b, lnb_b = (t.to(bf16) for t in (b1, b2, lns, lnb))
    drop = flags.get("drop", 0.0)
    gamma_b = flags["gamma"].to(bf16) if reg is not None else None

    def library():
        zz = F.linear(F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6), w1_t, b1_b)
        if reg is not None:
            y = F.linear(F.dropout(F.gelu(zz), drop), w2_t, b2_b)
            y = F.dropout(y, drop) * gamma_b + x
        else:
            y = F.linear(F.gelu(zz), w2_t, b2_b) + x
        return (y, zz) if z_form else y

    flops = 4 * rows * c * hidden
    nbytes = (2 * (2 * rows * c + 2 * c * hidden
                   + (rows * hidden if z_form else 0))
              + 4 * (3 * c + hidden) + (4 * c if reg is not None else 0))
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def attention_bwd_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                       reg=None):
    """The attention backward kernel: dx less the residual g, ln (full
    form), attn, dqkv and the column sums, each against the plain version
    on the same bf16 inputs upcast to float32; the reg form (reg: see
    reg_flags) also gm where the proj dropout is on."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, bf16)
    g = rnd(n_seg, S, c).to(dev, bf16)
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
    flags = dict(use_ln=not bare, use_residual=not bare,
                 **reg_flags(torch, gen, c, reg))

    def kernel():
        return fa.fused_attention_residual_bwd(x, g, lns, lnb, wqkv, bqkv,
                                               wproj, heads, S, scale,
                                               **flags)

    f32 = [t.float() for t in (x, g, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_bwd_plain(
            f32[0], f32[1], lns, lnb, f32[2], bqkv, f32[3], heads, S, scale,
            **flags)

    out, ref = kernel(), plain()
    names = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj",
             "gm")
    rows = n_seg * S
    pairs = {k: (o, r, None) if o.dim() > 1 else (o, r, None, rows)
             for k, o, r in zip(names, out, ref)
             if not (bare and k in ("ln", "dlns", "dlnb"))}
    if not bare:
        pairs["dx"] = (out[0], ref[0], g)
    res = compare_all(torch, pairs, scale=reg_scale(flags))
    if not timed:
        return res
    D = c // heads
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        x, lns.to(bf16), lnb.to(bf16), wqkv.t().contiguous(), bqkv.to(bf16),
        wproj.t().contiguous(), bproj.to(bf16))]
    if reg is not None:
        leaves.append(flags["gamma"].to(bf16).requires_grad_(True))
    a_drop, p_drop = flags.get("attn_drop", 0.0), flags.get("proj_drop", 0.0)

    def library():
        xx, ls, lb, wq, bq, wp, bp = leaves[:7]
        h = xx if bare else F.layer_norm(xx, (c,), ls, lb, 1e-6)
        qkv = F.linear(h, wq, bq).view(n_seg, S, 3, heads, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, dropout_p=a_drop,
                                           scale=scale)
        y = F.linear(o.transpose(1, 2).reshape(n_seg, S, c), wp, bp)
        if reg is not None:
            y = F.dropout(y, p_drop) * leaves[7]
        y = y if bare else y + xx
        return torch.autograd.grad(y, leaves, g, allow_unused=bare)

    flops = 2 * rows * c * 7 * c + 12 * n_seg * S * S * c
    nbytes = (2 * (rows * c * (3 + (0 if bare else 1) + 1 + 3
                               + (1 if p_drop else 0)) + 4 * c * c)
              + 4 * (2 * c + 3 * c + 6 * c + (c if reg is not None else 0)))
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_dz_case(torch, F, fa, gen, rows, c, hidden, timed):
    """The dz kernel: dz and db1."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    g = rnd(rows, c).to(dev, bf16)
    z = rnd(rows, hidden).to(dev, bf16)
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, bf16)

    def kernel():
        return fa.mlp_dz(g, z, w2)

    f32 = [t.float() for t in (g, z, w2)]

    def plain():
        return fa.mlp_dz_plain(*f32)

    (dz, db1), (dzr, db1r) = kernel(), plain()
    res = compare_all(torch, {"dz": (dz, dzr, None),
                              "db1": (db1, db1r, None, rows)})
    if not timed:
        return res
    w2_t = w2.t()

    def library():
        d = torch.ops.aten.gelu_backward(torch.matmul(g, w2_t), z)
        return d, d.float().sum(0)

    flops = 2 * rows * c * hidden
    nbytes = 2 * (rows * c + 2 * rows * hidden + hidden * c) + 4 * hidden
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def attention_mask_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                        backward=False):
    """The attention probabilities' dropout masks, exactly, in the forward
    kernel (its output) or the backward kernel (its recomputed attn): q =
    k = 0 make every probability 1/S within a segment, v = 1 (its bias)
    and wproj = I make each output element kept / ((1 - rate) S) of its
    (row, head). One mask element that differs from the plain version's
    moves that element by 1 / ((1 - rate) S) (0.022 at S=50, 0.19 at
    S=6), while both sides otherwise agree to the bf16 rounding of p and
    of the output (< 0.007): the case is held at half that move."""
    dev, bf16 = "cuda", torch.bfloat16
    x = torch.randn(n_seg, S, c, generator=gen).to(dev, bf16)
    g = torch.randn(n_seg, S, c, generator=gen).to(dev, bf16)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    wqkv = torch.zeros(c, 3 * c, device=dev, dtype=bf16)
    bqkv = torch.cat([torch.zeros(2 * c), torch.ones(c)]).cuda()
    wproj = torch.eye(c, device=dev, dtype=bf16)
    flags = dict(use_ln=not bare, use_residual=False, gamma=ones,
                 seed=DROP_SEED, attn_drop=DROP)
    scale = (c // heads) ** -0.5
    f32 = [t.float() for t in (x, g, wqkv, wproj)]
    if backward:
        out = fa.fused_attention_residual_bwd(
            x, g, ones, zeros, wqkv, bqkv, wproj, heads, S, scale,
            **flags)[2]
        ref = fa.fused_attention_residual_bwd_plain(
            f32[0], f32[1], ones, zeros, f32[2], bqkv, f32[3], heads, S,
            scale, **flags)[2]
    else:
        out = fa.fused_attention_residual(x, ones, zeros, wqkv, bqkv, wproj,
                                          zeros, heads, S, scale, **flags)
        ref = fa.fused_attention_residual_plain(
            f32[0], ones, zeros, f32[2], bqkv, f32[3], zeros, heads, S,
            scale, **flags)
    res = compare(torch, out, ref, None)
    res["ok"] = res["max_abs_err"] < 0.5 / ((1.0 - DROP) * S)
    return res


def drop_ew_case(torch, F, fa, gen, rows, cols, mode, timed, ones=False):
    """The drop_ew kernel in one mode against its plain version on the
    same bf16 z (and float32 dh). Besides the bars of compare(), the
    fraction of bf16 results that differ from the plain version's rounded
    to bf16 is held at DROP_EW_MISMATCH_TOL, and at 0 for a tensor of
    ones in mode gm: there the output is the mask times a constant, so the
    kernel's masks must equal the plain version's bit for bit."""
    from duoformer_tcga_tpu_torch.ops import fused_reg as fr
    dev, bf16 = "cuda", torch.bfloat16
    site = 3 if mode == "gm" else 2
    z = (torch.ones(rows, cols) if ones
         else torch.randn(rows, cols, generator=gen)).to(dev, bf16)
    dh = (torch.randn(rows, cols, generator=gen).cuda() if mode == "dz"
          else None)

    def kernel():
        return fr.drop_ew(z, DROP_SEED, DROP, site, mode, dh)

    zf = z.float()

    def plain():
        return fr.drop_ew_plain(zf, DROP_SEED, DROP, site, mode, dh)

    out, ref = kernel(), plain()
    res = compare(torch, out, ref, None)
    mism = (out != ref.to(bf16)).float().mean().item()
    res["mismatch"] = mism
    res["ok"] = res["ok"] and (mism == 0 if ones
                               else mism <= DROP_EW_MISMATCH_TOL)
    if not timed:
        return res

    def library():
        if mode == "gm":
            return F.dropout(z, DROP)
        if mode == "hd":
            return F.dropout(F.gelu(z), DROP)
        return torch.ops.aten.gelu_backward(F.dropout(dh, DROP), zf).to(bf16)

    n = rows * cols
    nbytes = n * (8 if mode == "dz" else 4)
    bound_ms, bound_by = bound(0, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=0, bytes=nbytes)
    return res


def mlp_bwd_case(torch, F, fa, gen, rows, c, hidden, timed):
    """The recompute-from-x MLP backward kernel: dx less the residual g,
    ln, h, dz and the column sums dlns, dlnb."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(rows, c).to(dev, bf16)
    g = rnd(rows, c).to(dev, bf16)
    lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    w1 = rnd(c, hidden, std=c ** -0.5).to(dev, bf16)
    b1 = rnd(hidden, std=0.01).cuda()
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, bf16)

    def kernel():
        return fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)

    f32 = [t.float() for t in (x, g, w1, w2)]

    def plain():
        return fa.fused_mlp_bwd_plain(f32[0], f32[1], lns, lnb, f32[2], b1,
                                      f32[3])

    out, ref = kernel(), plain()
    names = ("dx", "ln", "h", "dz", "dlns", "dlnb")
    pairs = {k: (o, r, None) if o.dim() > 1 else (o, r, None, rows)
             for k, o, r in zip(names, out, ref)}
    pairs["dx"] = (out[0], ref[0], g)
    res = compare_all(torch, pairs)
    if not timed:
        return res
    b2 = torch.zeros(c, device=dev, dtype=bf16)
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        x, lns.to(bf16), lnb.to(bf16), w1.t().contiguous(), b1.to(bf16),
        w2.t().contiguous(), b2)]

    def library():
        xx, ls, lb, ww1, bb1, ww2, bb2 = leaves
        y = F.linear(F.gelu(F.linear(F.layer_norm(xx, (c,), ls, lb, 1e-6),
                                     ww1, bb1)), ww2, bb2) + xx
        return torch.autograd.grad(y, leaves, g)

    flops = 6 * rows * c * hidden
    nbytes = (2 * (4 * rows * c + 2 * rows * hidden + 2 * c * hidden)
              + 4 * (4 * c + hidden))
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def attention_bwd_dw_case(torch, F, fa, gen, n_seg, S, c, heads, bare,
                          timed, reg=None):
    """The attention backward kernel's dw form: dx (less the residual g),
    the column sums, dwqkv and dwA against the plain version; dwqkv and
    dwA also against the dw=False kernel's row-space outputs multiplied
    with torch.matmul (relative L2 <= BRANCH_REL_TOL); and a second launch
    on the same inputs: dwqkv and dwA (float32 atomic sums in another
    order) within the bars of the first, every other output bit for
    bit."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, bf16)
    g = rnd(n_seg, S, c).to(dev, bf16)
    if bare:
        lns = torch.zeros(c, device=dev)
        lnb = torch.zeros(c, device=dev)
    else:
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5).to(dev, bf16)
    bqkv = rnd(3 * c, std=0.01).cuda()
    wproj = rnd(c, c, std=c ** -0.5).to(dev, bf16)
    scale = (c // heads) ** -0.5
    flags = dict(use_ln=not bare, use_residual=not bare,
                 **reg_flags(torch, gen, c, reg))
    args = (x, g, lns, lnb, wqkv, bqkv, wproj, heads, S, scale)

    def kernel():
        return fa.fused_attention_residual_bwd(*args, dw=True, **flags)

    f32 = [t.float() for t in (x, g, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_bwd_plain(
            f32[0], f32[1], lns, lnb, f32[2], bqkv, f32[3], heads, S, scale,
            dw=True, **flags)

    out, ref = kernel(), plain()
    rows = n_seg * S
    names = ("dx", "dlns", "dlnb", "dbqkv", "dbproj", "dwqkv", "dwA")
    pairs = {k: (o, r, None, rows) for k, o, r in zip(names, out, ref)
             if not (bare and k in ("dlns", "dlnb"))}
    pairs["dx"] = (out[0], ref[0], None if bare else g)
    res = compare_all(torch, pairs, scale=reg_scale(flags))
    # the dw=False route's weight gradients, float32 sums of its bf16
    # row-space outputs
    rs = fa.fused_attention_residual_bwd(*args, **flags)
    gacc = rs[8] if flags.get("proj_drop", 0.0) > 0.0 else g.view(rows, c)
    route = (fa._mm_f32(rs[1].t(), rs[3]), fa._mm_f32(rs[2].t(), gacc))
    vs = [rel_err(a, b) for a, b in zip(out[5:], route)]
    again = kernel()
    same = all(torch.equal(a, b) for a, b in zip(again[:5], out[:5]))
    rerun = compare_all(torch, {k: (a, b.float(), None, rows) for k, a, b in
                                zip(("dwqkv", "dwA"), again[5:], out[5:])})
    res.update(vs_dw_false=max(vs), rerun_rel_err=rerun["rel_err"],
               rerun_bit_identical=all(torch.equal(a, b) for a, b in
                                       zip(again, out)),
               ok=res["ok"] and max(vs) <= BRANCH_REL_TOL and same
               and rerun["ok"])
    if not timed:
        return res
    p_drop = flags.get("proj_drop", 0.0)

    def library():
        r = fa.fused_attention_residual_bwd(*args, **flags)
        ga = r[8] if p_drop > 0.0 else g.view(rows, c)
        return (torch.matmul(r[1].t(), r[3]), torch.matmul(r[2].t(), ga))

    flops = 2 * rows * c * 7 * c + 12 * n_seg * S * S * c + 8 * rows * c * c
    nbytes = (2 * (3 * rows * c + 4 * c * c)
              + 4 * (2 * c + 3 * c + 6 * c + 4 * c * c
                     + (c if reg is not None else 0)))
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def layernorm_case(torch, F, fa, gen, rows, c, timed):
    """The LayerNorm kernel (through ops.nn.fused_layernorm) against its
    plain version."""
    from duoformer_tcga_tpu_torch.ops import nn as tnn
    dev, bf16 = "cuda", torch.bfloat16
    x = (torch.randn(rows, c, generator=gen) * 2.0 + 0.5).to(dev, bf16)
    scale = (torch.randn(c, generator=gen) * 0.1 + 1.0).cuda()
    bias = (torch.randn(c, generator=gen) * 0.1).cuda()

    def kernel():
        return tnn.fused_layernorm(x, scale, bias)

    xf = x.float()

    def plain():
        return tnn.fused_layernorm_plain(xf, scale, bias)

    res = compare(torch, kernel(), plain(), None)
    if not timed:
        return res
    scale_b, bias_b = scale.to(bf16), bias.to(bf16)

    def library():
        return F.layer_norm(x, (c,), scale_b, bias_b, 1e-6)

    nbytes = 2 * 2 * rows * c + 4 * 2 * c
    bound_ms, bound_by = bound(0, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=0, bytes=nbytes)
    return res


def block_attention_case(torch, F, fa, gen, n_seg, S, c, heads, timed):
    """The block-diagonal attention kernel against its plain version; q, k,
    v drawn so that the scores spread about 2 units."""
    dev, bf16 = "cuda", torch.bfloat16
    qkv = (torch.randn(n_seg, S, 3 * c, generator=gen) * 1.5).to(dev, bf16)
    scale = (c // heads) ** -0.5

    def kernel():
        return fa.block_diag_attention_fwd(qkv, heads, S, scale)

    qf = qkv.float()

    def plain():
        return fa.block_diag_attention_plain(qf, heads, S, scale)

    res = compare(torch, kernel(), plain(), None)
    if not timed:
        return res
    D = c // heads

    def library():
        q, k, v = qkv.view(n_seg, S, 3, heads, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return o.transpose(1, 2).reshape(n_seg, S, c)

    flops = 4 * n_seg * S * S * c
    nbytes = 2 * (n_seg * S * 3 * c + n_seg * S * c)
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def _int8_weight(torch, w):
    """float32 (in, out) -> (int8 [out, in], scale [out]) on the card, by
    the port's quantize_weight."""
    from duoformer_tcga_tpu_torch.ops.quantize import quantize_weight
    w_q, sc = quantize_weight(w)
    return w_q.t().contiguous().cuda(), sc.cuda()


def _rowquant_library(torch, v):
    """The library yardstick's row quantization (plain torch ops)."""
    v = v.float()
    s = (v.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-30)
    return torch.round(v / s).clamp(-127, 127).to(torch.int8), s


def attention_int8_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed):
    """The int8 attention kernel against its plain version on the same bf16
    x and int8 weights (so both round at the same points)."""
    from duoformer_tcga_tpu_torch.ops import fused_int8 as fi
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, bf16)
    if bare:
        lns = torch.zeros(c, device=dev)
        lnb = torch.zeros(c, device=dev)
    else:
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    wq, sq = _int8_weight(torch, rnd(c, 3 * c, std=QKV_STD * c ** -0.5))
    bqkv = rnd(3 * c, std=0.01).cuda()
    wp, sp = _int8_weight(torch, rnd(c, c, std=c ** -0.5))
    bproj = rnd(c, std=0.01).cuda()
    scale = (c // heads) ** -0.5
    flags = dict(use_ln=not bare, use_residual=not bare)
    args = (x, lns, lnb, wq, sq, bqkv, wp, sp, bproj, heads, S, scale)

    def kernel():
        return fi.fused_attention_residual_int8(*args, **flags)

    def plain():
        return fi.fused_attention_residual_int8_plain(*args, **flags)

    res = compare(torch, kernel(), plain().float(), None if bare else x)
    if not timed:
        return res
    lns_b, lnb_b = lns.to(bf16), lnb.to(bf16)
    D, rows = c // heads, n_seg * S
    wq_t, wp_t = wq.t(), wp.t()       # column-major, as _int_mm wants

    def library():
        h = x if bare else F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)
        hq, hs = _rowquant_library(torch, h.view(rows, c))
        qkv = (torch._int_mm(hq, wq_t).float() * hs * sq + bqkv).to(bf16)
        q, k, v = qkv.view(n_seg, S, 3, heads, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        oq, os_ = _rowquant_library(torch, o.transpose(1, 2).reshape(rows, c))
        y = torch._int_mm(oq, wp_t).float() * os_ * sp + bproj
        y = y if bare else y + x.view(rows, c).float()
        return y.to(bf16)

    int8_ops = 2 * rows * c * 4 * c
    flops = 4 * n_seg * S * S * c
    nbytes = 2 * 2 * rows * c + 4 * c * c + 4 * 10 * c
    bound_ms, bound_by = bound(flops, nbytes, int8_ops)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, int8_ops=int8_ops,
               bytes=nbytes)
    return res


def mlp_int8_case(torch, F, fa, gen, rows, c, hidden, timed):
    """The int8 MLP kernel against its plain version on the same bf16 x and
    int8 weights: the branch (out less x)."""
    from duoformer_tcga_tpu_torch.ops import fused_int8 as fi
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(rows, c).to(dev, bf16)
    lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    w1, s1 = _int8_weight(torch, rnd(c, hidden, std=c ** -0.5))
    b1 = rnd(hidden, std=0.01).cuda()
    w2, s2 = _int8_weight(torch, rnd(hidden, c, std=hidden ** -0.5))
    b2 = rnd(c, std=0.01).cuda()
    args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)

    def kernel():
        return fi.fused_mlp_residual_int8(*args)

    def plain():
        return fi.fused_mlp_residual_int8_plain(*args)

    res = compare(torch, kernel(), plain().float(), x)
    if not timed:
        return res
    lns_b, lnb_b = lns.to(bf16), lnb.to(bf16)
    w1_t, w2_t = w1.t(), w2.t()

    def library():
        lq, ls = _rowquant_library(
            torch, F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6))
        h = F.gelu(torch._int_mm(lq, w1_t).float() * ls * s1 + b1)
        hq, hs = _rowquant_library(torch, h)
        y = torch._int_mm(hq, w2_t).float() * hs * s2 + b2 + x.float()
        return y.to(bf16)

    int8_ops = 4 * rows * c * hidden
    nbytes = 2 * 2 * rows * c + 2 * c * hidden + 4 * (4 * c + 2 * hidden)
    bound_ms, bound_by = bound(0, nbytes, int8_ops)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=0, int8_ops=int8_ops, bytes=nbytes)
    return res


def _case_specs(torch, F, fa, timed):
    """[(label, kernel form, run(generator))]: each form at its main path's
    shape (label = the form), then the other shapes."""
    rows_s, rows_t = B * 49 * 6, B_TRAIN * 49 * 6
    att, mlp = attention_case, mlp_case
    mlp_z = functools.partial(mlp_case, z_form=True)
    bwd, dz = attention_bwd_case, mlp_dz_case
    att8, mlp8 = attention_int8_case, mlp_int8_case
    part = functools.partial
    both = dict(attn_drop=DROP, proj_drop=DROP)
    att_r = part(att, reg=both)                 # the legacy scale blocks
    att_g = part(att, reg={})                   # LayerScale alone (eval)
    att_rb = part(att, reg=dict(gamma=False, attn_drop=DROP))   # region
    att_gb = part(att, reg=dict(gamma=False))   # region, eval
    mlp_r = part(mlp, reg=dict(drop=DROP))
    mlp_g = part(mlp, reg={})
    mlp_rz = part(mlp, z_form=True, reg=dict(drop=DROP))
    bwd_r = part(bwd, reg=both)
    bwd_rb = part(bwd, reg=dict(gamma=False, attn_drop=DROP))
    ew = drop_ew_case
    mlpb, dw, ln, bda = (mlp_bwd_case, attention_bwd_dw_case, layernorm_case,
                         block_attention_case)
    dw_r = part(dw, reg=both)
    dw_rb = part(dw, reg=dict(gamma=False, attn_drop=DROP))
    specs = [
        # the serving path's forms (B=64)
        ("fused_attention_residual", B * 49, 6, C, HEADS, False, att, timed),
        ("fused_attention_residual_bare", B, 50, C, HEADS, True, att, timed),
        ("fused_mlp_residual", rows_s, C, HIDDEN, mlp, timed),
        # the training step's forms (B=128)
        ("fused_mlp_residual_z", rows_t, C, HIDDEN, mlp_z, timed),
        ("fused_attention_residual_bwd", B_TRAIN * 49, 6, C, HEADS, False,
         bwd, timed),
        ("fused_attention_residual_bwd_bare", B_TRAIN, 50, C, HEADS, True,
         bwd, timed),
        ("mlp_dz", rows_t, C, HIDDEN, dz, timed),
        # other shapes
        ("fused_attention_residual_bare n_seg=256 S=50 (B=256)", 256, 50, C,
         HEADS, True, att, timed),
        ("fused_attention_residual n_seg=13 S=6 C=256 H=4", 13, 6, 256, 4,
         False, att, False),
        ("fused_attention_residual_bare n_seg=3 S=50 C=256 H=4", 3, 50, 256,
         4, True, att, False),
        ("fused_mlp_residual rows=222 C=256 hidden=1024", 222, 256, 1024,
         mlp, False),
        ("fused_mlp_residual_z rows=222 C=256 hidden=1024", 222, 256, 1024,
         mlp_z, False),
        ("fused_attention_residual_bwd n_seg=13 S=6 C=256 H=4", 13, 6, 256,
         4, False, bwd, False),
        ("fused_attention_residual_bwd_bare n_seg=3 S=50 C=256 H=4", 3, 50,
         256, 4, True, bwd, False),
        ("mlp_dz rows=222 C=256 hidden=1024", 222, 256, 1024, dz, False),
        # the int8 serving path's forms (B=64), then the other shapes
        ("fused_attention_residual_int8", B * 49, 6, C, HEADS, False, att8,
         timed),
        ("fused_attention_residual_int8_bare", B, 50, C, HEADS, True, att8,
         timed),
        ("fused_mlp_residual_int8", rows_s, C, HIDDEN, mlp8, timed),
        ("fused_attention_residual_int8_bare n_seg=256 S=50 (B=256)", 256, 50,
         C, HEADS, True, att8, timed),
        ("fused_attention_residual_int8 n_seg=13 S=6 C=256 H=4", 13, 6, 256,
         4, False, att8, False),
        ("fused_attention_residual_int8_bare n_seg=3 S=50 C=256 H=4", 3, 50,
         256, 4, True, att8, False),
        ("fused_mlp_residual_int8 rows=222 C=256 hidden=1024", 222, 256,
         1024, mlp8, False),
        # the legacy family's reg forms: training (B=128, dropout 0.1,
        # gamma), then serving (B=64, gamma alone), then other shapes
        ("fused_attention_residual_reg", B_TRAIN * 49, 6, C, HEADS, False,
         att_r, timed),
        ("fused_attention_residual_reg_bare", B_TRAIN, 50, C, HEADS, True,
         att_rb, timed),
        ("fused_mlp_residual_reg", rows_t, C, HIDDEN, mlp_r, timed),
        ("fused_mlp_residual_reg_z", rows_t, C, HIDDEN, mlp_rz, timed),
        ("fused_attention_residual_bwd_reg", B_TRAIN * 49, 6, C, HEADS,
         False, bwd_r, timed),
        ("fused_attention_residual_bwd_reg_bare", B_TRAIN, 50, C, HEADS,
         True, bwd_rb, timed),
        ("drop_ew_hd", rows_t, HIDDEN, "hd", ew, timed),
        ("drop_ew_dz", rows_t, HIDDEN, "dz", ew, timed),
        ("drop_ew_gm", rows_t, C, "gm", ew, timed),
        ("drop_ew_gm mask of ones, exact rows=37632 cols=768", rows_t, C,
         "gm", part(ew, ones=True), False),
        ("fused_attention_residual_reg attention masks, exact n_seg=6272",
         B_TRAIN * 49, 6, C, HEADS, False, attention_mask_case, False),
        ("fused_attention_residual_reg_bare attention masks, exact "
         "n_seg=128", B_TRAIN, 50, C, HEADS, True, attention_mask_case,
         False),
        ("fused_attention_residual_bwd_reg attention masks, exact "
         "n_seg=6272", B_TRAIN * 49, 6, C, HEADS, False,
         part(attention_mask_case, backward=True), False),
        ("fused_attention_residual_bwd_reg_bare attention masks, exact "
         "n_seg=128", B_TRAIN, 50, C, HEADS, True,
         part(attention_mask_case, backward=True), False),
        ("fused_attention_residual_reg gamma alone n_seg=3136 (serving)",
         B * 49, 6, C, HEADS, False, att_g, timed),
        ("fused_attention_residual_reg_bare no dropout n_seg=64 (serving)",
         B, 50, C, HEADS, True, att_gb, timed),
        ("fused_mlp_residual_reg gamma alone rows=18816 (serving)", rows_s,
         C, HIDDEN, mlp_g, timed),
        ("fused_attention_residual_reg n_seg=13 S=6 C=256 H=4", 13, 6, 256,
         4, False, att_r, False),
        ("fused_attention_residual_reg_bare n_seg=3 S=50 C=256 H=4", 3, 50,
         256, 4, True, att_rb, False),
        ("fused_mlp_residual_reg_z rows=222 C=256 hidden=1024", 222, 256,
         1024, mlp_rz, False),
        ("fused_attention_residual_bwd_reg n_seg=13 S=6 C=256 H=4", 13, 6,
         256, 4, False, bwd_r, False),
        ("fused_attention_residual_bwd_reg_bare n_seg=3 S=50 C=256 H=4", 3,
         50, 256, 4, True, bwd_rb, False),
        ("drop_ew_dz rows=222 cols=1024", 222, 1024, "dz", ew, False),
        # the memory-lean step's forms (B=128; LayerNorm on its CLS), the
        # block-diagonal attention op, then other shapes
        ("fused_mlp_bwd", rows_t, C, HIDDEN, mlpb, timed),
        ("fused_attention_residual_bwd_dw", B_TRAIN * 49, 6, C, HEADS, False,
         dw, timed),
        ("fused_attention_residual_bwd_dw_bare", B_TRAIN, 50, C, HEADS, True,
         dw, timed),
        ("fused_attention_residual_bwd_reg_dw", B_TRAIN * 49, 6, C, HEADS,
         False, dw_r, timed),
        ("fused_attention_residual_bwd_reg_dw_bare", B_TRAIN, 50, C, HEADS,
         True, dw_rb, timed),
        ("fused_layernorm", B_TRAIN, C, ln, timed),
        ("block_diag_attention", B * 49, 6, C, HEADS, bda, timed),
        ("fused_layernorm rows=18816 C=768", rows_s, C, ln, timed),
        ("block_diag_attention n_seg=64 S=50", B, 50, C, HEADS, bda, timed),
        ("fused_mlp_bwd rows=222 C=256 hidden=1024", 222, 256, 1024, mlpb,
         False),
        ("fused_attention_residual_bwd_dw n_seg=13 S=6 C=256 H=4", 13, 6,
         256, 4, False, dw, False),
        ("fused_attention_residual_bwd_reg_dw n_seg=13 S=6 C=256 H=4", 13, 6,
         256, 4, False, dw_r, False),
        ("fused_attention_residual_bwd_reg_dw_bare n_seg=3 S=50 C=256 H=4",
         3, 50, 256, 4, True, dw_rb, False),
        ("fused_layernorm rows=37 C=256", 37, 256, ln, False),
        ("block_diag_attention n_seg=13 S=6 C=256 H=4", 13, 6, 256, 4, bda,
         False),
        ("block_diag_attention n_seg=3 S=50 C=256 H=4", 3, 50, 256, 4, bda,
         False),
    ]
    out = []
    for label, *args in specs:
        *shape, case, t = args
        out.append((label, label.split(" ")[0],
                    lambda gen, case=case, shape=shape, t=t:
                    case(torch, F, fa, gen, *shape, t)))
    return out


def kernel_checks(torch, F, fa, timed, source=None):
    """-> (the main paths' cases by kernel form, the other cases by
    description); `timed` adds the times and bounds. The serving forms run
    at the serving shapes (B=64), the training forms at the training step's
    (B_TRAIN=128). source: a kernel source (a value of SOURCES) to run
    only the cases of its forms. Each case draws its inputs from a
    generator of its own, seeded by its place in the list."""
    cases, others = {}, {}
    for i, (label, form, run) in enumerate(_case_specs(torch, F, fa, timed)):
        if source is not None and SOURCES[form] != source:
            continue
        res = run(torch.Generator().manual_seed(SEED + i))
        (cases if label == form else others)[label] = res
    return cases, others


def rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def grad_check_names(model):
    """The tensors whose card-vs-CPU gradients are compared: every tensor
    of scale blocks 0 and 11, qkv and proj of patch blocks 0 and 11, the
    head, the tokens and position embeddings, the projection convs."""
    last = len(model.transformer.scale_blocks) - 1
    keep = [f"transformer.scale_blocks.{i}." for i in (0, last)]
    keep += [f"transformer.patch_blocks.{i}.attn." for i in (0, last)]
    keep += ["transformer.head.", "transformer.pos_embed",
             "transformer.cls_token", "scale_token", "projection."]
    return [n for n, p in model.named_parameters()
            if p.requires_grad and any(n.startswith(k) for k in keep)]


def serve_stages(torch, pred, batch):
    """One forward of `pred` on `batch`, stage by stage (CUDA events,
    median of 5) -> {stage: ms}."""
    m = pred.model
    with torch.inference_mode():
        x = pred.prepare(batch)
        feats = m.features(x)
        toks = m.tokens(feats)
        sc = m.transformer.scale_stack(toks)
        cls = m.transformer.cls_embedding(sc)
        stages = {
            "preprocess": lambda: pred.prepare(batch),
            "backbone": lambda: m.features(x),
            "projection+regroup": lambda: m.tokens(feats),
            "scale stack": lambda: m.transformer.scale_stack(toks),
            "patch (or region) stack":
                lambda: m.transformer.cls_embedding(sc),
            "head": lambda: m.transformer.head(cls),
        }
        return {k: median_ms(f, torch, 5) for k, f in stages.items()}


def serve_rates(torch, preds, batch, n=5):
    """{name: Predictor} -> {name: (median seconds per forward, the 7
    windows)}: 7 rounds, each one host-clock window of n forwards (ending
    in a synchronise) of every Predictor in turn, so that slow and fast
    spells of the host fall on all of them alike."""
    windows = {k: [] for k in preds}
    for _ in range(7):
        for k, pred in preds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                pred(batch)
            torch.cuda.synchronize()
            windows[k].append((time.perf_counter() - t0) / n)
    return {k: (float(np.median(w)), w) for k, w in windows.items()}


def int8_phase(torch, port, fa, failures, card, cases, bf16_run):
    """Phase 5: int8 serving of the same full-width model through
    Predictor(quantize=True). -> the launch counts of its 3 forwards."""
    from duoformer_tcga_tpu_torch.inference import Predictor

    def build(device):
        return port.build_model_no_extra_params(
            num_layers=2, embed_dim=C, proj_dim=C, num_heads=HEADS, depth=12,
            device=device, seed=SEED)

    t0 = time.perf_counter()
    pred = Predictor(build("cuda"), dtype=torch.bfloat16, quantize=True)
    log(f"int8: model built, quantized and prepared in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    fa.reset_launch_counts()
    outs = [pred(t) for t in batches]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    log(f"int8 serving: 3 batches of {B}; launches {launches}")
    for name in cases:
        want = 12 * len(batches) if name in INT8_FORMS else 0
        if launches.get(name, 0) != want:
            failures.append(f"int8 serving: {launches.get(name, 0)} launches "
                            f"of {name}, expected {want}")
    for i, lg in enumerate(outs):
        if tuple(lg.shape) != (B, 2) or not bool(torch.isfinite(lg).all()):
            failures.append(f"int8 batch {i}: logits {tuple(lg.shape)}, "
                            f"finite={bool(torch.isfinite(lg).all())}")

    # drift from the bf16 Predictor on the same weights and batch, at the
    # JAX package's bound (tests/test_int8.py:58); the CLS's drift is
    # printed beside it (random-init logits are mostly the head bias)
    ref, ref_cls = (t.float().cpu() for t in bf16_run["pred"].embed(
        batches[0]))
    logits8, cls8 = (t.float().cpu() for t in pred.embed(batches[0]))
    drift = (logits8 - ref).abs().max().item()
    limit = 0.05 * (ref.abs().max().item() + 1.0)
    log(f"int8 vs bf16 on batch 0: logits max |diff| {drift:.4e} (bound "
        f"{limit:.4e}), argmax agrees on "
        f"{(logits8.argmax(-1) == ref.argmax(-1)).sum().item()} of {B}; "
        f"CLS rel L2 drift {rel_err(cls8, ref_cls):.3e}")
    if not drift < limit:
        failures.append(f"int8 vs bf16 logit drift {drift:.4e} >= {limit:.4e}")

    two = batches[0][:2]
    g_logits, g_cls = pred.embed(two)
    ref_pred = Predictor(build("cpu"), device="cpu", dtype=torch.float32,
                         quantize=True)
    c_logits, c_cls = ref_pred.embed(two)
    e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
    log(f"int8 embed vs the CPU float32 int8 path: rel L2 err cls "
        f"{e_cls:.3e}, logits {e_logits:.3e} (tolerance {EMBED_REL_TOL})")
    if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
        failures.append(f"int8 embed vs CPU: {e_cls:.3e} / {e_logits:.3e}")
    del ref_pred

    stages = serve_stages(torch, pred, batches[0])
    for name, st in (("bf16", bf16_run["stages"]), ("int8", stages)):
        log(f"stages at B={B}, {name}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in st.items()))
    rates = serve_rates(torch, {"int8": pred, "bf16": bf16_run["pred"]},
                        batches[0])
    kernel_ms = sum(12 * cases[k]["ms"] for k in INT8_FORMS)
    for name, (dt, windows) in rates.items():
        log(f"{name} throughput, windows interleaved: {B / dt:.1f} tiles/s "
            f"at B={B}, median of 7 windows of 5 forwards (least "
            f"{B / max(windows):.1f}, greatest {B / min(windows):.1f}; "
            f"forward {dt * 1e3:.2f} ms" + (
                f", of which the 36 int8 kernel launches ~{kernel_ms:.2f} ms "
                f"by their timings above" if name == "int8" else "") +
            f"); on {card}")
    return launches


def train_phase(torch, port, fa, failures, card):
    """Phase 4: the release training step at full width on the card.
    -> the launch counts of one counted step."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib

    def setup(device, dtype):
        model = port.build_model_no_extra_params(
            num_layers=2, embed_dim=C, proj_dim=C, num_heads=HEADS, depth=12,
            device=device, seed=SEED)
        opt = train_lib.make_optimizer(
            model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
            frozen_label_fn=train_lib.backbone_frozen_labels)
        state = train_lib.init_train_state(model, opt)
        return model, state, train_lib.make_train_step(model, dtype=dtype)

    t0 = time.perf_counter()
    model, state, step = setup("cuda", torch.bfloat16)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    log(f"train: model and step set up in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in state['optimizer'].param_groups[0]['params']) / 1e6:.2f} "
        f"M trainable elements")
    rng = np.random.default_rng(SEED + 1)
    batches = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 2, (B_TRAIN,))} for _ in range(3)]

    # ---- gradients on 2 tiles: card (bf16) vs the port on the CPU (f32) ----
    t0 = time.perf_counter()
    cpu_model, _, _ = setup("cpu", torch.float32)
    names = grad_check_names(model)

    def grads(m, device, dtype):
        """Both tiles take label 0: at random init the CLS hardly depends
        on the tile, so with opposite labels the two tiles' gradients all
        but cancel and their difference measures the cancellation."""
        x = data_lib.preprocess_tiles(
            torch.as_tensor(batches[0]["image"][:2]).to(device), dtype=dtype)
        labels = torch.zeros(2, dtype=torch.long).to(device)
        params = dict(m.named_parameters())
        loss = train_lib.cross_entropy(m(x), labels)
        return torch.autograd.grad(loss, [params[n] for n in names])

    errs = {n: rel_err(a, b) for n, a, b in zip(
        names, grads(model, "cuda", torch.bfloat16),
        grads(cpu_model, "cpu", torch.float32))}
    del cpu_model
    worst = max(errs, key=errs.get)
    log(f"train: gradients card bf16 vs CPU float32 on 2 tiles "
        f"({time.perf_counter() - t0:.1f} s), rel L2 err of {len(errs)} "
        f"tensors (tolerance {GRAD_REL_TOL}), worst {worst} "
        f"{errs[worst]:.3e}:")
    for n, e in errs.items():
        log(f"  {n}: {e:.3e}")
    failures += [f"gradient of {n}: rel err {e:.3e}" for n, e in errs.items()
                 if not e <= GRAD_REL_TOL]

    # ---- one counted step, then two more ----
    fa.reset_launch_counts()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    losses = [float(m["loss"])]
    for b in batches[1:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    log(f"train: one step at B={B_TRAIN}, launches {launches}; losses of 3 "
        f"steps {losses}")
    if not all(np.isfinite(losses)):
        failures.append(f"train losses {losses}")
    after = model.state_dict()
    unused = ("transformer.fc_norm.",)     # quirk Q7: the head reads raw CLS
    same = [n for n in trainable if not n.startswith(unused)
            and torch.equal(after[n], before[n])]
    moved = [n for n in before if n.startswith("backbone.")
             and not torch.equal(after[n], before[n])]
    log(f"train: {len(trainable)} trainable tensors, unchanged after 3 "
        f"steps: {same}; backbone tensors changed: {moved}")
    if same:
        failures.append(f"trainable tensors unchanged: {same[:5]}")
    if moved:
        failures.append(f"backbone tensors changed: {moved[:5]}")
    del before

    time_step(torch, model, state, step, batches, card, "train")
    return launches


def time_step(torch, model, state, step, batches, card, what):
    """A training step's time: 7 host-clock windows of 3 steps, the
    forward / backward / optimizer split (CUDA events, median of 5 steps),
    the peak memory of a step and one step's device time by kernel
    (torch.profiler, CUPTI). A model with dropout takes seeds drawn for
    each step of the split, as the training step draws them."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    from duoformer_tcga_tpu_torch.models.duoformer import draw_seeds
    tf = model.transformer
    gen = torch.Generator().manual_seed(SEED)
    n, windows = 3, []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(n):
            state, _ = step(state, batches[j])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n)
    dt = float(np.median(windows))

    x = data_lib.preprocess_tiles(
        torch.as_tensor(batches[0]["image"]).cuda(), dtype=torch.bfloat16)
    labels = torch.as_tensor(batches[0]["label"]).cuda()
    split = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state["optimizer"].zero_grad(set_to_none=True)
        seeds = draw_seeds(tf.num_seeds(), gen) if tf.has_dropout else None
        ev[0].record()
        loss = train_lib.cross_entropy(model(x, seeds=seeds), labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        train_lib.apply_update(state)
        ev[3].record()
        ev[3].synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, opt = np.median(np.array(split), axis=0)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batches[0])
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"{what} profile of one step: device busy {busy:.2f} ms "
        f"({busy / (dt * 1e3):.1%} of the {dt * 1e3:.2f} ms step); by "
        f"kernel (ms, launches):" if rows else
        f"{what} profile: the profiler saw no device time (not measured)")
    for ms, count, key in rows[:16]:
        log(f"  {ms:8.3f} {count:5d}  {key[:90]}")
    log(f"{what} throughput: {B_TRAIN / dt:.1f} tiles/s at B={B_TRAIN}, "
        f"median of 7 windows of {n} steps (least {B_TRAIN / max(windows):.1f}"
        f", greatest {B_TRAIN / min(windows):.1f}; step {dt * 1e3:.2f} ms); "
        f"forward {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {opt:.2f} "
        f"ms (CUDA events, median of 5 steps); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")


def check_launches(failures, what, launches, want, names):
    """Every form in `names` ran exactly want.get(form, 0) times."""
    for name in names:
        if launches.get(name, 0) != want.get(name, 0):
            failures.append(f"{what}: {launches.get(name, 0)} launches of "
                            f"{name}, expected {want.get(name, 0)}")


def legacy_grad_names(model, trainable):
    """The legacy tensors whose card-vs-CPU gradients are compared: every
    tensor of blocks 0 and depth-1, the head, the norm, the tokens and
    position embeddings, the projection convs. Left out: the carried q/k
    norms (no forward applies them, Q9) and the channel fusers (plain
    torch convs and batch-stat BNs, no kernel of the port: at random init
    the token's gradient hardly depends on the tile, so the BN backward's
    mean subtraction cancels it to a remainder bf16 cannot resolve; the
    CPU tests hold the fusers to JAX in float32)."""
    last = len(model.transformer.blocks) - 1
    keep = [f"transformer.blocks.{i}." for i in (0, last)] + [
        "transformer.head.", "transformer.norm.", "transformer.pos_embed",
        "transformer.cls_token", "projection."]
    return [n for n in trainable if any(n.startswith(k) for k in keep)
            and "_norm." not in n]


def two_tile_grads(torch, m, names, image, seeds, device, dtype,
                   tokens=None):
    """Gradients of one backward of `m` on 2 tiles, both of label 0 (at
    random init the CLS hardly depends on the tile, so with opposite
    labels the gradients all but cancel) -> ({name: gradient}, the
    tokens); given tokens, the transformer's gradients from them (of the
    names under "transformer.")."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    x = data_lib.preprocess_tiles(torch.as_tensor(image).to(device),
                                  dtype=dtype)
    labels = torch.zeros(len(image), dtype=torch.long).to(device)
    params = dict(m.named_parameters())
    wrt = (names if tokens is None
           else [n for n in names if n.startswith("transformer.")])
    if tokens is None:
        tokens = m.tokens(m.features(x))
    loss = train_lib.cross_entropy(m.transformer(tokens, seeds=seeds),
                                   labels)
    return (dict(zip(wrt, torch.autograd.grad(
        loss, [params[n] for n in wrt]))), tokens.detach())


def three_steps(torch, fa, failures, what, model, state, step, batches,
                trainable, before, want, cases, dead=()):
    """One step counted (every form of `cases` launched exactly
    want.get(form, 0) times), then two more: finite losses, every trainable
    tensor changed but a `dead` one (a name containing one of them) that
    the loss does not reach and stays 0, every backbone tensor and BN
    statistic unchanged. -> the counted step's launches."""
    fa.reset_launch_counts()
    state, m = step(state, batches[0])
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    losses = [float(m["loss"])]
    for b in batches[1:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    log(f"{what}: one step at B={B_TRAIN}, launches {launches}; losses of 3 "
        f"steps {losses}")
    check_launches(failures, f"{what} step", launches, want, cases)
    if not all(np.isfinite(losses)):
        failures.append(f"{what} losses {losses}")
    after = model.state_dict()
    same = [n for n in trainable if not (any(d in n for d in dead)
                                         and not before[n].any())
            and torch.equal(after[n], before[n])]
    moved = [n for n in before if (n.startswith("backbone.") or n.endswith(
        (".mean", ".var"))) and not torch.equal(after[n], before[n])]
    log(f"{what}: {len(trainable)} trainable tensors, unchanged after 3 "
        f"steps: {same}; backbone tensors and BN statistics changed: "
        f"{moved}")
    if same:
        failures.append(f"{what}: trainable tensors unchanged: {same[:5]}")
    if moved:
        failures.append(f"{what}: frozen tensors changed: {moved[:5]}")
    return launches


def legacy_phase(torch, port, fa, failures, card, cases, others):
    """Phase 6: the legacy DuoFormer (build_model: channel token,
    LayerScale 1e-5, attention dropout 0.1, dropout 0.1) at full width,
    served at B=64 and trained at B=128. -> the launch counts of 3
    forwards and of one step."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.inference import Predictor
    from duoformer_tcga_tpu_torch.models.duoformer import draw_seeds

    def build(device):
        return port.build_model(depth=12, embed_dim=C, num_heads=HEADS,
                                proj_dim=C, num_classes=2, device=device,
                                seed=SEED)

    # ---- serving: 3 forwards, counted; embed() vs the CPU; tiles/s ----
    t0 = time.perf_counter()
    pred = Predictor(build("cuda"), dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 2)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    fa.reset_launch_counts()
    outs = [pred(t) for t in batches]
    torch.cuda.synchronize()
    serve_launches = dict(fa.launch_counts)
    log(f"legacy serving: built in {time.perf_counter() - t0:.1f} s; 3 "
        f"batches of {B}; launches {serve_launches}")
    check_launches(failures, "legacy serving", serve_launches,
                   {k: 3 * v for k, v in LEGACY_SERVE.items()}, cases)
    for i, lg in enumerate(outs):
        if tuple(lg.shape) != (B, 2) or not bool(torch.isfinite(lg).all()):
            failures.append(f"legacy batch {i}: logits {tuple(lg.shape)}, "
                            f"finite={bool(torch.isfinite(lg).all())}")
    two = batches[0][:2]
    g_logits, g_cls = pred.embed(two)
    c_logits, c_cls = Predictor(build("cpu"), device="cpu",
                                dtype=torch.float32).embed(two)
    e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
    log(f"legacy embed vs CPU float32: rel L2 err cls {e_cls:.3e}, logits "
        f"{e_logits:.3e} (tolerance {EMBED_REL_TOL})")
    if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
        failures.append(f"legacy embed vs CPU: {e_cls:.3e} / {e_logits:.3e}")
    stages = serve_stages(torch, pred, batches[0])
    log("legacy stages at B=%d: %s" % (B, ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items())))
    dt, windows = serve_rates(torch, {"legacy": pred}, batches[0])["legacy"]
    kernel_ms = sum(n * others[k]["ms"] for k, n in LEGACY_SERVING_CASES)
    log(f"legacy throughput: {B / dt:.1f} tiles/s at B={B}, median of 7 "
        f"windows of 5 forwards (least {B / max(windows):.1f}, greatest "
        f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms, of which the 26 "
        f"kernel launches ~{kernel_ms:.2f} ms by their serving-shape "
        f"timings above) on {card}")
    del pred, outs
    torch.cuda.empty_cache()

    # ---- training ----
    def setup(device, dtype):
        model = build(device)
        opt = train_lib.make_optimizer(
            model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
            frozen_label_fn=train_lib.backbone_frozen_labels)
        state = train_lib.init_train_state(model, opt)
        return model, state, train_lib.make_train_step(model, dtype=dtype)

    t0 = time.perf_counter()
    model, state, step = setup("cuda", torch.bfloat16)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 3)
    batches = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 2, (B_TRAIN,))} for _ in range(3)]

    # gradients of one backward on 2 tiles with the same seeds, card bf16
    # against CPU float32, twice: from the same tokens (the card's, upcast)
    # through the transformer, the path of the kernels, at GRAD_REL_TOL;
    # and end to end from the tiles, where the bf16 pyramid's tokens (1%
    # off) move these gradients further (the MLP's fc1 and norm2 most;
    # printed beside the first), at LEGACY_E2E_GRAD_TOL
    cpu_model, _, _ = setup("cpu", torch.float32)
    names = legacy_grad_names(model, trainable)
    seeds = draw_seeds(model.transformer.num_seeds(),
                       torch.Generator().manual_seed(SEED))
    grads = functools.partial(two_tile_grads, torch, names=names,
                              image=batches[0]["image"][:2], seeds=seeds)
    g_card, card_tokens = grads(model, device="cuda", dtype=torch.bfloat16)
    cpu_e2e, cpu_tokens = grads(cpu_model, device="cpu", dtype=torch.float32)
    cpu_same, _ = grads(cpu_model, device="cpu", dtype=torch.float32,
                        tokens=card_tokens.float().cpu())
    del cpu_model
    errs = {n: rel_err(g_card[n], e) for n, e in cpu_same.items()}
    e2e = {n: rel_err(g_card[n], cpu_e2e[n]) for n in names}
    log(f"legacy train: set up and gradients on 2 tiles, same seeds "
        f"({time.perf_counter() - t0:.1f} s); tokens card vs CPU rel L2 "
        f"{rel_err(card_tokens, cpu_tokens):.3e}; rel L2 err card bf16 vs "
        f"CPU float32 (from the same tokens, tolerance {GRAD_REL_TOL} | end "
        f"to end, tolerance {LEGACY_E2E_GRAD_TOL}):")
    for n in names:
        log(f"  {n}: {errs.get(n, float('nan')):.3e} | {e2e[n]:.3e}")
    failures += [f"legacy gradient of {n} (same tokens): rel err {e:.3e}"
                 for n, e in errs.items() if not e <= GRAD_REL_TOL]
    failures += [f"legacy gradient of {n} (end to end): rel err {e:.3e}"
                 for n, e in e2e.items() if not e <= LEGACY_E2E_GRAD_TOL]

    # parameters the loss does not reach get a zero gradient and Adam's L2
    # term moves only those that are not 0: the carried q/k norms (Q9) and
    # attn2 of blocks 1..depth-2 (Q4: the region pass uses block 0's and
    # block depth-1's) keep their zero biases
    train_launches = three_steps(
        torch, fa, failures, "legacy train", model, state, step, batches,
        trainable, before, LEGACY_TRAIN, cases, legacy_dead(model))
    del before
    time_step(torch, model, state, step, batches, card, "legacy train")
    return serve_launches, train_launches


def legacy_dead(model):
    """The legacy parameters no loss reaches: the carried q/k norms (Q9)
    and attn2 of blocks 1..depth-2 (Q4)."""
    return ("_norm.",) + tuple(f".blocks.{i}.attn2." for i in
                               range(1, len(model.transformer.blocks) - 1))


def lean_phase(torch, port, fa, failures, card, cases):
    """Phase 7: the memory-lean training step (make_train_step(
    mlp_save_hidden=False, attn_bwd_dw=True), fused_ln=True) at full width
    and B=128, release (apply_fc_norm=True) then legacy. -> {path: the
    launch counts of one counted step}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.models.duoformer import draw_seeds
    lean = dict(mlp_save_hidden=False, attn_bwd_dw=True)
    out = {}
    for family in ("release", "legacy"):
        legacy = family == "legacy"

        def setup(device, dtype):
            if legacy:
                model = port.build_model(
                    depth=12, embed_dim=C, num_heads=HEADS, proj_dim=C,
                    num_classes=2, fused_ln=True, device=device, seed=SEED)
            else:
                model = port.build_model_no_extra_params(
                    num_layers=2, embed_dim=C, proj_dim=C, num_heads=HEADS,
                    depth=12, apply_fc_norm=True, fused_ln=True,
                    device=device, seed=SEED)
            opt = train_lib.make_optimizer(
                model, train_lib.onecycle_schedule(1e-4, 1000),
                weight_decay=1e-4,
                frozen_label_fn=train_lib.backbone_frozen_labels)
            state = train_lib.init_train_state(model, opt)
            return model, state, train_lib.make_train_step(model, dtype=dtype,
                                                           **lean)

        what = f"{family} lean train"
        t0 = time.perf_counter()
        model, state, step = setup("cuda", torch.bfloat16)
        tf = model.transformer
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        before = {n: t.detach().clone() for n, t in model.state_dict().items()}
        rng = np.random.default_rng(SEED + 5 + int(legacy))
        batches = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                          dtype=np.uint8),
                    "label": rng.integers(0, 2, (B_TRAIN,))}
                   for _ in range(3)]

        # gradients of one backward on 2 tiles (the same seeds): card bf16
        # against the port's CPU float32 run on the same routes, at phase
        # 4's bar (release) or phase 6's (legacy: from the card's tokens,
        # and end to end); and against the default routes on the card,
        # same state and batch
        cpu_model, _, _ = setup("cpu", torch.float32)
        names = (legacy_grad_names(model, trainable) if legacy else
                 grad_check_names(model) + ["transformer.fc_norm.scale",
                                            "transformer.fc_norm.bias"])
        seeds = (draw_seeds(tf.num_seeds(), torch.Generator().manual_seed(
            SEED)) if tf.has_dropout else None)
        grads = functools.partial(two_tile_grads, torch, names=names,
                                  image=batches[0]["image"][:2], seeds=seeds)
        g_card, card_tokens = grads(model, device="cuda",
                                    dtype=torch.bfloat16)
        cpu_e2e, _ = grads(cpu_model, device="cpu", dtype=torch.float32)
        e2e = {n: rel_err(g_card[n], cpu_e2e[n]) for n in names}
        e2e_tol = LEGACY_E2E_GRAD_TOL if legacy else GRAD_REL_TOL
        same = {}
        if legacy:
            cpu_same, _ = grads(cpu_model, device="cpu", dtype=torch.float32,
                                tokens=card_tokens.float().cpu())
            same = {n: rel_err(g_card[n], e) for n, e in cpu_same.items()}
        del cpu_model
        train_lib.set_backward_routes(model)
        g_default, _ = grads(model, device="cuda", dtype=torch.bfloat16)
        train_lib.set_backward_routes(model, **lean)
        route = {n: rel_err(g_card[n], g_default[n]) for n in names}
        del g_default
        log(f"{what}: set up and gradients on 2 tiles "
            f"({time.perf_counter() - t0:.1f} s); rel L2 err card bf16 vs "
            f"CPU float32 (" + (f"from the same tokens, tolerance "
                                f"{GRAD_REL_TOL} | " if legacy else "") +
            f"end to end, tolerance {e2e_tol}) || lean vs default routes on "
            f"the card (tolerance {LEAN_ROUTE_TOL}):")
        for n in names:
            log(f"  {n}: " + (f"{same.get(n, float('nan')):.3e} | "
                              if legacy else "")
                + f"{e2e[n]:.3e} || {route[n]:.3e}")
        failures += [f"{what} gradient of {n} (same tokens): {e:.3e}"
                     for n, e in same.items() if not e <= GRAD_REL_TOL]
        failures += [f"{what} gradient of {n} (end to end): {e:.3e}"
                     for n, e in e2e.items() if not e <= e2e_tol]
        failures += [f"{what} gradient of {n} (vs default routes): {e:.3e}"
                     for n, e in route.items() if not e <= LEAN_ROUTE_TOL]

        out[f"{what} (1 step)"] = three_steps(
            torch, fa, failures, what, model, state, step, batches,
            trainable, before,
            LEAN_LEGACY_TRAIN if legacy else LEAN_RELEASE_TRAIN, cases,
            legacy_dead(model) if legacy else ())
        del before
        time_step(torch, model, state, step, batches, card, what)
        del model, state, step
        torch.cuda.empty_cache()
    return out


def block_attention_op_path(torch, fa, failures):
    """The block_diag_attention op through its entry point: forward and
    backward at the checked shapes (S=6 over 3136 segments, S=50 over 64),
    counted. -> the launch counts."""
    gen = torch.Generator().manual_seed(SEED + 7)
    fa.reset_launch_counts()
    res = []
    for n_seg, S in ((B * 49, 6), (B, 50)):
        qkv = (torch.randn(n_seg, S, 3 * C, generator=gen) * 1.5).to(
            "cuda", torch.bfloat16).requires_grad_(True)
        out = fa.block_diag_attention(qkv, HEADS, S, (C // HEADS) ** -0.5)
        out.float().square().sum().backward()
        ref = fa.block_diag_attention_plain(qkv.detach().float(), HEADS, S,
                                            (C // HEADS) ** -0.5)
        err = rel_err(out.detach(), ref)
        ok = (tuple(out.shape) == (n_seg, S, C) and err <= BRANCH_REL_TOL
              and bool(torch.isfinite(qkv.grad).all()))
        res.append(f"S={S}: rel L2 err {err:.3e}, grad finite {ok}")
        if not ok:
            failures.append(f"block_diag_attention op at S={S}: {res[-1]}")
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    log(f"block_diag_attention op: forward and backward at S=6 and S=50: "
        f"{'; '.join(res)}; launches {launches}")
    check_launches(failures, "block_diag_attention op", launches,
                   {"block_diag_attention": 2}, ["block_diag_attention"])
    return launches


def main() -> int:
    t_start = time.perf_counter()
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
               if "ms" in res else "")
            + (f"; bf16 mismatch fraction {res['mismatch']:.3g}"
               if "mismatch" in res else ""))
        for out, r in res.get("outputs", {}).items():
            log(f"  {out}: max_abs_err {r['max_abs_err']:.6g}, rel L2 err "
                f"{r['rel_err']:.4g} {'ok' if r['ok'] else 'FAIL'}")
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
        want = 12 * len(batches) if name in SERVING_FORMS else 0
        if launches.get(name, 0) != want:
            failures.append(f"{name}: {launches.get(name, 0)} launches, "
                            f"expected {want}")
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

    stages = serve_stages(torch, pred, batches[0])
    log("stages at B=%d: %s" % (B, ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items())))
    dt, windows = serve_rates(torch, {"bf16": pred}, batches[0])["bf16"]
    kernel_ms = sum(12 * cases[k]["ms"] for k in SERVING_FORMS)
    log(f"throughput: {B / dt:.1f} tiles/s at B={B}, median of 7 windows "
        f"of 5 forwards (least {B / max(windows):.1f}, greatest "
        f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms, of which the "
        f"36 kernel launches ~{kernel_ms:.2f} ms by their timings above) on "
        f"{card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ref_pred, outs

    # ---- 5. int8 serving, beside the bf16 Predictor of phase 3 ----
    int8_launches = int8_phase(torch, port, fa, failures, card, cases,
                               dict(pred=pred, stages=stages))
    del pred
    torch.cuda.empty_cache()

    # ---- 4. the training step ----
    train_launches = train_phase(torch, port, fa, failures, card)
    torch.cuda.empty_cache()
    check_launches(failures, "train step", train_launches,
                   {k: 12 for k in TRAINING_FORMS}, cases)

    # ---- 6. the legacy family: serving and training ----
    legacy_serve, legacy_train = legacy_phase(torch, port, fa, failures,
                                              card, cases, others)
    torch.cuda.empty_cache()

    # ---- 7. the memory-lean training steps; the block-diagonal op ----
    lean_launches = lean_phase(torch, port, fa, failures, card, cases)
    op_launches = block_attention_op_path(torch, fa, failures)

    paths = {f"serve ({len(batches)} forwards)": launches,
             "train (1 step)": train_launches,
             f"serve int8 ({len(batches)} forwards)": int8_launches,
             "legacy serve (3 forwards)": legacy_serve,
             "legacy train (1 step)": legacy_train, **lean_launches,
             "block_diag_attention op (2 calls)": op_launches}
    idle = [name for name in cases
            if not any(v.get(name, 0) for v in paths.values())]
    if idle:
        failures.append(f"kernel forms no path launched: {idle}")
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name],
                    launches=sum(v.get(name, 0) for v in paths.values()),
                    launches_by_path={k: v.get(name, 0)
                                      for k, v in paths.items()},
                    max_abs_err=res["max_abs_err"], ms=res["ms"],
                    plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                    bound_by=res["bound_by"], library_ms=res["library_ms"])
               for name, res in cases.items()]
    log(f"elapsed: {time.perf_counter() - t_start:.0f} s")
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
