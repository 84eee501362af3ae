#!/usr/bin/env python3
"""Drive the PyTorch port (duoformer_tcga_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the fourteen CUDA kernel sources from the checkout (one nvcc
   each, started together) and prints each kernel's register and spill
   report.
2. Holds every kernel form against its plain PyTorch version on the card:
   the serving forms at the serving path's shapes (C=768, 12 heads, B=64;
   the 384-wide ones at phase 11's),
   the training forms (the MLP's z form, the attention backward in both
   forms, the MLP's dz pass) at the training step's (B=128), the int8
   forms (attention full and bare, MLP) at the serving shapes, the reg
   forms (dropout 0.1 from one seed, gamma 0.5 + U(0, 1)) at the legacy
   training step's shapes and with gamma alone at the serving shapes,
   drop_ew in its three modes, the bare forms also at B=256, the
   memory-lean step's forms at its shapes (B=128: the recompute-from-x MLP
   backward, the attention backward's dw form inert, bare and reg, the
   LayerNorm on the CLS, also at [18816, 768]), the block-diagonal
   attention op at S=6 (3136 segments) and S=50 (64), the 86-token forms
   of the 3- and 4-scale serving paths (B=64: each of the two launches of
   the bf16 and of the int8 branch alone at 3136 segments of S=86, both
   launches through the wrappers there, at 7 segments, bare at 5 and at
   S=65 (also at C=512 with one segment); a second launch of each launch
   alone bit-identical), the S<=64
   kernels at S=22 (3136 segments), the attention backward of the 3- and
   4-scale training steps (both forms, full and bare, at S=86 over 6272
   segments (B=128), 3136 and a ragged 7 or 5, at S=65, and at S=22 over
   6272; the plain versions run over chunks of segments; held against
   the plain version on the same bf16 inputs at the bars below and against
   the float32-input one at the relative L2 bar, see
   attention_bwd_big_case; a second launch bit-identical; dqkv against the
   bf16-input plain version also at ROUND_REL_TOL in two cases; the dw
   form's extra device memory at 6272 segments at most DW_EXTRA_BYTES), the MLP
   kernels at the 4-scale step's 539,392 rows (held row chunk by row
   chunk, untimed), the MLP forward at a ragged 18,817 rows and, with
   dropout, at rows its wrapper takes in two chunks (mlp_chunks_case), the ViT-B/16 baseline's long-segment forms (S=197:
   the forward chain alone at 128 segments, full and bare, both launches
   at 64 and 128 and a ragged 7, at S=87, and at C=512 with one segment;
   the backward in both forms,
   full and bare, at 128 segments (timed), 1024 and a ragged 7, and at
   S=87, held as attention_bwd_big_case holds them, below 1e8 elements
   also at every bar against the float32-input plain version, the dw
   form's scratch at 128 and 1024 segments at most DW_EXTRA_BYTES), the
   reg forms at 86 tokens of phase 12's R4r (the core with the attention
   dropout at 3136 segments, the proj with gamma at 3136, both launches
   with gamma alone, the attention dropout and gamma (3136 and 6272),
   all three flags and bare; the backward with the attention dropout and
   gamma, and with the proj dropout and gamma (gm), dw=False at 3136 and
   dw at 6272 segments, held as attention_bwd_big_case holds them, the
   dw form's scratch, geff and gm at most DW_EXTRA_BYTES; small ragged,
   bare and S=65 shapes; the masks exactly at S=86, forward and
   backward; the core with the attention dropout over 1001 segments,
   which its wrapper must take in chunks of segments with a ragged last
   one (a spy on attention_seg_chunks reads the chunks it used); the bf16
   bars scaled by max gamma / (1 - rate)); the
   block-diagonal attention op's long core at S=197 over 128 segments
   and 7, at S=86 and S=65 over 3136 (from 1e8 elements held as the
   backward at that size), at S=65 over 3, with scores spread ~150 units
   (the softmax must subtract its row max) and ~0.25 units (the mask must
   drop every padding key), and on the first 7 segments of a tensor whose
   next two are NaN (its output must be finite: no read past its rows)),
   the S<=64 forms' packed units (csrc/attention_sm90.cu: 64 // S whole
   segments a unit) at S=1, 6, 21, 22 and 64 with short last units, #10 at
   S=6 and 22 with scores spread ~0.25 and ~150, on the first 13 segments
   of a NaN-tailed tensor and into the first segments of a guarded output
   (the rows past it must keep their sentinel), and #1 with the attention
   dropout and gamma over two chunks of segments at S=6 (6273 segments,
   the last chunk ragged; fails in one chunk), the backward up to 64
   tokens (csrc/attention_bwd_sm90.cu, one chain a call) at S=1, 21 and
   64 with short last units, with dq, dk and dv each held alone at S=6
   (6272 segments) and S=22 (3136) as attention_bwd_big_case holds them,
   and in its reg dw form with every flag over chunks of segments at S=6
   (6273 segments, the last chunk ragged; fails in one chunk), the
   backward at 65..197 tokens (the same chain's long core) at S=65, 86, 87
   and 197 over 1, 2 and 7 segments, at C=256, 512 and 768, with dq, dk
   and dv each held alone, on the first rows of inputs whose later rows
   are NaN, over three chunks of segments with the scratch bound cut (a
   spy on attention_bwd_seg_chunks; the reg forms with every flag and with
   the attention dropout, the long dw form), the reg forms over two
   segments, and its dw form twice at 6272 segments of 86 tokens, bit for
   bit, the dz pass (csrc/mlp_dz.cu on gemm_sm90.cuh's EPI_DZ) at 1, 127
   and 129 rows, at C=384 over 1000 rows and twice at 37,632 rows, dz and
   db1 bit for bit, and each at one small odd shape:
   kernel in bf16,
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
   outputs multiplied by torch.matmul, and a second launch's bit for bit
   (every output). Yardsticks of the new forms:
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
   counted (2 launches).
8. Runs last: the release DuoFormer at 3 and 4 scales (S=22 and S=86 a
   region; full width, depth 12, random weights from a fixed seed),
   served at B=64 through Predictor in bf16 and through
   Predictor(quantize=True) in int8: 3 forwards each, counted (exactly
   the launches of SCALES_SERVE and no other form), finite logits,
   embed() on 2 tiles and the region tokens the scale stack hands the
   patch stack against the port's CPU float32 run of the same weights
   (the int8 ones against the CPU int8 path; relative L2 <= 0.05: bf16
   the CLS, the logits and the region tokens; int8 the logits and the
   region tokens, its CLS printed beside how far the CPU int8 path's own
   CLS moves under a 1e-6 relative change of its tokens, about as far:
   the 12 residual-free int8 PatchBlocks at random init turn any
   perturbation into compounding code flips; the CPU run in bf16 printed
   beside), int8 logits within 0.05 * (max|bf16| + 1) of bf16's, the
   stage times, memory resident and peak during the forwards, and both
   Predictors' tiles/s in interleaved windows.
9. Runs last: the release DuoFormer trained (depth 4: SCALES_TRAIN_DEPTH,
   to keep the script inside its time limit) at 3 scales on the default
   routes at B=128, and at 4 scales (apply_fc_norm and fused_ln, as phase
   7's) on the memory-lean routes at B=128 and on the default routes at
   B=64 (the default routes' saved hidden at B=128 would not fit). Each:
   one counted step with exactly the launches of SCALES_TRAIN at that
   depth and no other form (4 S=22 or S=86 attention backwards, 4 bare
   S=50 ones); over 3
   steps a finite loss, every trainable tensor moved, the backbone
   bit-identical; tiles/s (7 windows of 3 steps, 1 at 4 scales), split,
   peak memory and profile as in 4. The gradients of one backward on 2
   tiles against the port's CPU float32 run at phase 4's bar, on each
   route, and at 4 scales lean against default on the card at phase 7's.
10. Runs last: the ViT-B/16 baseline (build_vit_base16, the
   `vit-baseline` preset: 768 wide, 12 heads, depth 12, 197 tokens, 100
   classes; random weights from a fixed seed), served at B=64 through
   Predictor in bf16 (3 forwards counted: exactly the launches of
   VIT_SERVE and no other form; finite logits; embed()'s post-norm CLS
   and logits on 2 tiles against the port's CPU float32 run, relative L2
   <= 0.05; tiles/s in 7 windows; peak memory) and trained at B=128,
   every parameter (Adam with L2 decay 1e-4 on all, OneCycle at 1e-4), on
   the default routes and on the memory-lean routes (the final norm
   through the LayerNorm kernel): the gradients of one backward on 2
   tiles against the port's CPU float32 run (0.05) and lean against
   default on the card (0.05); one counted step with exactly the launches
   of VIT_TRAIN and no other form; over 3 steps a finite loss and every
   tensor moved, the patch embed and the position embedding included;
   tiles/s (7 windows of 2 steps), split, peak memory and profile as in
   4. The block_diag_attention op path of phase 7 also runs the long core
   at S=86 (3136 segments) and S=197 (128).
11. Runs last: the ResNetV2 hybrid baselines (build_vit_base16 with
   model_type "R50ViT": R26-S/32 trunk, ViT-S 384 wide, 6 heads, depth 12,
   50 tokens; and "ViTPretrained": R50-S/16 trunk, ViT-B, 197 tokens; 100
   classes, random weights from a fixed seed). R50ViT (H1) runs the
   kernels' 384-wide forms, each counted under its form's name + "_c384"
   and held against its plain version in phase 2 like the others (S=50
   over 64 and 128 segments; rows 3,200 and 6,400; hidden 1536; and small
   odd shapes, bare, S=6 and reg flags); ViTPretrained (H2) runs phase
   10's 197-token forms. Each served at B=64 through Predictor in bf16
   (3 forwards counted: exactly the launches of H1_SERVE / VIT_SERVE;
   finite logits; embed()'s CLS and logits on 2 tiles against the port's
   CPU float32 run, relative L2 <= 0.05; tiles/s in 7 windows; peak
   memory) and trained at B=128, every parameter, the trunk included: H1
   on the default and the memory-lean routes, H2 on the default routes;
   the ViT's gradients of one backward on 2 tiles against the CPU float32
   run from the same tokens (0.05) and end to end (0.1, as phase 6), the
   trunk's printed beside the CPU's own bf16 run (bf16 rounding through
   the trunk moves them on either device), H1 lean against default on the
   card (0.05, the trunk's included); one counted step with exactly the
   launches of H1_TRAIN / VIT_TRAIN; over 3 steps a finite loss and every
   tensor moved; tiles/s (7 windows of 2 steps), split, peak memory and
   profile as in 4.
12. Runs last: R4r, the release DuoFormer at 4 scales with the legacy
   preset's regularisation (build_model_no_extra_params(num_layers=4,
   init_values=1e-5, attn_drop_rate=0.1, proj_drop_rate=0.1): Q9 makes
   the rates the attention-probability and MLP dropout and applies the
   patch blocks' q/k norms, in plain PyTorch off the kernels), full
   width, depth 12, random weights from a fixed seed: served at B=64 in
   bf16 (3 forwards counted: exactly the launches of R4R_SERVE; finite
   logits; embed() on 2 tiles against the port's CPU float32 run,
   relative L2 <= 0.05; tiles/s in 7 windows; stages; peak memory) and
   trained on the default routes at B=64 and the memory-lean ones at
   B=128: the gradients of one backward on 2 tiles with the same seeds
   on both routes against the CPU float32 run (0.05) and lean against
   default (0.05), the patch blocks' q/k norms printed and not held (see
   reg_grad_names); one counted step each with exactly the launches of
   R4R_TRAIN; over 3 steps a finite loss, every trainable tensor moved
   but zero biases the loss does not reach, the backbone unchanged;
   tiles/s (7 windows of 1 step), split, peak memory and profile as in
   4. Then R3r (3 scales) at depth 2: the gradients on 2 tiles against
   the CPU (0.05) and one counted step at B=64 (R3R_TRAIN).
13. Runs last: float32 (the JAX package's dtype float32), with both TF32
   flags set True for the phase (PyTorch's cuDNN default), so that the
   float32 entry points hold by their own scoping (Predictor and the
   training step turn TF32 off inside and put the flags back). Its kernel
   forms (csrc/*_f32.cu: the attention forward full and bare, the MLP's
   serving and z forms, the attention backward dw=False full and bare,
   the dz pass) are held in phase 2 against their float32 plain versions
   at F32_REL_TOL and F32_TOL (column sums over n rows at F32_TOL *
   sqrt(n)), at the path's shapes (S=6 and 22 over 3136 segments and
   bare S=50 over 64 and 128; 18,816 and 37,632 rows; the backward at S=6
   and 22 over 6272 and bare over 128) and small ragged ones at C=256,
   512 and 768 (the attention forward also at S=64 at C=256 and 512); the
   attention forward's 3xTF32 products (csrc/fused_attention_residual_f32
   .cu on gemm_sm90.cuh's EPI_X3) twice at each path shape, bit for bit,
   and its weight split against tf32_split_plain, bit for bit. R2f, the release model at depth 12 in float32, served at
   B=64 through Predictor(dtype=float32) (3 forwards counted: exactly the
   launches of F32_SERVE, no bf16 form; embed() on 2 tiles against the
   port's CPU float32 run, relative L2 <= F32_EMBED_REL_TOL; tiles/s in 7
   windows; peak memory) and trained at B=128 on the default routes
   (gradients on 2 tiles against the CPU float32 run <= F32_GRAD_REL_TOL;
   one counted step with exactly the launches of F32_TRAIN; over 3 steps
   a finite loss, every trainable tensor moved, the backbone unchanged;
   tiles/s (7 windows of 1 step), split, peak memory and profile as in
   4); R3f, the 3-scale model at depth F32_R3_DEPTH, served at B=64
   (the S=22 forms; embed() at the same bar); and a float32 R4r block and
   a float32 86-token block raising NotImplementedError that names
   ROADMAP B5a.
Every kernel form must have launched on some path.
Prints the card's name and power limit, one JSON line {"kernels": [...]},
and as its last line {"ok": true, "device": {...}}. Exits non-zero, with
no result line, when there is no CUDA device, when the port is not beside
this script, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
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
# float32-accurate products: 3xTF32 on the dense TF32 tensor cores (495
# TFLOP/s, NVIDIA data sheet), the fastest the card computes at float32
# accuracy
PEAK_F32_FLOPS = 495e12 / 3
# the float32 forms (phase 13) against their float32 plain versions:
# relative L2 of the branch and elementwise atol = rtol (column sums over n
# rows at atol * sqrt(n)); single-pass TF32 reads ~3e-4, FMA or 3xTF32
# ~1e-6
F32_REL_TOL = 1e-5
F32_TOL = 1e-4
REPEATS = 20
GRAD_REL_TOL = 0.05        # card (bf16) vs CPU (float32) gradients
LEGACY_E2E_GRAD_TOL = 0.1  # the same, legacy, end to end (see phase 6)
# the hybrids' ViT gradients end to end, through a bf16 ResNetV2 trunk
# whose tokens are ~13% off the CPU's float32 ones (see phase 11)
HYBRID_E2E_GRAD_TOL = LEGACY_E2E_GRAD_TOL
DROP = 0.1                 # the legacy family's dropout rates
DROP_SEED = 12345          # the kernel cases' dropout seed
# drop_ew computes one float32 formula on both sides; only erff, expf and
# fma contraction move a bf16 rounding, in about 1e-5 of the elements
DROP_EW_MISMATCH_TOL = 1e-3
# the 65..86-token backward: its plain version runs over chunks of this
# many segments (whole, its float32 intermediates at n_seg 6272 hold tens
# of GB), timed over PLAIN_REPEATS runs; dqkv against the plain version on
# the same bf16 inputs, which rounds where the kernels round: summation
# order alone moves it by ~3e-4 (a CPU emulation), moving one rounding
# point (p in bf16 for the softmax Jacobian) by ~3e-3
PLAIN_CHUNK_SEGS = 392
PLAIN_REPEATS = 5
ROUND_REL_TOL = 1.5e-3
# the dw form's extra device memory at the 4-scale step's n_seg 6272 (its
# per-chunk scratch; dw=False writes ~4.1 GB of ln, attn and dqkv), and at
# the ViT's n_seg 128 and 1024
DW_EXTRA_BYTES = 512e6
# below this many elements an output of the long backward is also held at
# every bar against the float32-input plain version (at 1e8 and more the
# TPU kernel's own rounding points cross the elementwise bar there:
# attention_bwd_big_case)
UPCAST_BARS_MAX = 1e8
VIT_CLASSES = 100          # vit-baseline (config.py:189)
VIT_S = 197                # 196 patches + CLS
CSRC = "duoformer_tcga_tpu_torch/csrc/"
PALLAS = "duoformer_tcga_tpu/ops/pallas_attention.py:"
# kernel form -> its CUDA source; REPLACES: -> the TPU kernel it replaces
SOURCES = {
    "fused_attention_residual": CSRC + "attention_sm90.cu",
    "fused_attention_residual_bare": CSRC + "attention_sm90.cu",
    "fused_mlp_residual": CSRC + "fused_mlp_residual.cu",
    "fused_mlp_residual_z": CSRC + "fused_mlp_residual.cu",
    "fused_attention_residual_bwd": CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_bare":
        CSRC + "attention_bwd_sm90.cu",
    "mlp_dz": CSRC + "mlp_dz.cu",
    "fused_attention_residual_int8": CSRC + "fused_attention_residual_int8.cu",
    "fused_attention_residual_int8_bare":
        CSRC + "fused_attention_residual_int8.cu",
    "fused_mlp_residual_int8": CSRC + "fused_mlp_residual_int8.cu",
    "fused_attention_residual_reg": CSRC + "attention_sm90.cu",
    "fused_attention_residual_reg_bare": CSRC + "attention_sm90.cu",
    "fused_mlp_residual_reg": CSRC + "fused_mlp_residual.cu",
    "fused_mlp_residual_reg_z": CSRC + "fused_mlp_residual.cu",
    "fused_attention_residual_bwd_reg":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_reg_bare":
        CSRC + "attention_bwd_sm90.cu",
    "drop_ew_hd": CSRC + "drop_ew.cu",
    "drop_ew_dz": CSRC + "drop_ew.cu",
    "drop_ew_gm": CSRC + "drop_ew.cu",
    "fused_mlp_bwd": CSRC + "fused_mlp_bwd.cu",
    "fused_attention_residual_bwd_dw":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_dw_bare":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_reg_dw":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_reg_dw_bare":
        CSRC + "attention_bwd_sm90.cu",
    "fused_layernorm": CSRC + "layernorm.cu",
    "block_diag_attention": CSRC + "attention_sm90.cu",
    "fused_attention_residual_s86": CSRC + "attention_sm90.cu",
    "fused_attention_residual_s86_proj": CSRC + "attention_sm90.cu",
    "fused_attention_residual_int8_s86":
        CSRC + "fused_attention_residual_int8_s86.cu",
    "fused_attention_residual_int8_s86_proj":
        CSRC + "fused_attention_residual_int8_s86.cu",
    "fused_attention_residual_bwd_s86":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_s86_bare":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_s86_dw":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_s86_dw_bare":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_long": CSRC + "attention_sm90.cu",
    "fused_attention_residual_long_bare": CSRC + "attention_sm90.cu",
    "fused_attention_residual_bwd_long": CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_long_bare": CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_long_dw": CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_long_dw_bare":
        CSRC + "attention_bwd_sm90.cu",
    "block_diag_attention_long": CSRC + "attention_sm90.cu",
    "fused_attention_residual_s86_reg": CSRC + "attention_sm90.cu",
    "fused_attention_residual_s86_proj_reg": CSRC + "attention_sm90.cu",
    "fused_attention_residual_bwd_s86_reg":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_bwd_s86_reg_dw":
        CSRC + "attention_bwd_sm90.cu",
    "fused_attention_residual_f32": CSRC + "fused_attention_residual_f32.cu",
    "fused_attention_residual_f32_bare":
        CSRC + "fused_attention_residual_f32.cu",
    "fused_mlp_residual_f32": CSRC + "fused_mlp_residual_f32.cu",
    "fused_mlp_residual_z_f32": CSRC + "fused_mlp_residual_f32.cu",
    "fused_attention_residual_bwd_f32":
        CSRC + "fused_attention_residual_bwd_f32.cu",
    "fused_attention_residual_bwd_f32_bare":
        CSRC + "fused_attention_residual_bwd_f32.cu",
    "mlp_dz_f32": CSRC + "mlp_dz_f32.cu",
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
    "fused_attention_residual_s86": PALLAS + "311",
    "fused_attention_residual_s86_proj": PALLAS + "311",
    "fused_attention_residual_int8_s86": PALLAS + "442",
    "fused_attention_residual_int8_s86_proj": PALLAS + "442",
    "fused_attention_residual_bwd_s86": PALLAS + "723",
    "fused_attention_residual_bwd_s86_bare": PALLAS + "723",
    "fused_attention_residual_bwd_s86_dw": PALLAS + "723",
    "fused_attention_residual_bwd_s86_dw_bare": PALLAS + "723",
    "fused_attention_residual_long": PALLAS + "311",
    "fused_attention_residual_long_bare": PALLAS + "311",
    "fused_attention_residual_bwd_long": PALLAS + "723",
    "fused_attention_residual_bwd_long_bare": PALLAS + "723",
    "fused_attention_residual_bwd_long_dw": PALLAS + "723",
    "fused_attention_residual_bwd_long_dw_bare": PALLAS + "723",
    "block_diag_attention_long": PALLAS + "175",
    "fused_attention_residual_s86_reg": PALLAS + "311",
    "fused_attention_residual_s86_proj_reg": PALLAS + "311",
    "fused_attention_residual_bwd_s86_reg": PALLAS + "723",
    "fused_attention_residual_bwd_s86_reg_dw": PALLAS + "723",
    "fused_attention_residual_f32": PALLAS + "311",
    "fused_attention_residual_f32_bare": PALLAS + "311",
    "fused_mlp_residual_f32": PALLAS + "1306",
    "fused_mlp_residual_z_f32": PALLAS + "1350",
    "fused_attention_residual_bwd_f32": PALLAS + "723",
    "fused_attention_residual_bwd_f32_bare": PALLAS + "723",
    "mlp_dz_f32": PALLAS + "1727",
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
# launches per 3- and 4-scale serving forward (phase 8; 12 ScaleBlocks at
# S=22 or S=86, 12 PatchBlocks at S=50), bf16 and int8; every other form
# none
SCALES_SERVE = {
    (3, "bf16"): {"fused_attention_residual": 12,
                  "fused_attention_residual_bare": 12,
                  "fused_mlp_residual": 12},
    (4, "bf16"): {"fused_attention_residual_s86": 12,
                  "fused_attention_residual_s86_proj": 12,
                  "fused_attention_residual_bare": 12,
                  "fused_mlp_residual": 12},
    (3, "int8"): {"fused_attention_residual_int8": 12,
                  "fused_attention_residual_int8_bare": 12,
                  "fused_mlp_residual_int8": 12},
    (4, "int8"): {"fused_attention_residual_int8_s86": 12,
                  "fused_attention_residual_int8_s86_proj": 12,
                  "fused_attention_residual_int8_bare": 12,
                  "fused_mlp_residual_int8": 12},
}
# phase 9's depth: 4, not 12, so that the script stays well inside its
# time limit (its forms and shapes are the depth-12 step's, a block at a
# time; phase 12 trains R4r at depth 12 on the same 86-token forms)
SCALES_TRAIN_DEPTH = 4
# launches per 3- and 4-scale training step at depth 12 (phase 9 scales
# them to SCALES_TRAIN_DEPTH; 12 ScaleBlocks at S=22 or S=86, 12
# PatchBlocks at S=50; the 4-scale model's fc_norm through the LayerNorm
# kernel); every other form none
SCALES_TRAIN = {
    "3-scale default": {"fused_attention_residual": 12,
                        "fused_attention_residual_bare": 12,
                        "fused_mlp_residual_z": 12,
                        "fused_attention_residual_bwd": 12,
                        "fused_attention_residual_bwd_bare": 12,
                        "mlp_dz": 12},
    "4-scale lean": {"fused_attention_residual_s86": 12,
                     "fused_attention_residual_s86_proj": 12,
                     "fused_attention_residual_bare": 12,
                     "fused_mlp_residual": 12, "fused_layernorm": 1,
                     "fused_attention_residual_bwd_s86_dw": 12,
                     "fused_attention_residual_bwd_dw_bare": 12,
                     "fused_mlp_bwd": 12},
    "4-scale default": {"fused_attention_residual_s86": 12,
                        "fused_attention_residual_s86_proj": 12,
                        "fused_attention_residual_bare": 12,
                        "fused_mlp_residual_z": 12, "fused_layernorm": 1,
                        "fused_attention_residual_bwd_s86": 12,
                        "fused_attention_residual_bwd_bare": 12,
                        "mlp_dz": 12},
}
# launches per ViT-B/16 serving forward and per training step (phase 10:
# 12 blocks at S=197, the attention forward in two wrapper calls, the
# long-segment chain and the proj); every other form none
VIT_SERVE = {"fused_attention_residual_long": 12,
             "fused_attention_residual_s86_proj": 12,
             "fused_mlp_residual": 12}
VIT_TRAIN = {
    "default": {"fused_attention_residual_long": 12,
                "fused_attention_residual_s86_proj": 12,
                "fused_mlp_residual_z": 12,
                "fused_attention_residual_bwd_long": 12, "mlp_dz": 12},
    "lean": {"fused_attention_residual_long": 12,
             "fused_attention_residual_s86_proj": 12,
             "fused_mlp_residual": 12, "fused_layernorm": 1,
             "fused_attention_residual_bwd_long_dw": 12,
             "fused_mlp_bwd": 12},
}
# the hybrid baselines (phase 11): R50ViT's ViT-S at 384 wide, 6 heads, 50
# tokens (7x7 grid + CLS); its forms are counted under name + "_c384"
# (ops/_build.count_launch); ViTPretrained runs VIT_SERVE / VIT_TRAIN
C384, HEADS384, S_H1, HIDDEN384 = 384, 6, 50, 1536
C384_FORMS = ("fused_attention_residual", "fused_mlp_residual",
              "fused_mlp_residual_z", "fused_attention_residual_bwd",
              "fused_attention_residual_bwd_dw", "mlp_dz", "fused_mlp_bwd",
              "fused_layernorm")
for _form in C384_FORMS:
    SOURCES[_form + "_c384"] = SOURCES[_form]
    REPLACES[_form + "_c384"] = REPLACES[_form]
H1_SERVE = {"fused_attention_residual_c384": 12,
            "fused_mlp_residual_c384": 12}
H1_TRAIN = {
    "default": {"fused_attention_residual_c384": 12,
                "fused_mlp_residual_z_c384": 12,
                "fused_attention_residual_bwd_c384": 12, "mlp_dz_c384": 12},
    "lean": {"fused_attention_residual_c384": 12,
             "fused_mlp_residual_c384": 12, "fused_layernorm_c384": 1,
             "fused_attention_residual_bwd_dw_c384": 12,
             "fused_mlp_bwd_c384": 12},
}
# the regularised release DuoFormer (phase 12): R4r, the 4-scale model with
# the legacy preset's regularisation (config.py:185-187), its 12 ScaleBlocks
# on the 86-token reg forms (the core with the attention dropout in
# training, the proj with gamma: Q9 leaves its dropout at 0), its 12
# PatchBlocks with their q/k norms applied off the kernels (plain PyTorch,
# the JAX package's XLA route); R3r the same at 3 scales (S=22, the S<=64
# reg forms), depth 2 here
R_REG = dict(init_values=1e-5, attn_drop_rate=DROP, proj_drop_rate=DROP)
# float32 (phase 13): the forms each block of a float32 serving forward
# and of a float32 training step (default routes) launches once; every
# other form none. R3f runs at depth F32_R3_DEPTH.
F32_SERVE = ("fused_attention_residual_f32",
             "fused_attention_residual_f32_bare", "fused_mlp_residual_f32")
F32_TRAIN = ("fused_attention_residual_f32",
             "fused_attention_residual_f32_bare", "fused_mlp_residual_z_f32",
             "fused_attention_residual_bwd_f32",
             "fused_attention_residual_bwd_f32_bare", "mlp_dz_f32")
F32_R3_DEPTH = 2
# the card's float32 path against the port's CPU float32 run on 2 tiles
F32_EMBED_REL_TOL = 2e-4
F32_GRAD_REL_TOL = 1e-3
R3R_DEPTH = 2
R4R_SERVE = {"fused_attention_residual_s86": 12,
             "fused_attention_residual_s86_proj_reg": 12,
             "fused_mlp_residual_reg": 12}
R4R_TRAIN = {
    "default": {"fused_attention_residual_s86_reg": 12,
                "fused_attention_residual_s86_proj_reg": 12,
                "fused_mlp_residual_reg_z": 12,
                "fused_attention_residual_bwd_s86_reg": 12,
                "drop_ew_hd": 12, "drop_ew_dz": 12, "drop_ew_gm": 12},
    "lean": {"fused_attention_residual_s86_reg": 12,
             "fused_attention_residual_s86_proj_reg": 12,
             "fused_mlp_residual_reg": 12,
             "fused_attention_residual_bwd_s86_reg_dw": 12,
             "drop_ew_hd": 12, "drop_ew_dz": 12, "drop_ew_gm": 12},
}
R3R_TRAIN = {"fused_attention_residual_reg": R3R_DEPTH,
             "fused_mlp_residual_reg_z": R3R_DEPTH,
             "fused_attention_residual_bwd_reg": R3R_DEPTH,
             "drop_ew_hd": R3R_DEPTH, "drop_ew_dz": R3R_DEPTH,
             "drop_ew_gm": R3R_DEPTH}
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


def bound(flops, nbytes, int8_ops=0, f32=False):
    """The least time for the work: bf16 flops (float32 flops with f32, at
    PEAK_F32_FLOPS) and int8 operations at their peaks (one after the
    other: they share the tensor cores) against the bytes at the memory
    rate. -> (ms, what bounds it)."""
    t_ops = (flops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
             + int8_ops / PEAK_INT8_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def compare(torch, out, ref, residual, n_summed=1, scale=1.0, f32=False):
    """out (kernel, bf16) against ref (plain, float32): max |out - ref|, the
    relative L2 error of the branch ref - residual, and both bars. A column
    sum over n_summed rows is held at atol = 0.08 * sqrt(n_summed): each
    row's term carries its own bf16 rounding, and n independent errors
    add up to sqrt(n) times one. scale: a reg form's largest factor on
    the branch (max gamma / (1 - rate)), by which its rounding errors grow
    with the values they round; atol is multiplied by it. f32: a float32
    form, held at F32_TOL and F32_REL_TOL instead."""
    torch.cuda.synchronize()
    tol, rel_tol = (F32_TOL, F32_REL_TOL) if f32 else (TOL, BRANCH_REL_TOL)
    out = out.float()
    branch = ref if residual is None else ref - residual.float()
    rel = ((out - ref).norm() / branch.norm().clamp_min(1e-30)).item()
    close = bool(torch.allclose(out, ref, rtol=tol,
                                atol=tol * n_summed ** 0.5 * scale))
    return dict(max_abs_err=(out - ref).abs().max().item(), rel_err=rel,
                branch_rms=branch.pow(2).mean().sqrt().item(), close=close,
                ok=close and rel <= rel_tol, tol=tol, rel_tol=rel_tol)


def compare_all(torch, outputs, scale=1.0, f32=False):
    """{output: (kernel, plain, residual[, n_summed])} -> the worst of
    each output's compare(), with every output's own result under "outputs";
    the case passes when every output passes both bars."""
    each = {k: compare(torch, *v, scale=scale, f32=f32)
            for k, v in outputs.items()}
    return dict(max_abs_err=max(r["max_abs_err"] for r in each.values()),
                rel_err=max(r["rel_err"] for r in each.values()),
                branch_rms=min(r["branch_rms"] for r in each.values()),
                close=all(r["close"] for r in each.values()),
                ok=all(r["ok"] for r in each.values()), outputs=each,
                tol=F32_TOL if f32 else TOL,
                rel_tol=F32_REL_TOL if f32 else BRANCH_REL_TOL)


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


def plain_repeats(S, reg):
    """Timed launches of a case's plain version: PLAIN_REPEATS for a reg
    form past 64 tokens (its masks are hashed in int64 tensors of n_seg *
    heads * S^2 elements, seconds a call at 3136 segments), else
    REPEATS."""
    return PLAIN_REPEATS if reg is not None and S > 64 else REPEATS


def reg_scale(flags):
    """The largest factor a reg form's flags put on its branch: max gamma
    over the keep probability of its highest rate (1 for an inert form)."""
    if "gamma" not in flags:
        return 1.0
    rate = max([v for k, v in flags.items() if k.endswith("drop")] + [0.0])
    return flags["gamma"].max().item() / (1.0 - rate)


def attention_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                   reg=None, dtype=None, repeat=False):
    """The attention kernel; reg: the reg form's flags (gamma, attn_drop,
    proj_drop; see reg_flags); dtype float32: its float32 form (else
    bf16); repeat: a second launch must give the same bits."""
    dev, dt = "cuda", dtype or torch.bfloat16
    f32 = dt == torch.float32

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, dt)
    if bare:
        lns = torch.zeros(c, device=dev)
        lnb = torch.zeros(c, device=dev)
    else:
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5).to(dev, dt)
    bqkv = rnd(3 * c, std=0.01).cuda()
    wproj = rnd(c, c, std=c ** -0.5).to(dev, dt)
    bproj = rnd(c, std=0.01).cuda()
    scale = (c // heads) ** -0.5
    flags = dict(use_ln=not bare, use_residual=not bare,
                 **reg_flags(torch, gen, c, reg))

    def kernel():
        return fa.fused_attention_residual(x, lns, lnb, wqkv, bqkv, wproj,
                                           bproj, heads, S, scale, **flags)

    up = [t.float() for t in (x, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_plain(
            up[0], lns, lnb, up[1], bqkv, up[2], bproj, heads, S, scale,
            **flags)

    out = kernel()
    res = compare(torch, out, plain(), None if bare else x,
                  scale=reg_scale(flags), f32=f32)
    if repeat:
        check_repeat(torch, res, out, kernel)
    if not timed:
        return res
    wqkv_t, wproj_t = wqkv.t().contiguous(), wproj.t().contiguous()
    bqkv_b, bproj_b = bqkv.to(dt), bproj.to(dt)
    lns_b, lnb_b = lns.to(dt), lnb.to(dt)
    D = c // heads
    a_drop, p_drop = flags.get("attn_drop", 0.0), flags.get("proj_drop", 0.0)
    gamma_b = flags["gamma"].to(dt) if reg is not None else None

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
    nbytes = (x.element_size() * (2 * rows * c + 4 * c * c)
              + 4 * (2 * c + 4 * c) + (4 * c if reg is not None else 0))
    bound_ms, bound_by = bound(flops, nbytes, f32=f32)
    res.update(ms=median_ms(kernel, torch),
               plain_ms=median_ms(plain, torch, plain_repeats(S, reg)),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_case(torch, F, fa, gen, rows, c, hidden, timed, z_form=False,
             reg=None, dtype=None):
    """The MLP kernel: the branch (out less x); the z form also z. reg:
    the reg form's flags (gamma, drop; see reg_flags); dtype float32: its
    float32 form (else bf16)."""
    dev, dt = "cuda", dtype or torch.bfloat16
    f32 = dt == torch.float32

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(rows, c).to(dev, dt)
    lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    w1 = rnd(c, hidden, std=c ** -0.5).to(dev, dt)
    b1 = rnd(hidden, std=0.01).cuda()
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, dt)
    b2 = rnd(c, std=0.01).cuda()
    flags = reg_flags(torch, gen, c, reg)

    def kernel():
        return fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2,
                                     return_hidden=z_form, **flags)

    up = [t.float() for t in (x, w1, w2)]

    def plain():
        return fa.fused_mlp_residual_plain(up[0], lns, lnb, up[1], b1,
                                           up[2], b2, return_hidden=z_form,
                                           **flags)

    if z_form:
        (out, z), (ref, zref) = kernel(), plain()
        res = compare_all(torch, {"out": (out, ref, x), "z": (z, zref, None)},
                          scale=reg_scale(flags), f32=f32)
    else:
        res = compare(torch, kernel(), plain(), x, scale=reg_scale(flags),
                      f32=f32)
    if not timed:
        return res
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
    b1_b, b2_b, lns_b, lnb_b = (t.to(dt) for t in (b1, b2, lns, lnb))
    drop = flags.get("drop", 0.0)
    gamma_b = flags["gamma"].to(dt) if reg is not None else None

    def library():
        zz = F.linear(F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6), w1_t, b1_b)
        if reg is not None:
            y = F.linear(F.dropout(F.gelu(zz), drop), w2_t, b2_b)
            y = F.dropout(y, drop) * gamma_b + x
        else:
            y = F.linear(F.gelu(zz), w2_t, b2_b) + x
        return (y, zz) if z_form else y

    flops = 4 * rows * c * hidden
    nbytes = (x.element_size() * (2 * rows * c + 2 * c * hidden
                                  + (rows * hidden if z_form else 0))
              + 4 * (3 * c + hidden) + (4 * c if reg is not None else 0))
    bound_ms, bound_by = bound(flops, nbytes, f32=f32)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_chunks_case(torch, F, fa, gen, rows, c, hidden, timed, **kw):
    """mlp_case at rows the wrapper runs in two or more chunks (its
    mlp_row_chunks); fails when they fit in one."""
    res = mlp_case(torch, F, fa, gen, rows, c, hidden, timed, **kw)
    res["chunks"] = len(fa.mlp_row_chunks(rows, c, hidden))
    res["ok"] = res["ok"] and res["chunks"] >= 2
    return res


def attention_bwd_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                       reg=None, dtype=None):
    """The attention backward kernel: dx less the residual g, ln (full
    form), attn, dqkv and the column sums, each against the plain version
    on the same bf16 inputs upcast to float32; the reg form (reg: see
    reg_flags) also gm where the proj dropout is on; dtype float32: its
    float32 form (else bf16)."""
    dev, dt = "cuda", dtype or torch.bfloat16
    f32 = dt == torch.float32

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, dt)
    g = rnd(n_seg, S, c).to(dev, dt)
    if bare:
        lns = torch.zeros(c, device=dev)
        lnb = torch.zeros(c, device=dev)
    else:
        lns, lnb = rnd(c, std=0.1, mean=1.0).cuda(), rnd(c, std=0.1).cuda()
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5).to(dev, dt)
    bqkv = rnd(3 * c, std=0.01).cuda()
    wproj = rnd(c, c, std=c ** -0.5).to(dev, dt)
    bproj = rnd(c, std=0.01).cuda()
    scale = (c // heads) ** -0.5
    flags = dict(use_ln=not bare, use_residual=not bare,
                 **reg_flags(torch, gen, c, reg))

    def kernel():
        return fa.fused_attention_residual_bwd(x, g, lns, lnb, wqkv, bqkv,
                                               wproj, heads, S, scale,
                                               **flags)

    up = [t.float() for t in (x, g, wqkv, wproj)]

    def plain():
        return fa.fused_attention_residual_bwd_plain(
            up[0], up[1], lns, lnb, up[2], bqkv, up[3], heads, S, scale,
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
    res = compare_all(torch, pairs, scale=reg_scale(flags), f32=f32)
    if not timed:
        return res
    D = c // heads
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        x, lns.to(dt), lnb.to(dt), wqkv.t().contiguous(), bqkv.to(dt),
        wproj.t().contiguous(), bproj.to(dt))]
    if reg is not None:
        leaves.append(flags["gamma"].to(dt).requires_grad_(True))
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
    nbytes = (x.element_size() * (rows * c * (3 + (0 if bare else 1) + 1 + 3
                                              + (1 if p_drop else 0))
                                  + 4 * c * c)
              + 4 * (2 * c + 3 * c + 6 * c + (c if reg is not None else 0)))
    bound_ms, bound_by = bound(flops, nbytes, f32=f32)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_dz_case(torch, F, fa, gen, rows, c, hidden, timed, dtype=None,
                repeat=False):
    """The dz kernel: dz and db1; dtype float32: its float32 form (else
    bf16); repeat: a second launch must give the same bits of both."""
    dev, dt = "cuda", dtype or torch.bfloat16
    f32 = dt == torch.float32

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    g = rnd(rows, c).to(dev, dt)
    z = rnd(rows, hidden).to(dev, dt)
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(dev, dt)

    def kernel():
        return fa.mlp_dz(g, z, w2)

    up = [t.float() for t in (g, z, w2)]

    def plain():
        return fa.mlp_dz_plain(*up)

    (dz, db1), (dzr, db1r) = kernel(), plain()
    res = compare_all(torch, {"dz": (dz, dzr, None),
                              "db1": (db1, db1r, None, rows)}, f32=f32)
    if repeat:
        dz2, db12 = kernel()
        same = bool(torch.equal(dz, dz2) and torch.equal(db1, db12))
        res.update(repeat_identical=same, ok=res["ok"] and same)
    if not timed:
        return res
    w2_t = w2.t()

    def library():
        d = torch.ops.aten.gelu_backward(torch.matmul(g, w2_t), z)
        return d, d.float().sum(0)

    flops = 2 * rows * c * hidden
    nbytes = (g.element_size() * (rows * c + 2 * rows * hidden + hidden * c)
              + 4 * hidden)
    bound_ms, bound_by = bound(flops, nbytes, f32=f32)
    res.update(ms=median_ms(kernel, torch), plain_ms=median_ms(plain, torch),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def tf32_split_case(torch, F, fa, gen, k, n, timed):
    """The float32 attention forward's weight split (its C entry's first
    launch, alone: fa.tf32_split_weight) against tf32_split_plain, bit for
    bit: a weight [k, n] at the path's scale with a tenth of its entries
    tiny (1e-30 times), negated, exact ties of the rounding (low 13 bits
    0x1000), zeros of both signs, 3e38 and the least normal."""
    w = torch.randn(k, n, generator=gen) * k ** -0.5
    flat = w.view(-1)
    m = flat.numel()
    pick = torch.randperm(m, generator=gen)
    tenth = m // 10
    flat[pick[:tenth]] *= 1e-30
    flat[pick[tenth:2 * tenth]] *= -1.0
    ties = pick[2 * tenth:3 * tenth]
    flat[ties] = ((flat[ties].view(torch.int32) & -0x2000) | 0x1000).view(
        torch.float32)
    flat[pick[3 * tenth:3 * tenth + 4]] = torch.tensor(
        [0.0, -0.0, 3.0e38, -1.1754943508222875e-38])
    w = w.cuda()
    hi, lo = fa.tf32_split_weight(w)
    rh, rl = fa.tf32_split_plain(w.t().contiguous())
    torch.cuda.synchronize()
    bits = [t.view(torch.int32) for t in (hi, lo, rh, rl)]
    same = bool(torch.equal(bits[0], bits[2]) and torch.equal(bits[1], bits[3]))
    diff = torch.maximum((hi - rh).abs().max(), (lo - rl).abs().max())
    return dict(ok=same, close=same, rel_err=0.0 if same else float("inf"),
                max_abs_err=diff.item(), branch_rms=w.pow(2).mean().sqrt()
                .item(), bits_identical=same,
                hi_low_bits_zero=bool((bits[0] & 0x1FFF).eq(0).all()))


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


def mlp_bwd_case(torch, F, fa, gen, rows, c, hidden, timed, repeat=False):
    """The recompute-from-x MLP backward kernel: dx less the residual g,
    ln, h, dz and the column sums dlns, dlnb; with repeat, also a second
    launch on the same inputs bit for bit in every output (the sums are
    taken in a fixed order, without atomics)."""
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
    if repeat:
        res["bit_identical"] = all(torch.equal(a, b)
                                   for a, b in zip(out, kernel()))
        res["ok"] = res["ok"] and res["bit_identical"]
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


def mlp_bwd_chunks_case(torch, F, fa, gen, rows, c, hidden, timed,
                        chunk_rows):
    """mlp_bwd_case with a second launch bit for bit, its wrapper's scratch
    bound cut to the scratch of chunk_rows rows, so that its planner
    (fa.mlp_bwd_row_chunks, read by a spy) takes the call in at least three
    chunks, the last one ragged: fails when it took fewer or equal ones."""
    plan, bound_was, used = (fa.mlp_bwd_row_chunks, fa.MLP_BWD_SCRATCH_BYTES,
                             [])

    def spy(*a, **kw):
        used.append(plan(*a, **kw))
        return used[-1]

    fa.mlp_bwd_row_chunks = spy
    fa.MLP_BWD_SCRATCH_BYTES = fa.mlp_bwd_scratch_bytes(chunk_rows, c)
    try:
        res = mlp_bwd_case(torch, F, fa, gen, rows, c, hidden, timed,
                           repeat=True)
    finally:
        fa.mlp_bwd_row_chunks, fa.MLP_BWD_SCRATCH_BYTES = plan, bound_was
    chunks = used[0] if used else []
    res.update(chunks=len(chunks), ok=res["ok"] and len(chunks) >= 3
               and chunks[-1][1] < chunks[0][1])
    return res


def attention_bwd_chunks_case(torch, F, fa, gen, n_seg, S, c, heads, bare,
                               timed, chunk_segs, dw=False, reg=None):
    """attention_bwd_big_case (dw, reg) with its wrapper's scratch bound cut
    to the scratch of chunk_segs segments, so that its planner
    (fa.attention_bwd_seg_chunks, read by a spy) takes the call in at least
    three chunks of segments, the last one ragged: fails when it took fewer
    or equal ones. With the reg flags the masks of every chunk but the
    first count from a global token past 0."""
    plan, bound_was, used = (fa.attention_bwd_seg_chunks,
                             fa.ATTN_BWD_SCRATCH_BYTES, [])

    def spy(*a, **kw):
        used.append(plan(*a, **kw))
        return used[-1]

    fa.attention_bwd_seg_chunks = spy
    fa.ATTN_BWD_SCRATCH_BYTES = fa.attention_bwd_scratch_bytes(
        chunk_segs, S, c, dw, not bare, reg is not None,
        dw and bool(reg and reg.get("proj_drop")))
    try:
        res = attention_bwd_big_case(torch, F, fa, gen, n_seg, S, c, heads,
                                     bare, timed, dw=dw, reg=reg)
    finally:
        fa.attention_bwd_seg_chunks, fa.ATTN_BWD_SCRATCH_BYTES = (plan,
                                                                  bound_was)
    chunks = used[0] if used else []
    res.update(chunks=len(chunks), ok=res["ok"] and len(chunks) >= 3
               and chunks[-1][1] < chunks[0][1])
    return res


def attention_bwd_repeat_case(torch, F, fa, gen, n_seg, S, c, heads, bare,
                              timed):
    """The attention backward's dw form launched twice on the same inputs
    (drawn on the card): every output, dwqkv and dwA included, bit for bit
    the same and finite (no atomics: chunks, tiles and partial rows summed
    in a fixed order). Its values are held by the other cases."""
    dev, bf16 = "cuda", torch.bfloat16
    cg = torch.Generator(device=dev).manual_seed(
        int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen)))

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=cg, device=dev) * std + mean

    x, g = rnd(n_seg, S, c).to(bf16), rnd(n_seg, S, c).to(bf16)
    lns, lnb = ((torch.zeros(c, device=dev),) * 2 if bare else
                (rnd(c, std=0.1, mean=1.0), rnd(c, std=0.1)))
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5).to(bf16)
    bqkv = rnd(3 * c, std=0.01)
    wproj = rnd(c, c, std=c ** -0.5).to(bf16)
    args = (x, g, lns, lnb, wqkv, bqkv, wproj, heads, S, (c // heads) ** -0.5)
    kw = dict(use_ln=not bare, use_residual=not bare, dw=True)
    first = fa.fused_attention_residual_bwd(*args, **kw)
    again = fa.fused_attention_residual_bwd(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    finite = all(bool(torch.isfinite(a).all()) for a in first)
    return dict(ok=same and finite, repeat_identical=same, finite=finite,
                rel_err=0.0, max_abs_err=0.0, close=same,
                branch_rms=first[0].float().pow(2).mean().sqrt().item())


def attention_bwd_dw_case(torch, F, fa, gen, n_seg, S, c, heads, bare,
                          timed, reg=None):
    """The attention backward kernel's dw form: dx (less the residual g),
    the column sums, dwqkv and dwA against the plain version; dwqkv and
    dwA also against the dw=False kernel's row-space outputs multiplied
    with torch.matmul (relative L2 <= BRANCH_REL_TOL); and a second launch
    on the same inputs bit for bit, dwqkv and dwA included (summed over
    chunks in a fixed order, no atomics)."""
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
    same = all(torch.equal(a, b) for a, b in zip(again, out))
    res.update(vs_dw_false=max(vs), repeat_identical=same,
               ok=res["ok"] and max(vs) <= BRANCH_REL_TOL and same)
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


def chunked_compare(torch, outs, plain_part, units, unit_rows, residuals,
                    chunk, scale=1.0):
    """compare_all() of kernel outputs whose plain version is run over
    chunks of `units` (segments or rows; the plain versions' float32
    intermediates over a whole 4-scale step's rows would hold tens of GB):
    outs {name: kernel output}, each either row-space ([units * unit_rows,
    ...] in any shape) or summed over the rows (a column sum or a weight
    gradient, which must be 2 or more dimensions only for the latter);
    plain_part(lo, hi) -> {name: the plain version's output on units lo:hi
    (float32)}; residuals {name: the residual a row-space output carries}.
    Row-space outputs are held chunk by chunk (the relative L2 error from
    the chunks' sums of squares), the summed ones once, at atol = 0.08 *
    sqrt(rows); scale: a reg form's reg_scale, by which atol grows (as in
    compare)."""
    rows = units * unit_rows
    acc = {k: dict(d2=0.0, b2=0.0, mx=0.0, close=True, n=0) for k in outs}
    sums = {}
    for lo in range(0, units, chunk):
        hi = min(units, lo + chunk)
        ref = plain_part(lo, hi)
        r0, r1 = lo * unit_rows, hi * unit_rows
        for k, o in outs.items():
            if k not in ROW_OUTPUTS:
                r = ref[k].float()
                sums[k] = r if k not in sums else sums[k] + r
                continue
            oc = o.reshape(rows, -1)[r0:r1].float()
            rc = ref[k].reshape(r1 - r0, -1).float()
            res = residuals.get(k)
            br = rc if res is None else rc - res.reshape(rows, -1)[r0:r1].float()
            a = acc[k]
            a["d2"] += (oc - rc).double().pow(2).sum().item()
            a["b2"] += br.double().pow(2).sum().item()
            a["mx"] = max(a["mx"], (oc - rc).abs().max().item())
            a["close"] &= bool(torch.allclose(oc, rc, rtol=TOL,
                                              atol=TOL * scale))
            a["n"] += br.numel()
            del oc, rc, br
        del ref
    each = {}
    for k, o in outs.items():
        if k not in ROW_OUTPUTS:
            each[k] = compare(torch, o, sums[k], None, n_summed=rows,
                              scale=scale)
            continue
        a = acc[k]
        rel = (a["d2"] / max(a["b2"], 1e-300)) ** 0.5
        each[k] = dict(max_abs_err=a["mx"], rel_err=rel,
                       branch_rms=(a["b2"] / max(a["n"], 1)) ** 0.5,
                       close=a["close"], ok=a["close"] and rel <= BRANCH_REL_TOL)
    return dict(max_abs_err=max(r["max_abs_err"] for r in each.values()),
                rel_err=max(r["rel_err"] for r in each.values()),
                branch_rms=min(r["branch_rms"] for r in each.values()),
                close=all(r["close"] for r in each.values()),
                ok=all(r["ok"] for r in each.values()), outputs=each)


# the outputs chunked_compare holds row by row; every other one is summed
# over the rows
ROW_OUTPUTS = ("dx", "ln", "attn", "dqkv", "dq", "dk", "dv", "out", "z",
               "dz", "h", "gm")
BWD_NAMES = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj",
             "gm")
BWD_DW_NAMES = ("dx", "dlns", "dlnb", "dbqkv", "dbproj", "dwqkv", "dwA")


def attention_bwd_big_case(torch, F, fa, gen, n_seg, S, c, heads, bare,
                           timed, dw=False, twin=False, upcast_bars=False,
                           reg=None, split_qkv=False, nan_tail=False):
    """The attention backward, dw=False or the dw form, at a 3- or 4-scale
    training step's size (the 65..86-token chain, or the S<=64 kernel at
    S=22), each plain version run over chunks of PLAIN_CHUNK_SEGS segments:
    every output against the plain version on the same bf16 inputs, which
    rounds where the kernels round, at the bars of attention_bwd_case
    (atol = rtol = 0.08, sums at 0.08 * sqrt(n), relative L2 1e-2); and
    against the plain version on the inputs upcast to float32 at the
    relative L2 bar (the rounding points' own error). Not held there: the
    elementwise bar, which that error alone passes at 1e8 elements and
    more (a CPU run of the bf16 plain version against the float32 one,
    with no kernel, reaches 0.88 of it on 6.5e6 elements of dx). A second
    launch bit-identical, the dw form's dwqkv and dwA included; its dwqkv and
    dwA also within 1e-2 relative L2 of the dw=False kernel's row-space
    outputs multiplied with torch.matmul. twin: dqkv (dw: dwqkv) against
    the bf16-input plain version also at ROUND_REL_TOL (a rounding point
    moved shows there, below the bf16 bars). upcast_bars: where the
    largest row-space output has fewer than UPCAST_BARS_MAX elements,
    every bar against the float32-input plain version too. reg (65..86
    tokens; see reg_flags): the reg form, its atol scaled by reg_scale;
    with the proj dropout dw=False also holds gm, and the dw form's dwA
    is held against attn^T gm of the dw=False route. split_qkv (dw=False):
    dq, dk and dv each held alone in place of dqkv (a wrong operand of one
    product shows there even where the other two dilute it). nan_tail: x
    and g are the first n_seg segments of tensors whose next two are NaN
    (a kernel reading past its rows turns its outputs NaN, which fail every
    bar). Records the device memory the call held beyond dx, the column
    sums and the weight gradients (dw=False: ln, attn, dqkv, gm and any
    scratch; dw: the scratch, the reg form's geff and gm included)."""
    dev, bf16 = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen) * std + mean

    x = rnd(n_seg, S, c).to(dev, bf16)
    g = rnd(n_seg, S, c).to(dev, bf16)
    if nan_tail:
        tails = []
        for t in (x, g):
            tails.append(torch.full((n_seg + 2, S, c), float("nan"),
                                    dtype=bf16, device=dev))
            tails[-1][:n_seg] = t
        x, g = (t[:n_seg] for t in tails)
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
    names = BWD_DW_NAMES if dw else BWD_NAMES
    rows = n_seg * S
    p_drop = flags.get("proj_drop", 0.0)
    rscale = reg_scale(flags)

    def kernel():
        return fa.fused_attention_residual_bwd(*args, dw=dw, **flags)

    def split(d):
        if split_qkv:
            dqkv = d.pop("dqkv")
            d.update(dq=dqkv[:, :c], dk=dqkv[:, c:2 * c], dv=dqkv[:, 2 * c:])
        return d

    def plain_part(lo, hi, bf=False):
        xs, gs, wq, wp = (t if bf else t.float()
                          for t in (x[lo:hi], g[lo:hi], wqkv, wproj))
        return split(dict(zip(names, fa.fused_attention_residual_bwd_plain(
            xs, gs, lns, lnb, wq, bqkv, wp, heads, S, scale, dw=dw,
            seg0=lo, **flags))))

    def plain():
        return [plain_part(lo, min(n_seg, lo + PLAIN_CHUNK_SEGS))
                for lo in range(0, n_seg, PLAIN_CHUNK_SEGS)]

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = kernel()
    torch.cuda.synchronize()
    held = 2 * x.numel() + 4 * 6 * c + (4 * 4 * c * c if dw else 0)
    extra = torch.cuda.max_memory_allocated() - before - held
    outs = split({k: o for k, o in zip(names, out)
                  if not (bare and k in ("ln", "dlns", "dlnb"))})
    residuals = {} if bare else {"dx": g}
    res = chunked_compare(torch, outs, functools.partial(plain_part, bf=True),
                          n_seg, S, residuals, PLAIN_CHUNK_SEGS, rscale)
    f32 = chunked_compare(torch, outs, plain_part, n_seg, S, residuals,
                          PLAIN_CHUNK_SEGS, rscale)
    again = kernel()
    same = all(torch.equal(a, b) for a, b in zip(again, out))
    del again
    upcast = upcast_bars and rows * 3 * c < UPCAST_BARS_MAX
    res.update(extra_bytes=extra, repeat_identical=same,
               f32_rel_err=f32["rel_err"], f32_max_abs_err=f32["max_abs_err"],
               f32_close=f32["close"], f32_bars_held=upcast,
               ok=res["ok"] and same and f32["rel_err"] <= BRANCH_REL_TOL
               and (f32["ok"] or not upcast))
    if twin:
        key = "dwqkv" if dw else "dqkv"
        res["vs_twin"] = res["outputs"][key]["rel_err"]
        res["ok"] = res["ok"] and res["vs_twin"] <= ROUND_REL_TOL
    if dw:
        rs = fa.fused_attention_residual_bwd(*args, **flags)
        route = (fa._mm_f32(rs[1].t(), rs[3]),
                 fa._mm_f32(rs[2].t(), rs[8] if p_drop else g.view(rows, c)))
        vs = max(rel_err(a, b) for a, b in zip(out[5:], route))
        res.update(vs_dw_false=vs, ok=res["ok"] and vs <= BRANCH_REL_TOL)
        del rs, route
    del out
    if not timed:
        return res
    D = c // heads
    a_drop = flags.get("attn_drop", 0.0)
    if dw:
        def library():
            r = fa.fused_attention_residual_bwd(*args, **flags)
            return (torch.matmul(r[1].t(), r[3]),
                    torch.matmul(r[2].t(), r[8] if p_drop
                                 else g.view(rows, c)))
    else:
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            x, lns.to(bf16), lnb.to(bf16), wqkv.t().contiguous(),
            bqkv.to(bf16), wproj.t().contiguous())]
        if reg is not None:
            leaves.append(flags["gamma"].to(bf16).requires_grad_(True))

        def library():
            xx, ls, lb, wq, bq, wp = leaves[:6]
            h = xx if bare else F.layer_norm(xx, (c,), ls, lb, 1e-6)
            qkv = F.linear(h, wq, bq).view(n_seg, S, 3, heads, D)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, dropout_p=a_drop,
                                               scale=scale)
            y = F.linear(o.transpose(1, 2).reshape(n_seg, S, c), wp)
            if reg is not None:
                y = F.dropout(y, p_drop) * leaves[6]
            y = y if bare else y + xx
            return torch.autograd.grad(y, leaves, g, allow_unused=bare)

    reg_vec = 4 * c if reg is not None else 0
    flops = 2 * rows * c * 7 * c + 12 * n_seg * S * S * c
    nbytes = (2 * (rows * c * (3 + (0 if bare else 1) + 1 + 3
                               + (1 if p_drop else 0)) + 4 * c * c)
              + 4 * (2 * c + 3 * c + 6 * c) + reg_vec)
    if dw:
        flops += 8 * rows * c * c
        nbytes = (2 * (3 * rows * c + 4 * c * c)
                  + 4 * (2 * c + 3 * c + 6 * c + 4 * c * c) + reg_vec)
    bound_ms, bound_by = bound(flops, nbytes)
    res.update(ms=median_ms(kernel, torch),
               plain_ms=median_ms(plain, torch, PLAIN_REPEATS),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, bytes=nbytes)
    return res


def mlp_rows_case(torch, F, fa, gen, rows, c, hidden, timed, kind):
    """One MLP kernel at a 4-scale training step's rows (539,392 at B=128:
    z, h and dz [rows, 4C] hold 1.66e9 elements, whose byte offsets pass
    2^31), held row by row against its plain version run over chunks of
    rows: kind "z" (the z form of fused_mlp_residual: the branch and z),
    "dz" (mlp_dz: dz and db1) or "bwd" (fused_mlp_bwd: dx, ln, h, dz, dlns,
    dlnb). Untimed: the main path's shapes time these kernels above."""
    dev, bf16 = "cuda", torch.bfloat16
    # drawn on the card (from a seed the case's generator draws): 1.66e9
    # numbers take the CPU tens of seconds
    cg = torch.Generator(device=dev).manual_seed(
        int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen)))

    def rnd(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=cg, device=dev) * std + mean

    x = rnd(rows, c).to(bf16)
    lns, lnb = rnd(c, std=0.1, mean=1.0), rnd(c, std=0.1)
    w1 = rnd(c, hidden, std=c ** -0.5).to(bf16)
    b1 = rnd(hidden, std=0.01)
    w2 = rnd(hidden, c, std=hidden ** -0.5).to(bf16)
    b2 = rnd(c, std=0.01)
    w1f, w2f = w1.float(), w2.float()
    if kind == "z":
        names, residuals = ("out", "z"), {"out": x}
        out = fa.fused_mlp_residual(x, lns, lnb, w1, b1, w2, b2,
                                    return_hidden=True)

        def plain_part(lo, hi):
            return dict(zip(names, fa.fused_mlp_residual_plain(
                x[lo:hi].float(), lns, lnb, w1f, b1, w2f, b2,
                return_hidden=True)))
    elif kind == "dz":
        names, residuals = ("dz", "db1"), {}
        z = rnd(rows, hidden).to(bf16)
        out = fa.mlp_dz(x, z, w2)

        def plain_part(lo, hi):
            return dict(zip(names, fa.mlp_dz_plain(
                x[lo:hi].float(), z[lo:hi].float(), w2f)))
    else:
        names = ("dx", "ln", "h", "dz", "dlns", "dlnb")
        g = rnd(rows, c).to(bf16)
        residuals = {"dx": g}
        out = fa.fused_mlp_bwd(x, g, lns, lnb, w1, b1, w2)

        def plain_part(lo, hi):
            return dict(zip(names, fa.fused_mlp_bwd_plain(
                x[lo:hi].float(), g[lo:hi].float(), lns, lnb, w1f, b1,
                w2f)))
    return chunked_compare(torch, dict(zip(names, out)), plain_part, rows,
                           1, residuals, -(-rows // 8))


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


def block_attention_case(torch, F, fa, gen, n_seg, S, c, heads, timed,
                         qkv_std=1.5, nan_tail=False):
    """The block-diagonal attention kernel against its plain version; q, k,
    v drawn with qkv_std, so that the scores spread about qkv_std^2
    units. From UPCAST_BARS_MAX output elements, every bar against the
    plain version on the same bf16 inputs (which rounds where the kernel
    rounds) and the relative L2 bar against the float32-input one, as
    attention_bwd_big_case holds the backward at that size. nan_tail: qkv
    is the first n_seg segments of a tensor whose next two are NaN (a
    kernel reading past its rows, even as masked keys, turns NaN); the
    output must be finite, and the core, launched into the first n_seg
    segments of a buffer whose next two hold a sentinel, must leave
    those two as they were (a kernel storing a short last unit's missing
    rows writes past its output) and write the wrapper's output."""
    dev, bf16 = "cuda", torch.bfloat16
    qkv = (torch.randn(n_seg, S, 3 * c, generator=gen) * qkv_std).to(dev,
                                                                      bf16)
    if nan_tail:
        t = torch.full((n_seg + 2, S, 3 * c), float("nan"), dtype=bf16,
                       device=dev)
        t[:n_seg] = qkv
        qkv = t[:n_seg]
    scale = (c // heads) ** -0.5

    def kernel():
        return fa.block_diag_attention_fwd(qkv, heads, S, scale)

    qf = qkv.float()

    def plain():
        return fa.block_diag_attention_plain(qf, heads, S, scale)

    if n_seg * S * c < UPCAST_BARS_MAX:
        res = compare(torch, kernel(), plain(), None)
    else:
        out = kernel()
        res = compare(torch, out, fa.block_diag_attention_plain(
            qkv, heads, S, scale).float(), None)
        f32 = compare(torch, out, plain(), None)
        res.update(f32_rel_err=f32["rel_err"],
                   f32_max_abs_err=f32["max_abs_err"], f32_close=f32["close"],
                   ok=res["ok"] and f32["rel_err"] <= BRANCH_REL_TOL)
        del out
    if nan_tail:
        out = kernel()
        finite = bool(torch.isfinite(out).all())
        guarded = torch.full((n_seg + 2, S, c), 7.0, dtype=torch.bfloat16,
                             device=dev)
        fa._block_diag_launch(qkv, guarded[:n_seg], scale)
        torch.cuda.synchronize()
        untouched = bool((guarded[n_seg:] == 7.0).all())
        same = bool(torch.equal(guarded[:n_seg], out))
        res.update(finite=finite, guard_untouched=untouched,
                   guarded_equal=same,
                   ok=res["ok"] and finite and untouched and same)
        del out, guarded
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


def check_repeat(torch, res, first, kernel):
    """A second launch on the same inputs must give the same bits."""
    same = bool(torch.equal(first, kernel()))
    res.update(repeat_identical=same, ok=res["ok"] and same)
    return res


def attention_s86_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                       what, int8=False, reg=None):
    """One launch of the 65..86-token attention branch alone: what="core"
    (o = attention(qkv([LN] x))) or "proj" (y = [x +] proj(o) on a random
    o), bf16 or int8 (at 87..197 tokens the bf16 core is the long-segment
    chain, one wrapper call), against its plain twin (bf16: on the same inputs
    upcast to float32; int8: on the same bf16 inputs and int8 weights); a
    second launch must give the same bits. reg (bf16 at 65..86 tokens; see
    reg_flags): the core takes the attention dropout, the proj gamma and
    the proj dropout."""
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
    wqkv = rnd(c, 3 * c, std=QKV_STD * c ** -0.5)
    bqkv = rnd(3 * c, std=0.01).cuda()
    wproj = rnd(c, c, std=c ** -0.5)
    bproj = rnd(c, std=0.01).cuda()
    o = rnd(n_seg, S, c).to(dev, bf16)
    scale = (c // heads) ** -0.5
    rows, D = n_seg * S, c // heads
    lns_b, lnb_b = lns.to(bf16), lnb.to(bf16)
    flags = reg_flags(torch, gen, c, reg)
    cflags = {k: v for k, v in flags.items() if k in ("seed", "attn_drop")}
    pflags = {k: v for k, v in flags.items() if k != "attn_drop"}
    if int8:
        wq, sq = _int8_weight(torch, wqkv)
        wp, sp = _int8_weight(torch, wproj)
        if what == "core":
            args = (x, lns, lnb, wq, sq, bqkv, heads, S, scale, 1e-6,
                    not bare)

            def kernel():
                return fi.attention_core_int8_s86(*args)

            def plain():
                return fi.attention_core_int8_plain(*args).float()
        else:
            args = (o, x, wp, sp, bproj, not bare)

            def kernel():
                return fi.attention_proj_int8(*args)

            def plain():
                return fi.attention_proj_int8_plain(*args).float()
    else:
        wqkv, wproj = wqkv.to(dev, bf16), wproj.to(dev, bf16)
        if what == "core":
            core = (fa.attention_core_s86 if S <= fa.ATTN_SERVE_MAX_SEG_LEN
                    else fa.attention_core_long)

            def kernel():
                return core(x, lns, lnb, wqkv, bqkv, heads, S, scale,
                            use_ln=not bare, **cflags)

            def plain():
                return fa.attention_core_plain(
                    x.float(), lns, lnb, wqkv.float(), bqkv, heads, S, scale,
                    use_ln=not bare, **cflags)
        else:
            def kernel():
                return fa.attention_proj(o, x, wproj, bproj,
                                         use_residual=not bare, **pflags)

            def plain():
                return fa.attention_proj_plain(
                    o.float(), x.float(), wproj.float(), bproj,
                    use_residual=not bare, **pflags)

    first = kernel()
    res = compare(torch, first, plain(),
                  None if bare or what == "core" else x,
                  scale=(reg_scale(pflags) if what == "proj" else
                         1.0 / (1.0 - cflags.get("attn_drop", 0.0))))
    check_repeat(torch, res, first, kernel)
    if not timed:
        return res

    def ln_in():
        return x if bare else F.layer_norm(x, (c,), lns_b, lnb_b, 1e-6)

    def sdpa(qkv):
        q, k, v = qkv.view(n_seg, S, 3, heads, D).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        return o.transpose(1, 2).reshape(n_seg, S, c)

    int8_ops = flops = 0
    if what == "core" and int8:
        wq_t = wq.t()

        def library():
            hq, hs = _rowquant_library(torch, ln_in().view(rows, c))
            return sdpa((torch._int_mm(hq, wq_t).float() * hs * sq
                         + bqkv).to(bf16))

        int8_ops, flops = 2 * rows * c * 3 * c, 4 * n_seg * S * S * c
        nbytes = 2 * 2 * rows * c + 3 * c * c + 4 * 8 * c
    elif what == "core":
        wqkv_t, bqkv_b = wqkv.t().contiguous(), bqkv.to(bf16)
        a_drop = cflags.get("attn_drop", 0.0)

        def library():
            qkv = F.linear(ln_in(), wqkv_t, bqkv_b)
            q, k, v = qkv.view(n_seg, S, 3, heads, D).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, dropout_p=a_drop,
                                               scale=scale)
            return o.transpose(1, 2).reshape(n_seg, S, c)

        flops = 2 * rows * c * 3 * c + 4 * n_seg * S * S * c
        nbytes = 2 * (2 * rows * c + 3 * c * c) + 4 * 5 * c
    elif int8:
        wp_t = wp.t()

        def library():
            oq, os_ = _rowquant_library(torch, o.view(rows, c))
            y = torch._int_mm(oq, wp_t).float() * os_ * sp + bproj
            y = y if bare else y + x.view(rows, c).float()
            return y.to(bf16)

        int8_ops = 2 * rows * c * c
        nbytes = 2 * rows * c * (2 if bare else 3) + c * c + 4 * 2 * c
    else:
        wproj_t, bproj_b = wproj.t().contiguous(), bproj.to(bf16)
        gamma_b = flags["gamma"].to(bf16) if reg is not None else None
        p_drop = pflags.get("proj_drop", 0.0)

        def library():
            y = F.linear(o, wproj_t, bproj_b)
            if reg is not None:
                y = F.dropout(y, p_drop) * gamma_b
            return y if bare else y + x

        flops = 2 * rows * c * c
        nbytes = (2 * (rows * c * (2 if bare else 3) + c * c) + 4 * c
                  + (4 * c if reg is not None else 0))
    bound_ms, bound_by = bound(flops, nbytes, int8_ops)
    res.update(ms=median_ms(kernel, torch),
               plain_ms=median_ms(plain, torch, plain_repeats(S, reg)),
               library_ms=median_ms(library, torch), bound_ms=bound_ms,
               bound_by=bound_by, flops=flops, int8_ops=int8_ops,
               bytes=nbytes)
    return res


def chunked_core_case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed,
                      case, planner="attention_seg_chunks"):
    """`case` (an attention core case, or a backward case with planner
    "attention_bwd_seg_chunks") at a shape whose call the wrapper must
    take in at least two chunks of segments, the last one ragged: fails
    when the wrapper's call took one chunk or equal ones (the chunks it
    used are read by a spy on the wrapper's planner fa.<planner>)."""
    plan, used = getattr(fa, planner), []

    def spy(*a, **kw):
        used.append(plan(*a, **kw))
        return used[-1]

    setattr(fa, planner, spy)
    try:
        res = case(torch, F, fa, gen, n_seg, S, c, heads, bare, timed)
    finally:
        setattr(fa, planner, plan)
    chunks = used[0] if used else []
    ragged = len(chunks) >= 2 and chunks[-1][1] < chunks[0][1]
    res.update(chunks=len(chunks), ok=res["ok"] and ragged)
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
    s86_core = part(attention_s86_case, what="core")
    s86_proj = part(attention_s86_case, what="proj")
    s86_core8 = part(attention_s86_case, what="core", int8=True)
    s86_proj8 = part(attention_s86_case, what="proj", int8=True)
    s86b = attention_bwd_big_case
    s86b_twin = part(attention_bwd_big_case, twin=True)
    s86dw = part(attention_bwd_big_case, dw=True)
    # the reg forms at 65..86 tokens (R4r: attention dropout 0.1 and
    # LayerScale in training, gamma alone in serving)
    s86_core_r = part(s86_core, reg=dict(gamma=False, attn_drop=DROP))
    s86_core_r_chunks = part(chunked_core_case, case=s86_core_r)
    s86_proj_g = part(s86_proj, reg={})
    s86_proj_pg = part(s86_proj, reg=dict(proj_drop=DROP))
    att_ag = part(att, reg=dict(attn_drop=DROP))
    s86b_ag = part(s86b, reg=dict(attn_drop=DROP))
    s86b_pg = part(s86b, reg=dict(proj_drop=DROP))
    s86b_all = part(s86b, reg=both)
    s86dw_ag = part(s86dw, reg=dict(attn_drop=DROP))
    s86dw_pg = part(s86dw, reg=dict(proj_drop=DROP))
    s86dw_all = part(s86dw, reg=both)
    rows_4s = B_TRAIN * 49 * 86
    bda_wide = part(bda, qkv_std=12.0)
    bda_narrow = part(bda, qkv_std=0.5)
    bda_nan = part(bda, nan_tail=True)
    # up to 64 tokens the core packs 64 // S whole segments a unit: the
    # attention dropout and gamma over two chunks of segments (3140 and
    # 3133 at S=6), the last chunk's last unit short (3 of 10 segments)
    att_ag_chunks = part(chunked_core_case, case=att_ag)
    # past one chunk of the MLP wrapper's rows at C=768 (ragged)
    rows_2c = (fa.MLP_SCRATCH_BYTES // (2 * (C + HIDDEN)) // fa.MLP_ROW_TILE
               * fa.MLP_ROW_TILE + 1001)
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
        # a ragged last row tile at the main path's width (128-row tiles)
        ("fused_mlp_residual rows=18817 (ragged)", rows_s + 1, C, HIDDEN,
         mlp, False),
        ("fused_mlp_residual_z rows=18817 (ragged)", rows_s + 1, C, HIDDEN,
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
        # the rows of two chunks of the MLP wrapper, dropout on: a chunk
        # whose masks counted from its own first row would show
        ("fused_mlp_residual_reg rows=%d (two chunks)" % rows_2c, rows_2c, C,
         HIDDEN, part(mlp_chunks_case, reg=dict(drop=DROP)), False),
        ("fused_mlp_residual_reg_z rows=%d (two chunks)" % rows_2c, rows_2c,
         C, HIDDEN, part(mlp_chunks_case, z_form=True, reg=dict(drop=DROP)),
         False),
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
        # packed units: 10, 3, 2, 64 and 1 segments a unit, short last
        # units; near-uniform scores (a key leaking from the next packed
        # segment moves them); a NaN tail and a guarded output
        ("block_diag_attention n_seg=13 S=6 on the first rows of a tensor "
         "whose later rows are NaN", 13, 6, C, HEADS, bda_nan, False),
        ("block_diag_attention n_seg=13 S=6 scores spread ~0.25", 13, 6, C,
         HEADS, bda_narrow, False),
        ("block_diag_attention n_seg=13 S=6 scores spread ~150", 13, 6, C,
         HEADS, bda_wide, False),
        ("block_diag_attention n_seg=7 S=22 scores spread ~0.25", 7, 22, C,
         HEADS, bda_narrow, False),
        ("block_diag_attention n_seg=5 S=21 C=512 H=8", 5, 21, 512, 8, bda,
         False),
        ("block_diag_attention n_seg=130 S=1 C=256 H=4", 130, 1, 256, 4, bda,
         False),
        ("block_diag_attention n_seg=3 S=64 C=512 H=8", 3, 64, 512, 8, bda,
         False),
        ("fused_attention_residual n_seg=7 S=22", 7, 22, C, HEADS, False,
         att, False),
        ("fused_attention_residual n_seg=1 S=64 C=512 H=8", 1, 64, 512, 8,
         False, att, False),
        ("fused_attention_residual_bare n_seg=5 S=21 C=512 H=8", 5, 21, 512,
         8, True, att, False),
        ("fused_attention_residual_reg all three n_seg=7 S=22", 7, 22, C,
         HEADS, False, att_r, False),
        ("fused_attention_residual_reg attention dropout + gamma over two "
         "chunks of segments, the last ragged, n_seg=6273 S=6", 6273, 6, C,
         HEADS, False, att_ag_chunks, False),
        # the 3- and 4-scale serving paths' forms (B=64): each launch of the
        # 86-token branch alone, bf16 and int8; both launches through the
        # wrappers; the S<=64 kernels at S=22; then other shapes
        ("fused_attention_residual_s86", B * 49, 86, C, HEADS, False,
         s86_core, timed),
        ("fused_attention_residual_s86_proj", B * 49, 86, C, HEADS, False,
         s86_proj, timed),
        ("fused_attention_residual_int8_s86", B * 49, 86, C, HEADS, False,
         s86_core8, timed),
        ("fused_attention_residual_int8_s86_proj", B * 49, 86, C, HEADS,
         False, s86_proj8, timed),
        ("fused_attention_residual_s86 both launches n_seg=3136 S=86",
         B * 49, 86, C, HEADS, False, att, timed),
        ("fused_attention_residual_int8_s86 both launches n_seg=3136 S=86",
         B * 49, 86, C, HEADS, False, att8, timed),
        ("fused_attention_residual n_seg=3136 S=22 (3 scales)", B * 49, 22,
         C, HEADS, False, att, timed),
        ("fused_attention_residual_int8 n_seg=3136 S=22 (3 scales)", B * 49,
         22, C, HEADS, False, att8, timed),
        ("fused_attention_residual_s86 both launches n_seg=7 S=86", 7, 86, C,
         HEADS, False, att, False),
        ("fused_attention_residual_s86 both launches bare n_seg=5 S=86 C=256 "
         "H=4", 5, 86, 256, 4, True, att, False),
        ("fused_attention_residual_s86 both launches n_seg=1 S=65 C=512 H=8",
         1, 65, 512, 8, False, att, False),
        ("fused_attention_residual_s86 both launches n_seg=3 S=65 C=512 H=8",
         3, 65, 512, 8, False, att, False),
        ("fused_attention_residual_s86 core bare n_seg=5 S=86 C=256 H=4", 5,
         86, 256, 4, True, s86_core, False),
        ("fused_attention_residual_s86_proj bare rows=430 C=256", 5, 86, 256,
         4, True, s86_proj, False),
        ("fused_attention_residual_int8_s86 both launches n_seg=7 S=86", 7,
         86, C, HEADS, False, att8, False),
        ("fused_attention_residual_int8_s86 both launches bare n_seg=5 S=86 "
         "C=256 H=4", 5, 86, 256, 4, True, att8, False),
        ("fused_attention_residual_int8_s86 both launches n_seg=3 S=65 C=512 "
         "H=8", 3, 65, 512, 8, False, att8, False),
        ("fused_attention_residual_int8_s86 core bare n_seg=5 S=86 C=256 H=4",
         5, 86, 256, 4, True, s86_core8, False),
        ("fused_attention_residual_int8_s86_proj bare rows=430 C=256", 5, 86,
         256, 4, True, s86_proj8, False),
        # the 3- and 4-scale training steps' backward forms: the 86-token
        # backward at B=64 (the default routes' step), ragged, at S=65;
        # the main path's shapes (B=128) and S=22 below
        ("fused_attention_residual_bwd_s86 n_seg=3136 S=86", B * 49, 86, C,
         HEADS, False, s86b, False),
        ("fused_attention_residual_bwd_s86_dw n_seg=3136 S=86", B * 49, 86,
         C, HEADS, False, s86dw, False),
        ("fused_attention_residual_bwd_s86_bare n_seg=3136 S=86", B * 49, 86,
         C, HEADS, True, s86b, False),
        ("fused_attention_residual_bwd_s86_dw_bare n_seg=3136 S=86", B * 49,
         86, C, HEADS, True, s86dw, False),
        ("fused_attention_residual_bwd_s86 n_seg=7 S=86 (rounding points)", 7,
         86, C, HEADS, False, s86b_twin, False),
        ("fused_attention_residual_bwd_s86_dw n_seg=7 S=86", 7, 86, C, HEADS,
         False, s86dw, False),
        ("fused_attention_residual_bwd_s86_bare n_seg=5 S=86 C=256 H=4", 5,
         86, 256, 4, True, s86b, False),
        ("fused_attention_residual_bwd_s86_dw_bare n_seg=5 S=86 C=256 H=4", 5,
         86, 256, 4, True, s86dw, False),
        ("fused_attention_residual_bwd_s86 n_seg=3 S=65 C=512 H=8 (rounding "
         "points)", 3, 65, 512, 8, False, s86b_twin, False),
        ("fused_attention_residual_bwd_s86_dw n_seg=3 S=65 C=512 H=8", 3, 65,
         512, 8, False, s86dw, False),
        # the regularised 4-scale model's forms (R4r, phase 12) at small
        # shapes: the core with the attention dropout, the proj with gamma
        # and the proj dropout, both launches with every flag, the
        # backward chain with them (dw=False and dw), and the exact masks
        ("fused_attention_residual_s86_reg core n_seg=7 S=86", 7, 86, C,
         HEADS, False, s86_core_r, False),
        ("fused_attention_residual_s86_reg core bare n_seg=5 S=86 C=256 H=4",
         5, 86, 256, 4, True, s86_core_r, False),
        ("fused_attention_residual_s86_reg core over chunks of segments, the "
         "last ragged, n_seg=1001 S=86", 1001, 86, C, HEADS, False,
         s86_core_r_chunks, False),
        ("fused_attention_residual_s86_reg both launches all three n_seg=7 "
         "S=86", 7, 86, C, HEADS, False, att_r, False),
        ("fused_attention_residual_s86_reg both launches bare attention "
         "dropout n_seg=5 S=86 C=256 H=4", 5, 86, 256, 4, True, att_rb,
         False),
        ("fused_attention_residual_s86_reg both launches all three n_seg=3 "
         "S=65 C=512 H=8", 3, 65, 512, 8, False, att_r, False),
        ("fused_attention_residual_s86_reg attention masks, exact n_seg=7 "
         "S=86", 7, 86, C, HEADS, False, attention_mask_case, False),
        ("fused_attention_residual_s86_proj_reg gamma n_seg=7 S=86", 7, 86,
         C, HEADS, False, s86_proj_g, False),
        ("fused_attention_residual_s86_proj_reg proj dropout + gamma n_seg=7 "
         "S=86", 7, 86, C, HEADS, False, s86_proj_pg, False),
        ("fused_attention_residual_s86_proj_reg bare gamma rows=430 C=256", 5,
         86, 256, 4, True, s86_proj_g, False),
        ("fused_attention_residual_bwd_s86_reg attention dropout + gamma "
         "n_seg=7 S=86", 7, 86, C, HEADS, False, s86b_ag, False),
        ("fused_attention_residual_bwd_s86_reg proj dropout + gamma (gm) "
         "n_seg=7 S=86", 7, 86, C, HEADS, False, s86b_pg, False),
        ("fused_attention_residual_bwd_s86_reg all three n_seg=3 S=65 C=512 "
         "H=8", 3, 65, 512, 8, False, s86b_all, False),
        ("fused_attention_residual_bwd_s86_reg attention masks, exact "
         "n_seg=7 S=86", 7, 86, C, HEADS, False,
         part(attention_mask_case, backward=True), False),
        ("fused_attention_residual_bwd_s86_reg_dw attention dropout + gamma "
         "n_seg=7 S=86", 7, 86, C, HEADS, False, s86dw_ag, False),
        ("fused_attention_residual_bwd_s86_reg_dw proj dropout + gamma "
         "n_seg=7 S=86", 7, 86, C, HEADS, False, s86dw_pg, False),
        ("fused_attention_residual_bwd_s86_reg_dw all three n_seg=3 S=65 "
         "C=512 H=8", 3, 65, 512, 8, False, s86dw_all, False),
    ]
    if timed:
        # the MLP forms' times at the 4-scale rows (their checks at other
        # shapes above); left out of the untimed runs: chip_faults.py runs
        # up to 8 of those at once, and these plain versions hold several
        # GB each
        specs += [
            ("fused_mlp_residual rows=269696 (4 scales)", B * 49 * 86, C,
             HIDDEN, mlp, timed),
            ("fused_mlp_residual_int8 rows=269696 (4 scales)", B * 49 * 86,
             C, HIDDEN, mlp8, timed),
            # the 3- and 4-scale training steps' backward at B=128 (timed;
            # left out of the untimed runs for their memory), and the MLP
            # kernels at the 4-scale step's 539,392 rows (checked, untimed)
            ("fused_attention_residual_bwd_s86", B_TRAIN * 49, 86, C, HEADS,
             False, s86b, timed),
            ("fused_attention_residual_bwd_s86_dw", B_TRAIN * 49, 86, C,
             HEADS, False, s86dw, timed),
            ("fused_attention_residual_bwd_s86_bare n_seg=6272 S=86",
             B_TRAIN * 49, 86, C, HEADS, True, s86b, timed),
            ("fused_attention_residual_bwd_s86_dw_bare n_seg=6272 S=86",
             B_TRAIN * 49, 86, C, HEADS, True, s86dw, timed),
            ("fused_attention_residual_bwd n_seg=6272 S=22 (3 scales)",
             B_TRAIN * 49, 22, C, HEADS, False, s86b, timed),
            ("fused_attention_residual_bwd_dw n_seg=6272 S=22 (3 scales)",
             B_TRAIN * 49, 22, C, HEADS, False, s86dw, timed),
            # R4r's reg forms at the main path's shapes (timed; left out of
            # the untimed runs for their memory): the core with the
            # attention dropout at the default step's 3136 segments (B=64),
            # the proj with gamma at the serving path's, the backward at
            # the default step's 3136 (dw=False) and the lean step's 6272
            # (dw), each also with the proj dropout; both launches with
            # gamma alone, the attention dropout (also at 6272), every
            # flag, and bare
            ("fused_attention_residual_s86_reg", B * 49, 86, C, HEADS, False,
             s86_core_r, timed),
            ("fused_attention_residual_s86_proj_reg", B * 49, 86, C, HEADS,
             False, s86_proj_g, timed),
            ("fused_attention_residual_bwd_s86_reg", B * 49, 86, C, HEADS,
             False, s86b_ag, timed),
            ("fused_attention_residual_bwd_s86_reg_dw", B_TRAIN * 49, 86, C,
             HEADS, False, s86dw_ag, timed),
            ("fused_attention_residual_bwd_s86_reg proj dropout + gamma (gm) "
             "n_seg=3136", B * 49, 86, C, HEADS, False, s86b_pg, timed),
            ("fused_attention_residual_bwd_s86_reg_dw proj dropout + gamma "
             "n_seg=6272", B_TRAIN * 49, 86, C, HEADS, False, s86dw_pg,
             timed),
            ("fused_attention_residual_s86_reg both launches gamma alone "
             "n_seg=3136 (serving)", B * 49, 86, C, HEADS, False, att_g,
             timed),
            ("fused_attention_residual_s86_reg both launches attention "
             "dropout + gamma n_seg=3136", B * 49, 86, C, HEADS, False,
             att_ag, timed),
            ("fused_attention_residual_s86_reg both launches attention "
             "dropout + gamma n_seg=6272", B_TRAIN * 49, 86, C, HEADS, False,
             att_ag, timed),
            ("fused_attention_residual_s86_reg both launches all three "
             "n_seg=3136", B * 49, 86, C, HEADS, False, att_r, timed),
            ("fused_attention_residual_s86_reg both launches bare attention "
             "dropout n_seg=3136", B * 49, 86, C, HEADS, True, att_rb,
             timed),
            ("fused_mlp_residual_z rows=539392 (4 scales)", rows_4s, C,
             HIDDEN, part(mlp_rows_case, kind="z"), False),
            ("mlp_dz rows=539392 (4 scales)", rows_4s, C, HIDDEN,
             part(mlp_rows_case, kind="dz"), False),
            ("fused_mlp_bwd rows=539392 (4 scales)", rows_4s, C, HIDDEN,
             part(mlp_rows_case, kind="bwd"), False)]
    # the ViT-B/16 baseline's forms (S=197; serving B=64, training B=128)
    # and the block-diagonal op's long core, then other shapes; the
    # backward at the training step's shapes only in the timed run
    longb = part(attention_bwd_big_case, upcast_bars=True)
    longb_twin = part(attention_bwd_big_case, twin=True, upcast_bars=True)
    longdw = part(attention_bwd_big_case, dw=True, upcast_bars=True)
    S_V = VIT_S
    specs += [
        ("fused_attention_residual_long", B_TRAIN, S_V, C, HEADS, False,
         s86_core, timed),
        ("fused_attention_residual_long_bare n_seg=128 S=197", B_TRAIN, S_V,
         C, HEADS, True, s86_core, timed),
        ("fused_attention_residual_long both launches n_seg=64 S=197 "
         "(serving)", B, S_V, C, HEADS, False, att, timed),
        ("fused_attention_residual_long both launches n_seg=128 S=197",
         B_TRAIN, S_V, C, HEADS, False, att, timed),
        ("block_diag_attention_long", B_TRAIN, S_V, C, HEADS, bda, timed),
        ("block_diag_attention_long n_seg=3136 S=86", B * 49, 86, C, HEADS,
         bda, timed),
        ("block_diag_attention_long n_seg=3136 S=65", B * 49, 65, C, HEADS,
         bda, timed),
        ("fused_attention_residual_long both launches n_seg=7 S=197", 7, S_V,
         C, HEADS, False, att, False),
        ("fused_attention_residual_long both launches n_seg=7 S=87 C=512 H=8",
         7, 87, 512, 8, False, att, False),
        ("fused_attention_residual_long both launches n_seg=1 S=197 C=512 "
         "H=8", 1, S_V, 512, 8, False, att, False),
        ("fused_attention_residual_long_bare both launches n_seg=5 S=87 C=256 "
         "H=4", 5, 87, 256, 4, True, att, False),
        ("block_diag_attention_long n_seg=7 S=197", 7, S_V, C, HEADS, bda,
         False),
        ("block_diag_attention_long n_seg=3 S=65 C=256 H=4", 3, 65, 256, 4,
         bda, False),
        ("block_diag_attention_long n_seg=7 S=197 scores spread ~150",
         7, S_V, C, HEADS, bda_wide, False),
        ("block_diag_attention_long n_seg=7 S=197 scores spread ~0.25",
         7, S_V, C, HEADS, bda_narrow, False),
        ("block_diag_attention_long n_seg=7 S=197 on the first rows of a "
         "tensor whose later rows are NaN", 7, S_V, C, HEADS, bda_nan, False),
        ("block_diag_attention_long n_seg=5 S=65 scores spread ~0.25", 5, 65,
         C, HEADS, bda_narrow, False),
        ("fused_attention_residual_bwd_long n_seg=7 S=197 (rounding points)",
         7, S_V, C, HEADS, False, longb_twin, False),
        ("fused_attention_residual_bwd_long_dw n_seg=7 S=197", 7, S_V, C,
         HEADS, False, longdw, False),
        ("fused_attention_residual_bwd_long_bare n_seg=7 S=197", 7, S_V, C,
         HEADS, True, longb, False),
        ("fused_attention_residual_bwd_long_dw_bare n_seg=7 S=197", 7, S_V, C,
         HEADS, True, longdw, False),
        ("fused_attention_residual_bwd_long n_seg=5 S=87 C=512 H=8 (rounding "
         "points)", 5, 87, 512, 8, False, longb_twin, False),
        ("fused_attention_residual_bwd_long_dw n_seg=5 S=87 C=256 H=4", 5, 87,
         256, 4, False, longdw, False),
    ]
    if timed:
        specs += [
            ("fused_attention_residual_bwd_long", B_TRAIN, S_V, C, HEADS,
             False, longb, timed),
            ("fused_attention_residual_bwd_long_dw", B_TRAIN, S_V, C, HEADS,
             False, longdw, timed),
            ("fused_attention_residual_bwd_long_bare n_seg=128 S=197",
             B_TRAIN, S_V, C, HEADS, True, longb, timed),
            ("fused_attention_residual_bwd_long_dw_bare n_seg=128 S=197",
             B_TRAIN, S_V, C, HEADS, True, longdw, timed),
            ("fused_attention_residual_bwd_long n_seg=1024 S=197", 1024, S_V,
             C, HEADS, False, longb, False),
            ("fused_attention_residual_bwd_long_dw n_seg=1024 S=197", 1024,
             S_V, C, HEADS, False, longdw, False),
            ("fused_attention_residual_bwd_long_bare n_seg=1024 S=197", 1024,
             S_V, C, HEADS, True, longb, False),
            ("fused_attention_residual_bwd_long_dw_bare n_seg=1024 S=197",
             1024, S_V, C, HEADS, True, longdw, False)]
    # the hybrid R50ViT's 384-wide forms (phase 11: ViT-S, 6 heads, 50
    # tokens; serving B=64, training B=128), then other shapes: ragged,
    # bare, S=6 (48-row blocks, 128-row wqkv slabs), the reg flags
    c4, h4, s4, hid4 = C384, HEADS384, S_H1, HIDDEN384
    specs += [
        ("fused_attention_residual_c384", B, s4, c4, h4, False, att, timed),
        ("fused_mlp_residual_c384", B * s4, c4, hid4, mlp, timed),
        ("fused_mlp_residual_z_c384", B_TRAIN * s4, c4, hid4, mlp_z, timed),
        ("fused_attention_residual_bwd_c384", B_TRAIN, s4, c4, h4, False,
         bwd, timed),
        ("fused_attention_residual_bwd_dw_c384", B_TRAIN, s4, c4, h4, False,
         dw, timed),
        ("mlp_dz_c384", B_TRAIN * s4, c4, hid4, dz, timed),
        ("fused_mlp_bwd_c384", B_TRAIN * s4, c4, hid4, mlpb, timed),
        ("fused_layernorm_c384", B_TRAIN * s4, c4, ln, timed),
        ("fused_attention_residual_c384 n_seg=128 S=50 (training)", B_TRAIN,
         s4, c4, h4, False, att, timed),
        ("fused_mlp_residual_c384 rows=6400 (lean step)", B_TRAIN * s4, c4,
         hid4, mlp, timed),
        ("fused_attention_residual_c384 n_seg=3 S=50", 3, s4, c4, h4, False,
         att, False),
        ("fused_attention_residual_c384 bare n_seg=3 S=50", 3, s4, c4, h4,
         True, att, False),
        ("fused_attention_residual_c384 n_seg=13 S=6", 13, 6, c4, h4, False,
         att, False),
        ("fused_attention_residual_c384 reg n_seg=13 S=6", 13, 6, c4, h4,
         False, att_r, False),
        ("fused_attention_residual_bwd_c384 n_seg=3 S=50", 3, s4, c4, h4,
         False, bwd, False),
        ("fused_attention_residual_bwd_c384 bare n_seg=3 S=50", 3, s4, c4,
         h4, True, bwd, False),
        ("fused_attention_residual_bwd_c384 n_seg=13 S=6", 13, 6, c4, h4,
         False, bwd, False),
        ("fused_attention_residual_bwd_c384 reg n_seg=13 S=6", 13, 6, c4, h4,
         False, bwd_r, False),
        ("fused_attention_residual_bwd_dw_c384 n_seg=3 S=50", 3, s4, c4, h4,
         False, dw, False),
        ("fused_attention_residual_bwd_dw_c384 bare n_seg=3 S=50", 3, s4, c4,
         h4, True, dw, False),
        ("fused_attention_residual_bwd_dw_c384 n_seg=13 S=6", 13, 6, c4, h4,
         False, dw, False),
        ("fused_mlp_residual_c384 rows=222", 222, c4, hid4, mlp, False),
        ("fused_mlp_residual_c384 reg rows=222", 222, c4, hid4, mlp_rz,
         False),
        ("fused_mlp_residual_z_c384 rows=222", 222, c4, hid4, mlp_z, False),
        ("mlp_dz_c384 rows=222", 222, c4, hid4, dz, False),
        ("fused_mlp_bwd_c384 rows=222", 222, c4, hid4, mlpb, False),
        ("fused_layernorm_c384 rows=37", 37, c4, ln, False),
    ]
    # the float32 forms (phase 13: R2f served at B=64, trained at B=128;
    # R3f's S=22), then ragged and other widths
    f32 = dict(dtype=torch.float32)
    att_f, bwd_f = part(att, **f32), part(bwd, **f32)
    mlp_f, mlp_fz = part(mlp, **f32), part(mlp, z_form=True, **f32)
    dz_f = part(dz, **f32)
    specs += [
        ("fused_attention_residual_f32", B * 49, 6, C, HEADS, False, att_f,
         timed),
        ("fused_attention_residual_f32_bare", B, 50, C, HEADS, True, att_f,
         timed),
        ("fused_mlp_residual_f32", rows_s, C, HIDDEN, mlp_f, timed),
        ("fused_mlp_residual_z_f32", rows_t, C, HIDDEN, mlp_fz, timed),
        ("fused_attention_residual_bwd_f32", B_TRAIN * 49, 6, C, HEADS,
         False, bwd_f, timed),
        ("fused_attention_residual_bwd_f32_bare", B_TRAIN, 50, C, HEADS,
         True, bwd_f, timed),
        ("mlp_dz_f32", rows_t, C, HIDDEN, dz_f, timed),
        ("fused_attention_residual_f32 n_seg=3136 S=22", B * 49, 22, C,
         HEADS, False, att_f, timed),
        ("fused_attention_residual_f32_bare n_seg=128 S=50 (training)",
         B_TRAIN, 50, C, HEADS, True, att_f, timed),
        ("fused_attention_residual_bwd_f32 n_seg=6272 S=22", B_TRAIN * 49,
         22, C, HEADS, False, bwd_f, timed),
        ("fused_attention_residual_f32 n_seg=13 S=6", 13, 6, C, HEADS, False,
         att_f, False),
        ("fused_attention_residual_f32 n_seg=7 S=22", 7, 22, C, HEADS, False,
         att_f, False),
        ("fused_attention_residual_f32_bare n_seg=3 S=50", 3, 50, C, HEADS,
         True, att_f, False),
        ("fused_attention_residual_f32 C=256 n_seg=13 S=6", 13, 6, 256, 4,
         False, att_f, False),
        ("fused_attention_residual_f32 C=512 n_seg=1 S=64", 1, 64, 512, 8,
         False, att_f, False),
        ("fused_mlp_residual_f32 rows=222", 222, C, HIDDEN, mlp_f, False),
        ("fused_mlp_residual_f32 C=512 rows=222", 222, 512, 2048, mlp_f,
         False),
        ("fused_mlp_residual_z_f32 rows=222", 222, C, HIDDEN, mlp_fz, False),
        ("fused_attention_residual_bwd_f32 n_seg=13 S=6", 13, 6, C, HEADS,
         False, bwd_f, False),
        ("fused_attention_residual_bwd_f32 n_seg=7 S=22", 7, 22, C, HEADS,
         False, bwd_f, False),
        ("fused_attention_residual_bwd_f32_bare n_seg=3 S=50", 3, 50, C,
         HEADS, True, bwd_f, False),
        ("fused_attention_residual_bwd_f32 C=256 n_seg=13 S=6", 13, 6, 256,
         4, False, bwd_f, False),
        ("fused_attention_residual_bwd_f32 C=512 n_seg=1 S=64", 1, 64, 512,
         8, False, bwd_f, False),
        ("mlp_dz_f32 rows=222", 222, C, HIDDEN, dz_f, False),
        ("mlp_dz_f32 C=256 rows=37", 37, 256, 1024, dz_f, False),
    ]
    # the backward up to 64 tokens (csrc/attention_bwd_sm90.cu): packed
    # units with a short last one at S=1 and 21, one segment a unit at 64;
    # dq, dk and dv each alone at S=6 and 22; the reg dw form with every
    # flag over chunks of segments, the last ragged (fails in one chunk)
    bwd_qkv = part(s86b, split_qkv=True)
    dw_all_chunks = part(chunked_core_case, planner="attention_bwd_seg_chunks",
                         case=part(s86dw, reg=both))
    specs += [
        ("fused_attention_residual_bwd n_seg=130 S=1 C=256 H=4", 130, 1, 256,
         4, False, bwd, False),
        ("fused_attention_residual_bwd_dw n_seg=130 S=1 C=256 H=4", 130, 1,
         256, 4, False, dw, False),
        ("fused_attention_residual_bwd_bare n_seg=5 S=21 C=512 H=8", 5, 21,
         512, 8, True, bwd, False),
        ("fused_attention_residual_bwd_dw_bare n_seg=5 S=21 C=512 H=8", 5, 21,
         512, 8, True, dw, False),
        ("fused_attention_residual_bwd_reg all three n_seg=5 S=21 C=512 H=8",
         5, 21, 512, 8, False, bwd_r, False),
        ("fused_attention_residual_bwd n_seg=3 S=64 C=512 H=8", 3, 64, 512, 8,
         False, bwd, False),
        ("fused_attention_residual_bwd_dw n_seg=3 S=64 C=512 H=8", 3, 64, 512,
         8, False, dw, False),
        ("fused_attention_residual_bwd dq, dk, dv alone n_seg=6272 S=6",
         B_TRAIN * 49, 6, C, HEADS, False, bwd_qkv, False),
        ("fused_attention_residual_bwd dq, dk, dv alone n_seg=3136 S=22",
         B * 49, 22, C, HEADS, False, bwd_qkv, False),
        ("fused_attention_residual_bwd_reg_dw all three over chunks of "
         "segments, the last ragged, n_seg=6273 S=6", 6273, 6, C, HEADS,
         False, dw_all_chunks, False),
    ]
    # the recompute-from-x MLP backward (csrc/fused_mlp_bwd.cu): rows
    # around its 128-row tiles, each width of SHORT_C, a call over three
    # chunks of rows (the scratch bound cut to 1024 rows' worth) and a
    # second launch at the main path's rows, each bit for bit
    mlpb_again = part(mlpb, repeat=True)
    mlpb_chunks = part(mlp_bwd_chunks_case, chunk_rows=1024)
    specs += [
        ("fused_mlp_bwd rows=1", 1, C, HIDDEN, mlpb, False),
        ("fused_mlp_bwd rows=127", 127, C, HIDDEN, mlpb, False),
        ("fused_mlp_bwd rows=129", 129, C, HIDDEN, mlpb, False),
        ("fused_mlp_bwd rows=18817 (ragged)", rows_s + 1, C, HIDDEN, mlpb,
         False),
        ("fused_mlp_bwd rows=1000 C=256 hidden=1024", 1000, 256, 1024, mlpb,
         False),
        ("fused_mlp_bwd_c384 rows=1000 hidden=1536", 1000, c4, hid4, mlpb,
         False),
        ("fused_mlp_bwd rows=1000 C=512 hidden=2048", 1000, 512, 2048, mlpb,
         False),
        ("fused_mlp_bwd rows=1000 C=768", 1000, C, HIDDEN, mlpb, False),
        ("fused_mlp_bwd over three chunks of rows, the last ragged, "
         "rows=2817", 2817, C, HIDDEN, mlpb_chunks, False),
        ("fused_mlp_bwd twice, bit for bit, rows=37632", rows_t, C, HIDDEN,
         mlpb_again, False),
    ]
    # the backward at 65..197 tokens (csrc/attention_bwd_sm90.cu's long
    # core): ragged segment counts at S=65, 86, 87 and 197, each C of
    # SUPPORTED_C; dq, dk and dv each alone; inputs with a NaN tail; calls
    # over three chunks of segments (the scratch bound cut), the reg forms
    # with every flag over two segments and over chunks; the dw form twice
    # at the 4-scale lean step's 6272 segments, bit for bit
    longb_qkv = part(longb, split_qkv=True)
    bwd_chunks = attention_bwd_chunks_case
    specs += [
        ("fused_attention_residual_bwd_s86 n_seg=1 S=65", 1, 65, C, HEADS,
         False, s86b, False),
        ("fused_attention_residual_bwd_s86_dw n_seg=2 S=65 C=256 H=4", 2, 65,
         256, 4, False, s86dw, False),
        ("fused_attention_residual_bwd_s86 n_seg=2 S=86 C=512 H=8", 2, 86,
         512, 8, False, s86b, False),
        ("fused_attention_residual_bwd_s86_dw_bare n_seg=1 S=86", 1, 86, C,
         HEADS, True, s86dw, False),
        ("fused_attention_residual_bwd_s86_bare n_seg=7 S=86 C=512 H=8", 7,
         86, 512, 8, True, s86b, False),
        ("fused_attention_residual_bwd_long n_seg=1 S=87 C=256 H=4", 1, 87,
         256, 4, False, longb, False),
        ("fused_attention_residual_bwd_long_dw n_seg=2 S=87", 2, 87, C, HEADS,
         False, longdw, False),
        ("fused_attention_residual_bwd_long_bare n_seg=7 S=87 C=512 H=8", 7,
         87, 512, 8, True, longb, False),
        ("fused_attention_residual_bwd_long_dw_bare n_seg=1 S=197 C=512 H=8",
         1, S_V, 512, 8, True, longdw, False),
        ("fused_attention_residual_bwd_long n_seg=2 S=197 C=256 H=4 (rounding "
         "points)", 2, S_V, 256, 4, False, longb_twin, False),
        ("fused_attention_residual_bwd_long_dw n_seg=7 S=197 C=256 H=4", 7,
         S_V, 256, 4, False, longdw, False),
        ("fused_attention_residual_bwd_s86 dq, dk, dv alone n_seg=7 S=86", 7,
         86, C, HEADS, False, part(s86b, split_qkv=True), False),
        ("fused_attention_residual_bwd_long dq, dk, dv alone n_seg=7 S=197",
         7, S_V, C, HEADS, False, longb_qkv, False),
        ("fused_attention_residual_bwd_s86 on the first rows of tensors whose "
         "later rows are NaN, n_seg=7 S=86", 7, 86, C, HEADS, False,
         part(s86b, nan_tail=True), False),
        ("fused_attention_residual_bwd_long_dw on the first rows of tensors "
         "whose later rows are NaN, n_seg=7 S=197", 7, S_V, C, HEADS, False,
         part(longdw, nan_tail=True), False),
        ("fused_attention_residual_bwd_s86_reg_dw all three over three chunks "
         "of segments, the last ragged, n_seg=23 S=86", 23, 86, C, HEADS,
         False, part(bwd_chunks, chunk_segs=8, dw=True, reg=both), False),
        ("fused_attention_residual_bwd_s86_reg attention dropout + gamma over "
         "three chunks of segments, the last ragged, n_seg=23 S=86", 23, 86,
         C, HEADS, False,
         part(bwd_chunks, chunk_segs=8, reg=dict(attn_drop=DROP)), False),
        ("fused_attention_residual_bwd_long_dw over three chunks of segments, "
         "the last ragged, n_seg=7 S=197", 7, S_V, C, HEADS, False,
         part(bwd_chunks, chunk_segs=3, dw=True), False),
        ("fused_attention_residual_bwd_s86_reg all three n_seg=2 S=86", 2, 86,
         C, HEADS, False, s86b_all, False),
        ("fused_attention_residual_bwd_s86_reg_dw all three n_seg=2 S=86 "
         "C=256 H=4", 2, 86, 256, 4, False, s86dw_all, False),
        ("fused_attention_residual_bwd_s86_dw twice, bit for bit, n_seg=6272 "
         "S=86", B_TRAIN * 49, 86, C, HEADS, False, attention_bwd_repeat_case,
         False),
    ]
    # the float32 forward's 3xTF32 products (csrc/fused_attention_residual
    # _f32.cu on gemm_sm90.cuh's EPI_X3): each path form twice, bit for bit;
    # the weight split against its plain twin, bit for bit; S=64 at C=256
    # and 512. The dz pass on gemm_sm90.cuh's EPI_DZ: rows around its
    # 128-row tiles, C=384 at ragged rows, the main path's rows twice, bit
    # for bit
    att_f2 = part(att_f, repeat=True)
    specs += [
        ("fused_attention_residual_f32 twice, bit for bit, n_seg=3136 S=6",
         B * 49, 6, C, HEADS, False, att_f2, False),
        ("fused_attention_residual_f32 twice, bit for bit, n_seg=3136 S=22",
         B * 49, 22, C, HEADS, False, att_f2, False),
        ("fused_attention_residual_f32_bare twice, bit for bit, n_seg=64 "
         "S=50", B, 50, C, HEADS, True, att_f2, False),
        ("fused_attention_residual_f32_bare twice, bit for bit, n_seg=128 "
         "S=50", B_TRAIN, 50, C, HEADS, True, att_f2, False),
        ("fused_attention_residual_f32 weight split vs tf32_split_plain, bit "
         "for bit, wqkv C=768", C, 3 * C, tf32_split_case, False),
        ("fused_attention_residual_f32 weight split vs tf32_split_plain, bit "
         "for bit, wproj C=256", 256, 256, tf32_split_case, False),
        ("fused_attention_residual_f32 C=256 n_seg=3 S=64", 3, 64, 256, 4,
         False, att_f, False),
        ("fused_attention_residual_f32_bare C=512 n_seg=5 S=64", 5, 64, 512,
         8, True, att_f, False),
        ("mlp_dz rows=1", 1, C, HIDDEN, dz, False),
        ("mlp_dz rows=127", 127, C, HIDDEN, dz, False),
        ("mlp_dz rows=129", 129, C, HIDDEN, dz, False),
        ("mlp_dz_c384 rows=1000", 1000, c4, hid4, dz, False),
        ("mlp_dz twice, bit for bit, rows=37632", rows_t, C, HIDDEN,
         part(dz, repeat=True), False),
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


def time_step(torch, model, state, step, batches, card, what, n=3,
              dtype=None):
    """A training step's time: 7 host-clock windows of n steps, the
    forward / backward / optimizer split (CUDA events, median of 5 steps),
    the peak memory of a step and one step's device time by kernel
    (torch.profiler, CUPTI). A model with dropout takes seeds drawn for
    each step of the split, as the training step draws them. dtype: the
    step's compute dtype (None: bf16); the split runs in its precision
    scope, as the step does."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch._device import float32_precision
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    from duoformer_tcga_tpu_torch.models.duoformer import draw_seeds
    dtype = dtype or torch.bfloat16
    tf = getattr(model, "transformer", None)
    dropout = tf is not None and tf.has_dropout
    gen = torch.Generator().manual_seed(SEED)
    bsz = len(batches[0]["label"])
    windows = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(n):
            state, _ = step(state, batches[j % len(batches)])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / n)
    dt = float(np.median(windows))

    x = data_lib.preprocess_tiles(
        torch.as_tensor(batches[0]["image"]).cuda(), dtype=dtype)
    labels = torch.as_tensor(batches[0]["label"]).cuda()
    split = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state["optimizer"].zero_grad(set_to_none=True)
        seeds = draw_seeds(tf.num_seeds(), gen) if dropout else None
        with float32_precision(dtype):
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
    log(f"{what} throughput: {bsz / dt:.1f} tiles/s at B={bsz}, "
        f"median of 7 windows of {n} steps (least {bsz / max(windows):.1f}"
        f", greatest {bsz / min(windows):.1f}; step {dt * 1e3:.2f} ms); "
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
    log(f"{what}: one step at B={len(batches[0]['label'])}, launches "
        f"{launches}; losses of 3 steps {losses}")
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


def scales_train_phase(torch, port, fa, failures, card, cases):
    """Phase 9: the release DuoFormer trained at 3 and 4 scales (S=22 and
    S=86 a region), full width, depth SCALES_TRAIN_DEPTH, frozen backbone: 3 scales on the
    default routes at B=128; 4 scales (with apply_fc_norm and fused_ln, as
    phase 7's release model) on the memory-lean routes at B=128 and on the
    default routes at B=64. -> {path: the launch counts of one counted
    step}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    lean = dict(mlp_save_hidden=False, attn_bwd_dw=True)
    out = {}
    for layers in (3, 4):
        four = layers == 4

        def build(device):
            return port.build_model_no_extra_params(
                num_layers=layers, embed_dim=C, proj_dim=C, num_heads=HEADS,
                depth=SCALES_TRAIN_DEPTH, apply_fc_norm=four, fused_ln=four,
                device=device,
                seed=SEED)

        t0 = time.perf_counter()
        model = build("cuda")
        opt = train_lib.make_optimizer(
            model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
            frozen_label_fn=train_lib.backbone_frozen_labels)
        state = train_lib.init_train_state(model, opt)
        step = train_lib.make_train_step(model, dtype=torch.bfloat16,
                                         **(lean if four else {}))
        trainable = {n for n, p in model.named_parameters() if p.requires_grad}
        names = grad_check_names(model) + (
            ["transformer.fc_norm.scale", "transformer.fc_norm.bias"]
            if four else [])
        rng = np.random.default_rng(SEED + 10 + layers)
        image = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
        grads = functools.partial(two_tile_grads, torch, names=names,
                                  image=image, seeds=None)

        # gradients of one backward on 2 tiles: the card in bf16 on each
        # route this scale count trains on, against the port's CPU float32
        # run (phase 4's bar) and, at 4 scales, lean against default on the
        # card (phase 7's)
        g_card = {"lean" if four else "default": grads(
            model, device="cuda", dtype=torch.bfloat16)[0]}
        if four:
            train_lib.set_backward_routes(model)
            g_card["default"] = grads(model, device="cuda",
                                      dtype=torch.bfloat16)[0]
            train_lib.set_backward_routes(model, **lean)
        cpu_model = build("cpu")
        train_lib.make_train_step(cpu_model, dtype=torch.float32)
        g_cpu, _ = grads(cpu_model, device="cpu", dtype=torch.float32)
        del cpu_model
        errs = {r: {n: rel_err(g[n], g_cpu[n]) for n in names}
                for r, g in g_card.items()}
        route = ({n: rel_err(g_card["lean"][n], g_card["default"][n])
                  for n in names} if four else {})
        log(f"{layers}-scale train: set up and gradients on 2 tiles "
            f"({time.perf_counter() - t0:.1f} s); rel L2 err card bf16 vs "
            f"CPU float32 ({' | '.join(g_card)} routes, tolerance "
            f"{GRAD_REL_TOL})" + (f" || lean vs default routes on the card "
                                  f"(tolerance {LEAN_ROUTE_TOL})" if four
                                  else "") + ":")
        for n in names:
            log(f"  {n}: " + " | ".join(f"{errs[r][n]:.3e}" for r in errs)
                + (f" || {route[n]:.3e}" if four else ""))
        for r, e in errs.items():
            failures += [f"{layers}-scale {r} gradient of {n}: {v:.3e}"
                         for n, v in e.items() if not v <= GRAD_REL_TOL]
        failures += [f"4-scale gradient of {n} (lean vs default): {v:.3e}"
                     for n, v in route.items() if not v <= LEAN_ROUTE_TOL]
        del g_card, g_cpu

        # windows of one step at 4 scales (a step takes 0.8-2.1 s; the
        # whole script stays near 600 s)
        runs = ([("lean", lean, B_TRAIN, 1), ("default", {}, B, 1)] if four
                else [("default", {}, B_TRAIN, 3)])
        for name, routes, bsz, per_window in runs:
            what = f"{layers}-scale {name} train"
            if name == "default" and four:
                step = train_lib.make_train_step(model, dtype=torch.bfloat16)
            batches = [{"image": rng.integers(0, 256, (bsz, 224, 224, 3),
                                              dtype=np.uint8),
                        "label": rng.integers(0, 2, (bsz,))}
                       for _ in range(3)]
            before = {n: t.detach().clone()
                      for n, t in model.state_dict().items()}
            key = f"{layers}-scale {name}"
            # at 3 scales the head reads the raw CLS (quirk Q7): fc_norm's
            # zero bias is reached by neither the loss nor the L2 term
            out[f"{what} (1 step)"] = three_steps(
                torch, fa, failures, what, model, state, step, batches,
                trainable, before,
                {k: SCALES_TRAIN_DEPTH if n == 12 else n
                 for k, n in SCALES_TRAIN[key].items()}, cases,
                () if four else ("fc_norm.",))
            del before
            time_step(torch, model, state, step, batches, card, what,
                      per_window)
            del batches
            torch.cuda.empty_cache()
        del model, state, step
        torch.cuda.empty_cache()
    return out


def block_attention_op_path(torch, fa, failures):
    """The block_diag_attention op through its entry point: forward and
    backward at the checked shapes (S=6 over 3136 segments, S=50 over 64;
    the long core at S=86 over 3136 and S=197 over 128), counted. -> the
    launch counts."""
    gen = torch.Generator().manual_seed(SEED + 7)
    fa.reset_launch_counts()
    res = []
    for n_seg, S in ((B * 49, 6), (B, 50), (B * 49, 86), (B_TRAIN, VIT_S)):
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
    log(f"block_diag_attention op: forward and backward at S=6, 50, 86 and "
        f"197: {'; '.join(res)}; launches {launches}")
    check_launches(failures, "block_diag_attention op", launches,
                   {"block_diag_attention": 2, "block_diag_attention_long": 2},
                   ["block_diag_attention", "block_diag_attention_long"])
    return launches


def region_tokens(torch, pred, tiles):
    """The scale stack's region tokens [B, 49, C] (what the patch stack
    reads) for `tiles`, float32 on the CPU."""
    m = pred.model
    with torch.inference_mode():
        x = m.transformer.scale_stack(m.tokens(m.features(pred.prepare(
            tiles))))
        return x[:, :, 0, :].float().cpu()


def cls_noise_floor(torch, pred, tiles):
    """How far the CLS of `pred` (a CPU Predictor) moves when its
    transformer input moves by 1e-6 relative (a fixed draw)."""
    m = pred.model
    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        tok = m.tokens(m.features(pred.prepare(tiles)))
        moved = tok * (1 + 1e-6 * torch.randn(tok.shape, generator=gen,
                                               dtype=tok.dtype))
        return rel_err(m.transformer(moved, with_embedding=True)[1],
                       m.transformer(tok, with_embedding=True)[1])


def scales_phase(torch, port, fa, failures, card, cases):
    """Phase 8: the release DuoFormer at 3 and 4 scales (S=22 and S=86 a
    region), full width, depth 12, served at B=64 in bf16 and in int8.
    -> {path: the launch counts of its 3 forwards}."""
    from duoformer_tcga_tpu_torch.inference import Predictor

    paths = {}
    for layers in (3, 4):
        def build(device):
            return port.build_model_no_extra_params(
                num_layers=layers, embed_dim=C, proj_dim=C, num_heads=HEADS,
                depth=12, device=device, seed=SEED)

        rng = np.random.default_rng(SEED + layers)
        batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
                   for _ in range(3)]
        two = batches[0][:2]
        preds, stages = {}, {}
        for kind in ("bf16", "int8"):
            what = f"{layers}-scale {kind} serving"
            t0 = time.perf_counter()
            pred = Predictor(build("cuda"), dtype=torch.bfloat16,
                             quantize=kind == "int8")
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_counts()
            outs = [pred(t) for t in batches]
            torch.cuda.synchronize()
            launches = dict(fa.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            paths[f"{what} ({len(batches)} forwards)"] = launches
            log(f"{what}: built in {time.perf_counter() - t0:.1f} s; 3 "
                f"batches of {B}; launches {launches}; memory "
                f"{resident / 2**30:.2f} GiB resident before the forwards, "
                f"peak {peak / 2**30:.2f} GiB during them")
            check_launches(failures, what, launches,
                           {k: 3 * v for k, v in
                            SCALES_SERVE[(layers, kind)].items()}, cases)
            for i, lg in enumerate(outs):
                if tuple(lg.shape) != (B, 2) or not bool(
                        torch.isfinite(lg).all()):
                    failures.append(f"{what} batch {i}: logits "
                                    f"{tuple(lg.shape)}, finite="
                                    f"{bool(torch.isfinite(lg).all())}")
            # embed() on 2 tiles against the port's CPU float32 run of the
            # same weights (int8: the CPU int8 path), and the region tokens
            # the scale stack hands the patch stack; beside them, not held
            # to a bar, the CPU run in bf16 (the card's serving dtype): the
            # card against it, and what bf16 alone moves on the CPU
            g_logits, g_cls = pred.embed(two)
            cpu = {dt: Predictor(build("cpu"), device="cpu", dtype=dt,
                                 quantize=kind == "int8")
                   for dt in (torch.float32, torch.bfloat16)}
            c_logits, c_cls = cpu[torch.float32].embed(two)
            h_cls = cpu[torch.bfloat16].embed(two)[1]
            e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits,
                                                             c_logits)
            e_reg = rel_err(region_tokens(torch, pred, two),
                            region_tokens(torch, cpu[torch.float32], two))
            log(f"{what}: embed vs the CPU float32 {kind} path: rel L2 err "
                f"cls {e_cls:.3e}, logits {e_logits:.3e}, region tokens "
                f"{e_reg:.3e} (tolerance {EMBED_REL_TOL}); not held to a "
                f"bar: cls vs the CPU bf16 {kind} path "
                f"{rel_err(g_cls, h_cls):.3e}, the CPU bf16 path vs the CPU "
                f"float32 one {rel_err(h_cls, c_cls):.3e}")
            if kind == "int8":
                # The int8 CLS is held by the region tokens and the logits,
                # not by itself: 12 residual-free int8 PatchBlocks at random
                # init turn any perturbation of their input into code flips
                # that compound, so the CLS moves by about 5e-2 whatever
                # moved it (the CPU's own float32 int8 path under a 1e-6
                # relative change of its tokens, printed here).
                floor = cls_noise_floor(torch, cpu[torch.float32], two)
                log(f"{what}: the CPU float32 int8 path's cls under a 1e-6 "
                    f"relative change of its tokens moves by {floor:.3e}")
                held = (e_logits, e_reg)
            else:
                held = (e_cls, e_logits, e_reg)
            if not all(e <= EMBED_REL_TOL for e in held):
                failures.append(f"{what}: embed vs CPU cls {e_cls:.3e}, "
                                f"logits {e_logits:.3e}, region tokens "
                                f"{e_reg:.3e}")
            del cpu
            stages[kind] = serve_stages(torch, pred, batches[0])
            log(f"{what}: stages at B={B}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in stages[kind].items()))
            preds[kind] = pred
            del outs
        # int8 against bf16 on the same weights and batch, at the JAX
        # package's bound (tests/test_int8.py:58)
        ref = preds["bf16"](batches[0]).float().cpu()
        lg8 = preds["int8"](batches[0]).float().cpu()
        drift = (lg8 - ref).abs().max().item()
        limit = 0.05 * (ref.abs().max().item() + 1.0)
        log(f"{layers}-scale int8 vs bf16 on batch 0: logits max |diff| "
            f"{drift:.4e} (bound {limit:.4e})")
        if not drift < limit:
            failures.append(f"{layers}-scale int8 vs bf16 logit drift "
                            f"{drift:.4e} >= {limit:.4e}")
        rates = serve_rates(torch, preds, batches[0])
        for kind, (dt, windows) in rates.items():
            log(f"{layers}-scale {kind} throughput, windows interleaved: "
                f"{B / dt:.1f} tiles/s at B={B}, median of 7 windows of 5 "
                f"forwards (least {B / max(windows):.1f}, greatest "
                f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms) on "
                f"{card}")
        del preds
        torch.cuda.empty_cache()
    return paths


def vit_phase(torch, port, fa, failures, card, cases):
    """Phase 10: the ViT-B/16 baseline (build_vit_base16, vit-baseline) at
    full width, served at B=64 through Predictor in bf16 and trained at
    B=128 on the default and the memory-lean routes. -> {path: launch
    counts}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    from duoformer_tcga_tpu_torch.inference import Predictor
    paths = {}
    rng = np.random.default_rng(SEED + 20)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    two = batches[0][:2]

    # ---- serving: 3 forwards, counted; embed() vs the CPU; tiles/s ----
    what = "ViT-B/16 serving"
    t0 = time.perf_counter()
    cpu_model = port.build_vit_base16(n_classes=VIT_CLASSES, device="cpu",
                                      seed=SEED)
    c_logits, c_cls = Predictor(cpu_model, device="cpu",
                                dtype=torch.float32).embed(two)
    pred = Predictor(port.build_vit_base16(n_classes=VIT_CLASSES,
                                           device="cuda", seed=SEED),
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    outs = [pred(t) for t in batches]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    paths[f"{what} ({len(batches)} forwards)"] = launches
    log(f"{what}: built in {time.perf_counter() - t0:.1f} s; 3 batches of "
        f"{B}; launches {launches}; memory {resident / 2**30:.2f} GiB "
        f"resident before the forwards, peak {peak / 2**30:.2f} GiB during "
        f"them")
    check_launches(failures, what, launches,
                   {k: 3 * v for k, v in VIT_SERVE.items()}, cases)
    for i, lg in enumerate(outs):
        if tuple(lg.shape) != (B, VIT_CLASSES) or not bool(
                torch.isfinite(lg).all()):
            failures.append(f"{what} batch {i}: logits {tuple(lg.shape)}, "
                            f"finite={bool(torch.isfinite(lg).all())}")
    g_logits, g_cls = pred.embed(two)
    e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
    log(f"{what}: embed vs the CPU float32 run: rel L2 err cls {e_cls:.3e}, "
        f"logits {e_logits:.3e} (tolerance {EMBED_REL_TOL})")
    if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
        failures.append(f"{what}: embed vs CPU cls {e_cls:.3e}, logits "
                        f"{e_logits:.3e}")
    dt, windows = serve_rates(torch, {"bf16": pred}, batches[0])["bf16"]
    log(f"{what} throughput: {B / dt:.1f} tiles/s at B={B}, median of 7 "
        f"windows of 5 forwards (least {B / max(windows):.1f}, greatest "
        f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms) on {card}")
    del pred, outs
    torch.cuda.empty_cache()

    # ---- training, default and lean routes: gradients on 2 tiles (card
    # bf16 vs the CPU float32 run, lean vs default on the card), one
    # counted step and two more, tiles/s ----
    lean = dict(mlp_save_hidden=False, attn_bwd_dw=True)
    model = port.build_vit_base16(n_classes=VIT_CLASSES, device="cuda",
                                  seed=SEED)
    # the same weights with the final norm through the LayerNorm kernel
    # (what build_vit_base16(fused_ln=True) builds)
    lean_model = copy.deepcopy(model)
    lean_model.model.norm.fused = True
    last = len(model.model.blocks) - 1
    keep = (f"model.blocks.0.", f"model.blocks.{last}.", "model.patch_embed.",
            "model.pos_embed", "model.cls_token", "model.norm.",
            "model.head.")
    names = [n for n, _ in model.named_parameters() if n.startswith(keep)]

    def grads(m, device, dtype):
        x = data_lib.preprocess_tiles(torch.as_tensor(two).to(device),
                                      dtype=dtype)
        labels = torch.zeros(2, dtype=torch.long).to(device)
        params = dict(m.named_parameters())
        loss = train_lib.cross_entropy(m(x), labels)
        return dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names])))

    runs = {}
    for route, m in (("default", model), ("lean", lean_model)):
        opt = train_lib.make_optimizer(
            m, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4)
        state = train_lib.init_train_state(m, opt)
        step = train_lib.make_train_step(
            m, dtype=torch.bfloat16, **(lean if route == "lean" else {}))
        runs[route] = (m, state, step, grads(m, "cuda", torch.bfloat16))
    g_cpu = grads(cpu_model, "cpu", torch.float32)
    del cpu_model
    errs = {r: {n: rel_err(v[3][n], g_cpu[n]) for n in names}
            for r, v in runs.items()}
    route_err = {n: rel_err(runs["lean"][3][n], runs["default"][3][n])
                 for n in names}
    log(f"ViT-B/16 train: gradients on 2 tiles, rel L2 err card bf16 vs CPU "
        f"float32 (default | lean routes, tolerance {GRAD_REL_TOL}) || lean "
        f"vs default routes on the card (tolerance {LEAN_ROUTE_TOL}):")
    for n in names:
        log(f"  {n}: {errs['default'][n]:.3e} | {errs['lean'][n]:.3e} || "
            f"{route_err[n]:.3e}")
    for r, e in errs.items():
        failures += [f"ViT-B/16 {r} gradient of {n}: {v:.3e}"
                     for n, v in e.items() if not v <= GRAD_REL_TOL]
    failures += [f"ViT-B/16 gradient of {n} (lean vs default): {v:.3e}"
                 for n, v in route_err.items() if not v <= LEAN_ROUTE_TOL]
    del g_cpu
    batches_t = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                        dtype=np.uint8),
                  "label": rng.integers(0, VIT_CLASSES, (B_TRAIN,))}
                 for _ in range(3)]
    for route in ("default", "lean"):
        m, state, step, _ = runs.pop(route)
        what = f"ViT-B/16 {route} train"
        trainable = {n for n, _ in m.named_parameters()}
        before = {n: t.detach().clone() for n, t in m.state_dict().items()}
        paths[f"{what} (1 step)"] = three_steps(
            torch, fa, failures, what, m, state, step, batches_t, trainable,
            before, VIT_TRAIN[route], cases)
        del before
        time_step(torch, m, state, step, batches_t, card, what, 2)
        del m, state, step
        torch.cuda.empty_cache()
    return paths


def hybrid_grad_names(model):
    """The hybrid's tensors whose card-vs-CPU gradients are compared: the
    ViT's (blocks 0 and depth-1, the patch embed, the position embedding,
    the CLS, the final norm, the head) and the trunk's (its stem, first
    block and last block). -> (the ViT's, the trunk's)."""
    m = model.model
    last = len(m.vit.blocks) - 1
    stages = m.backbone.stages
    vit = ("model.vit.blocks.0.", f"model.vit.blocks.{last}.",
           "model.vit.patch_embed.", "model.vit.pos_embed",
           "model.vit.cls_token", "model.vit.norm.", "model.vit.head.")
    trunk = ("model.backbone.stem.", "model.backbone.stages.0.blocks.0.",
             f"model.backbone.stages.{len(stages) - 1}.blocks."
             f"{len(stages[-1].blocks) - 1}.")
    names = [n for n, _ in model.named_parameters()]
    return ([n for n in names if n.startswith(vit)],
            [n for n in names if n.startswith(trunk)])


def hybrid_grads(torch, m, names, image, device, dtype, tokens=None):
    """Gradients of one backward of the hybrid `m` on 2 tiles of label 0
    -> ({name: gradient}, the tokens the ViT's blocks read); given tokens,
    the gradients from them (of the names in the ViT's blocks, final norm
    and head)."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    labels = torch.zeros(len(image), dtype=torch.long).to(device)
    params = dict(m.named_parameters())
    vit = m.model.vit
    if tokens is None:
        x = data_lib.preprocess_tiles(torch.as_tensor(image).to(device),
                                      dtype=dtype)
        tokens = m.model.embed(x)
        wrt = names
    else:
        tokens = tokens.to(device, dtype)
        wrt = [n for n in names if n.startswith(
            ("model.vit.blocks.", "model.vit.norm.", "model.vit.head."))]
    loss = train_lib.cross_entropy(
        vit.forward_head(vit.forward_tokens(tokens)), labels)
    return (dict(zip(wrt, torch.autograd.grad(
        loss, [params[n] for n in wrt]))), tokens.detach())


def hybrid_phase(torch, port, fa, failures, card, cases):
    """Phase 11: the ResNetV2 hybrid baselines at full width, R50ViT (H1:
    R26-S/32 + ViT-S/384, the 384-wide forms) served at B=64 and trained
    at B=128 on the default and the memory-lean routes, ViTPretrained (H2:
    R50-S/16 + ViT-B, 197 tokens) served at B=64 and trained at B=128 on
    the default routes; every parameter trains, the trunk included. ->
    {path: launch counts}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.data import pipeline as data_lib
    from duoformer_tcga_tpu_torch.inference import Predictor
    paths = {}
    rng = np.random.default_rng(SEED + 30)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    batches_t = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                        dtype=np.uint8),
                  "label": rng.integers(0, VIT_CLASSES, (B_TRAIN,))}
                 for _ in range(3)]
    two = batches[0][:2]
    lean = dict(mlp_save_hidden=False, attn_bwd_dw=True)
    for tag, model_type, serve_want, train_want in (
            ("H1 R50ViT", "R50ViT", H1_SERVE, H1_TRAIN),
            ("H2 ViTPretrained", "ViTPretrained", VIT_SERVE,
             {"default": VIT_TRAIN["default"]})):
        # ---- serving: 3 forwards, counted; embed() vs the CPU; tiles/s ----
        what = f"{tag} serving"
        t0 = time.perf_counter()
        cpu_model = port.build_vit_base16(
            n_classes=VIT_CLASSES, model_type=model_type, device="cpu",
            seed=SEED)
        c_logits, c_cls = Predictor(copy.deepcopy(cpu_model), device="cpu",
                                    dtype=torch.float32).embed(two)
        pred = Predictor(copy.deepcopy(cpu_model), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        outs = [pred(t) for t in batches]
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        paths[f"{what} ({len(batches)} forwards)"] = launches
        log(f"{what}: built in {time.perf_counter() - t0:.1f} s; 3 batches "
            f"of {B}; launches {launches}; memory {resident / 2**30:.2f} GiB"
            f" resident before the forwards, peak {peak / 2**30:.2f} GiB "
            f"during them")
        check_launches(failures, what, launches,
                       {k: 3 * v for k, v in serve_want.items()}, cases)
        for i, lg in enumerate(outs):
            if tuple(lg.shape) != (B, VIT_CLASSES) or not bool(
                    torch.isfinite(lg).all()):
                failures.append(f"{what} batch {i}: logits "
                                f"{tuple(lg.shape)}, finite="
                                f"{bool(torch.isfinite(lg).all())}")
        g_logits, g_cls = pred.embed(two)
        e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
        log(f"{what}: embed vs the CPU float32 run: rel L2 err cls "
            f"{e_cls:.3e}, logits {e_logits:.3e} (tolerance "
            f"{EMBED_REL_TOL})")
        if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
            failures.append(f"{what}: embed vs CPU cls {e_cls:.3e}, logits "
                            f"{e_logits:.3e}")
        dt, windows = serve_rates(torch, {"bf16": pred}, batches[0])["bf16"]
        log(f"{what} throughput: {B / dt:.1f} tiles/s at B={B}, median of "
            f"7 windows of 5 forwards (least {B / max(windows):.1f}, "
            f"greatest {B / min(windows):.1f}; forward {dt * 1e3:.2f} ms) "
            f"on {card}")
        del pred, outs
        torch.cuda.empty_cache()

        # ---- training: gradients of one backward on 2 tiles, card bf16
        # against CPU float32, twice (as phase 6): from the same tokens (the
        # card's, upcast) through the ViT, the path of the kernels, at
        # GRAD_REL_TOL; and end to end from the tiles at
        # HYBRID_E2E_GRAD_TOL, where the bf16 trunk's tokens (printed) move
        # these gradients further. The trunk's own gradients are printed
        # beside the CPU's bf16 run against its float32 run and held lean
        # against default on the card (one forward, so one rounding), not
        # against the CPU: bf16 rounding grows through the trunk's 8 or 16
        # GroupNorm blocks (the R26-S/32 map ~13% off float32 on either
        # device; JAX's trunk in bf16 ~11.5% off its float32 run), and the
        # gradients of its early blocks follow it (~0.75 relative L2 on the
        # CPU alone). Then one counted step and two more, tiles/s ----
        vit_names, trunk_names = hybrid_grad_names(cpu_model)
        names = vit_names + trunk_names
        models = {"default": copy.deepcopy(cpu_model).cuda()}
        if "lean" in train_want:
            # the same weights with the final norm through the LayerNorm
            # kernel (what build_vit_base16(fused_ln=True) builds)
            models["lean"] = copy.deepcopy(models["default"])
            models["lean"].model.vit.norm.fused = True
        runs = {}
        for route, m in models.items():
            opt = train_lib.make_optimizer(
                m, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4)
            state = train_lib.init_train_state(m, opt)
            step = train_lib.make_train_step(
                m, dtype=torch.bfloat16, **(lean if route == "lean" else {}))
            runs[route] = (m, state, step, hybrid_grads(
                torch, m, names, two, "cuda", torch.bfloat16))
        cpu_model.train()
        cpu_e2e, cpu_tokens = hybrid_grads(torch, cpu_model, names, two,
                                           "cpu", torch.float32)
        cpu_bf16, _ = hybrid_grads(torch, cpu_model, trunk_names, two,
                                   "cpu", torch.bfloat16)
        floor = {n: rel_err(cpu_bf16[n], cpu_e2e[n]) for n in trunk_names}
        log(f"{tag} train: gradients on 2 tiles; tokens card vs CPU rel L2 "
            + ", ".join(f"{r} {rel_err(v[3][1], cpu_tokens):.3e}"
                        for r, v in runs.items())
            + f"; rel L2 err card bf16 vs CPU float32 ({' | '.join(runs)} "
            f"routes; from the same tokens, tolerance {GRAD_REL_TOL}, and "
            f"end to end, tolerance {HYBRID_E2E_GRAD_TOL})"
            + (f" || lean vs default routes on the card (tolerance "
               f"{LEAN_ROUTE_TOL})" if "lean" in runs else "") + ":")
        for r, v in runs.items():
            same, _ = hybrid_grads(torch, cpu_model, names, two, "cpu",
                                   torch.float32,
                                   tokens=v[3][1].float().cpu())
            errs = {n: rel_err(v[3][0][n], e) for n, e in same.items()}
            e2e = {n: rel_err(v[3][0][n], cpu_e2e[n]) for n in vit_names}
            for n in vit_names:
                log(f"  {r} {n}: {errs.get(n, float('nan')):.3e} | "
                    f"{e2e[n]:.3e}")
            failures += [f"{tag} {r} gradient of {n} (same tokens): "
                         f"{e:.3e}" for n, e in errs.items()
                         if not e <= GRAD_REL_TOL]
            failures += [f"{tag} {r} gradient of {n} (end to end): {e:.3e}"
                         for n, e in e2e.items()
                         if not e <= HYBRID_E2E_GRAD_TOL]
        log(f"{tag} train: the trunk's gradients, rel L2 err card bf16 vs "
            f"CPU float32 ({' | '.join(runs)}), beside the CPU's own bf16 "
            f"run vs its float32 run (not held):")
        for n in trunk_names:
            log(f"  {n}: " + " | ".join(
                f"{rel_err(v[3][0][n], cpu_e2e[n]):.3e}"
                for v in runs.values()) + f" (CPU bf16 {floor[n]:.3e})")
        if "lean" in runs:
            route_err = {n: rel_err(runs["lean"][3][0][n],
                                    runs["default"][3][0][n]) for n in names}
            log(f"{tag} train: lean vs default routes on the card, rel L2 "
                f"err (tolerance {LEAN_ROUTE_TOL}): " + ", ".join(
                    f"{n} {e:.3e}" for n, e in route_err.items()))
            failures += [f"{tag} gradient of {n} (lean vs default): {v:.3e}"
                         for n, v in route_err.items()
                         if not v <= LEAN_ROUTE_TOL]
        del cpu_model, cpu_e2e, cpu_bf16
        for route in list(runs):
            m, state, step, _ = runs.pop(route)
            what = f"{tag} {route} train"
            trainable = {n for n, _ in m.named_parameters()}
            log(f"{what}: {len(trainable)} trainable tensors, "
                f"{sum(n.startswith('model.backbone.') for n in trainable)} "
                f"of them the trunk's")
            before = {n: t.detach().clone()
                      for n, t in m.state_dict().items()}
            paths[f"{what} (1 step)"] = three_steps(
                torch, fa, failures, what, m, state, step, batches_t,
                trainable, before, train_want[route], cases)
            del before
            time_step(torch, m, state, step, batches_t, card, what, 2)
            del m, state, step
            torch.cuda.empty_cache()
    return paths


def trunk_trains_case(torch, port):
    """For chip_faults.py: the R50ViT hybrid trained 3 steps at B=8 on the
    default routes as phase 11 trains it (Adam with L2 decay on every
    parameter, nothing frozen): every tensor, the trunk's included, must
    move. -> {label: result} in kernel_checks' form, rel_err the share of
    tensors left unchanged."""
    from duoformer_tcga_tpu_torch import train as train_lib
    model = port.build_vit_base16(n_classes=VIT_CLASSES, model_type="R50ViT",
                                  device="cuda", seed=SEED)
    opt = train_lib.make_optimizer(
        model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4)
    state = train_lib.init_train_state(model, opt)
    step = train_lib.make_train_step(model, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 31)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(3):
        state, _ = step(state, {
            "image": rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8),
            "label": rng.integers(0, VIT_CLASSES, (8,))})
    same = [n for n, p in model.named_parameters()
            if torch.equal(p, before[n])]
    return {"hybrid_trunk_trains R50ViT 3 steps at B=8": dict(
        ok=not same, close=not same, rel_err=len(same) / len(before),
        max_abs_err=0.0, unchanged=same[:5])}


def reg_grad_names(model):
    """The R4r / R3r tensors whose card-vs-CPU gradients are compared:
    grad_check_names' but the scale blocks' q/k norms (carried unapplied,
    Q9: no gradient) and the patch blocks' k_norm bias (a constant shift of
    every key adds the same score to each key of a query, which the
    softmax cancels: its gradient is 0 analytically and rounding noise on
    either device). -> (names, the ones printed but not held: the patch
    blocks' other q/k norm tensors, which no kernel of the port touches.
    Their gradients sum bf16-rounded terms of both signs over every row:
    in a CPU rehearsal at C=128, depth 2, the port's own bf16 run on the
    CPU sits 1e-2 to 8e-2 from its float32 run there, and the CPU tests
    hold that route to the JAX package in float32.)"""
    names = [n for n in grad_check_names(model)
             if not ((".scale_blocks." in n and "_norm." in n)
                     or n.endswith("k_norm.bias"))]
    return names, [n for n in names if "_norm." in n]


def reg_scales_phase(torch, port, fa, failures, card, cases):
    """Phase 12: the regularised release DuoFormer R4r (4 scales, LayerScale
    1e-5, attention and proj dropout rates 0.1: Q9 makes them the
    attention-probability and MLP dropout and applies the patch blocks'
    q/k norms) at full width, depth 12: served at B=64 in bf16 and trained
    on the default routes at B=64 and the memory-lean ones at B=128; then
    R3r (3 scales) at depth 2, one step. -> {path: launch counts}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch.inference import Predictor
    from duoformer_tcga_tpu_torch.models.duoformer import draw_seeds
    lean = dict(mlp_save_hidden=False, attn_bwd_dw=True)
    out = {}

    def build(device, layers=4, depth=12):
        return port.build_model_no_extra_params(
            num_layers=layers, embed_dim=C, proj_dim=C, num_heads=HEADS,
            depth=depth, device=device, seed=SEED, **R_REG)

    # ---- serving: 3 forwards counted, embed() vs the CPU, tiles/s ----
    what = "R4r bf16 serving"
    t0 = time.perf_counter()
    pred = Predictor(build("cuda"), dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 12)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    outs = [pred(t) for t in batches]
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    out[f"{what} ({len(batches)} forwards)"] = launches
    log(f"{what}: built in {time.perf_counter() - t0:.1f} s; 3 batches of "
        f"{B}; launches {launches}; memory {resident / 2**30:.2f} GiB "
        f"resident before the forwards, peak {peak / 2**30:.2f} GiB during "
        f"them")
    check_launches(failures, what, launches,
                   {k: 3 * v for k, v in R4R_SERVE.items()}, cases)
    for i, lg in enumerate(outs):
        if tuple(lg.shape) != (B, 2) or not bool(torch.isfinite(lg).all()):
            failures.append(f"{what} batch {i}: logits {tuple(lg.shape)}, "
                            f"finite={bool(torch.isfinite(lg).all())}")
    two = batches[0][:2]
    g_logits, g_cls = pred.embed(two)
    c_logits, c_cls = Predictor(build("cpu"), device="cpu",
                                dtype=torch.float32).embed(two)
    e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
    log(f"{what}: embed vs CPU float32: rel L2 err cls {e_cls:.3e}, logits "
        f"{e_logits:.3e} (tolerance {EMBED_REL_TOL})")
    if not (e_cls <= EMBED_REL_TOL and e_logits <= EMBED_REL_TOL):
        failures.append(f"{what}: embed vs CPU {e_cls:.3e} / {e_logits:.3e}")
    stages = serve_stages(torch, pred, batches[0])
    log(f"{what}: stages at B={B}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()))
    dt, windows = serve_rates(torch, {what: pred}, batches[0])[what]
    log(f"{what} throughput: {B / dt:.1f} tiles/s at B={B}, median of 7 "
        f"windows of 5 forwards (least {B / max(windows):.1f}, greatest "
        f"{B / min(windows):.1f}; forward {dt * 1e3:.2f} ms) on {card}")
    del pred, outs
    torch.cuda.empty_cache()

    # ---- training: gradients on 2 tiles with the same seeds, card bf16 on
    # both routes against the port's CPU float32 run (phase 4's bar) and
    # lean against default on the card (phase 7's) ----
    t0 = time.perf_counter()
    model = build("cuda")
    opt = train_lib.make_optimizer(
        model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
        frozen_label_fn=train_lib.backbone_frozen_labels)
    state = train_lib.init_train_state(model, opt)
    step = train_lib.make_train_step(model, dtype=torch.bfloat16)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    names, unheld = reg_grad_names(model)
    seeds = draw_seeds(model.transformer.num_seeds(),
                       torch.Generator().manual_seed(SEED))
    grads = functools.partial(two_tile_grads, torch, names=names,
                              image=batches[0][:2], seeds=seeds)
    g_card = {"default": grads(model, device="cuda",
                               dtype=torch.bfloat16)[0]}
    train_lib.set_backward_routes(model, **lean)
    g_card["lean"] = grads(model, device="cuda", dtype=torch.bfloat16)[0]
    train_lib.set_backward_routes(model)
    cpu_model = build("cpu")
    train_lib.make_train_step(cpu_model, dtype=torch.float32)
    g_cpu, _ = grads(cpu_model, device="cpu", dtype=torch.float32)
    del cpu_model
    errs = {r: {n: rel_err(g[n], g_cpu[n]) for n in names}
            for r, g in g_card.items()}
    route = {n: rel_err(g_card["lean"][n], g_card["default"][n])
             for n in names}
    log(f"R4r train: set up and gradients on 2 tiles, same seeds "
        f"({time.perf_counter() - t0:.1f} s); rel L2 err card bf16 vs CPU "
        f"float32 (default | lean routes, tolerance {GRAD_REL_TOL}) || lean "
        f"vs default routes on the card (tolerance {LEAN_ROUTE_TOL}); the "
        f"patch blocks' q/k norms printed, not held:")
    for n in names:
        log(f"  {n}: {errs['default'][n]:.3e} | {errs['lean'][n]:.3e} || "
            f"{route[n]:.3e}" + (" (not held)" if n in unheld else ""))
    for r, e in errs.items():
        failures += [f"R4r {r} gradient of {n}: {v:.3e}"
                     for n, v in e.items()
                     if n not in unheld and not v <= GRAD_REL_TOL]
    failures += [f"R4r gradient of {n} (lean vs default): {v:.3e}"
                 for n, v in route.items()
                 if n not in unheld and not v <= LEAN_ROUTE_TOL]
    del g_card, g_cpu

    # ---- 3 steps on each route, counted; tiles/s, split, memory ----
    for name, routes, bsz in (("default", {}, B), ("lean", lean, B_TRAIN)):
        what = f"R4r {name} train"
        train_lib.set_backward_routes(model, **routes)
        step = train_lib.make_train_step(model, dtype=torch.bfloat16,
                                         **routes)
        batches_t = [{"image": rng.integers(0, 256, (bsz, 224, 224, 3),
                                            dtype=np.uint8),
                      "label": rng.integers(0, 2, (bsz,))} for _ in range(3)]
        before = {n: t.detach().clone() for n, t in model.state_dict().items()}
        # the loss reaches neither the scale blocks' carried q/k norms nor
        # fc_norm (Q9, Q7): the L2 term moves their ones, not their zeros
        out[f"{what} (1 step)"] = three_steps(
            torch, fa, failures, what, model, state, step, batches_t,
            trainable, before, R4R_TRAIN[name], cases, ("_norm.bias",))
        del before
        time_step(torch, model, state, step, batches_t, card, what, 1)
        del batches_t
        torch.cuda.empty_cache()
    del model, state, step
    torch.cuda.empty_cache()

    # ---- R3r at depth 2: one counted step, gradients vs the CPU ----
    t0 = time.perf_counter()
    model = build("cuda", 3, R3R_DEPTH)
    opt = train_lib.make_optimizer(
        model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
        frozen_label_fn=train_lib.backbone_frozen_labels)
    state = train_lib.init_train_state(model, opt)
    step = train_lib.make_train_step(model, dtype=torch.bfloat16)
    names, unheld = reg_grad_names(model)
    seeds = draw_seeds(model.transformer.num_seeds(),
                       torch.Generator().manual_seed(SEED))
    grads = functools.partial(two_tile_grads, torch, names=names,
                              image=two, seeds=seeds)
    g_card, _ = grads(model, device="cuda", dtype=torch.bfloat16)
    cpu_model = build("cpu", 3, R3R_DEPTH)
    train_lib.make_train_step(cpu_model, dtype=torch.float32)
    g_cpu, _ = grads(cpu_model, device="cpu", dtype=torch.float32)
    del cpu_model
    errs = {n: rel_err(g_card[n], g_cpu[n]) for n in names}
    held = {n: e for n, e in errs.items() if n not in unheld}
    worst = max(held, key=held.get)
    log(f"R3r train (depth {R3R_DEPTH}): gradients on 2 tiles, same seeds, "
        f"card bf16 vs CPU float32 ({time.perf_counter() - t0:.1f} s): "
        f"worst {worst} {held[worst]:.3e} of {len(held)} tensors held "
        f"(tolerance {GRAD_REL_TOL}); the patch blocks' q/k norms, not "
        f"held: " + ", ".join(f"{n} {errs[n]:.3e}" for n in unheld))
    failures += [f"R3r gradient of {n}: {v:.3e}" for n, v in held.items()
                 if not v <= GRAD_REL_TOL]
    batch = {"image": rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8),
             "label": rng.integers(0, 2, (B,))}
    fa.reset_launch_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    log(f"R3r train: one step at B={B}, launches {launches}, loss "
        f"{float(m['loss']):.4f}")
    out["R3r train (1 step)"] = launches
    check_launches(failures, "R3r train step", launches, R3R_TRAIN, cases)
    if not np.isfinite(float(m["loss"])):
        failures.append(f"R3r train loss {float(m['loss'])}")
    del model, state, step
    torch.cuda.empty_cache()
    return out


def f32_phase(torch, port, fa, failures, card, cases):
    """Phase 13: the release DuoFormer in float32 on the card, with both
    TF32 flags True for the phase (the float32 entry points scope them
    off): R2f (2 scales, depth 12) served at B=64 and trained at B=128 on
    the default routes, R3f (3 scales, depth F32_R3_DEPTH) served at B=64,
    and the refusals of forms with no float32 kernel. -> {path: launch
    counts}."""
    from duoformer_tcga_tpu_torch import train as train_lib
    from duoformer_tcga_tpu_torch._device import float32_precision
    from duoformer_tcga_tpu_torch.inference import Predictor
    from duoformer_tcga_tpu_torch.models.transformer import ScaleBlock
    f32 = torch.float32
    out = {}

    def build(device, layers=2, depth=12):
        return port.build_model_no_extra_params(
            num_layers=layers, embed_dim=C, proj_dim=C, num_heads=HEADS,
            depth=depth, device=device, seed=SEED, dtype=f32)

    rng = np.random.default_rng(SEED + 13)
    batches = [rng.integers(0, 256, (B, 224, 224, 3), dtype=np.uint8)
               for _ in range(3)]
    two = batches[0][:2]

    # ---- serving: 3 forwards counted, embed() vs the CPU, tiles/s ----
    for what, layers, depth in (("R2f float32 serving", 2, 12),
                                ("R3f float32 serving", 3, F32_R3_DEPTH)):
        t0 = time.perf_counter()
        pred = Predictor(build("cuda", layers, depth), dtype=f32)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        outs = [pred(t) for t in batches]
        torch.cuda.synchronize()
        launches = dict(fa.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        out[f"{what} ({len(batches)} forwards)"] = launches
        log(f"{what} (depth {depth}): built in "
            f"{time.perf_counter() - t0:.1f} s; 3 batches of {B}; launches "
            f"{launches}; memory {resident / 2**30:.2f} GiB resident before "
            f"the forwards, peak {peak / 2**30:.2f} GiB during them")
        check_launches(failures, what, launches,
                       {k: len(batches) * depth for k in F32_SERVE}, cases)
        for i, lg in enumerate(outs):
            if (tuple(lg.shape) != (B, 2) or lg.dtype != f32
                    or not bool(torch.isfinite(lg).all())):
                failures.append(f"{what} batch {i}: logits "
                                f"{tuple(lg.shape)} {lg.dtype}, finite="
                                f"{bool(torch.isfinite(lg).all())}")
        g_logits, g_cls = pred.embed(two)
        c_logits, c_cls = Predictor(build("cpu", layers, depth),
                                    device="cpu", dtype=f32).embed(two)
        e_cls, e_logits = rel_err(g_cls, c_cls), rel_err(g_logits, c_logits)
        log(f"{what}: embed vs CPU float32: rel L2 err cls {e_cls:.3e}, "
            f"logits {e_logits:.3e} (tolerance {F32_EMBED_REL_TOL})")
        if not (e_cls <= F32_EMBED_REL_TOL and e_logits <= F32_EMBED_REL_TOL):
            failures.append(f"{what}: embed vs CPU {e_cls:.3e} / "
                            f"{e_logits:.3e}")
        if layers == 2:
            dt, windows = serve_rates(torch, {what: pred}, batches[0],
                                      n=2)[what]
            log(f"{what} throughput: {B / dt:.1f} tiles/s at B={B}, median "
                f"of 7 windows of 2 forwards (least {B / max(windows):.1f}, "
                f"greatest {B / min(windows):.1f}; forward {dt * 1e3:.2f} "
                f"ms) on {card}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del pred, outs
        torch.cuda.empty_cache()

    # ---- training: gradients on 2 tiles vs the CPU, 3 steps counted,
    # tiles/s, split, memory ----
    what = "R2f float32 train"
    t0 = time.perf_counter()
    model = build("cuda")
    opt = train_lib.make_optimizer(
        model, train_lib.onecycle_schedule(1e-4, 1000), weight_decay=1e-4,
        frozen_label_fn=train_lib.backbone_frozen_labels)
    state = train_lib.init_train_state(model, opt)
    step = train_lib.make_train_step(model, dtype=f32)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    names = grad_check_names(model)
    with float32_precision(f32):
        g_card, _ = two_tile_grads(torch, model, names, two, None, "cuda",
                                   f32)
    cpu_model = build("cpu")
    train_lib.make_train_step(cpu_model, dtype=f32)
    g_cpu, _ = two_tile_grads(torch, cpu_model, names, two, None, "cpu", f32)
    del cpu_model
    errs = {n: rel_err(g_card[n], g_cpu[n]) for n in names}
    worst = max(errs, key=errs.get)
    log(f"{what}: set up and gradients on 2 tiles "
        f"({time.perf_counter() - t0:.1f} s), card float32 vs CPU float32, "
        f"rel L2 err of {len(errs)} tensors (tolerance {F32_GRAD_REL_TOL}), "
        f"worst {worst} {errs[worst]:.3e}:")
    for n, e in errs.items():
        log(f"  {n}: {e:.3e}")
    failures += [f"{what} gradient of {n}: {e:.3e}" for n, e in errs.items()
                 if not e <= F32_GRAD_REL_TOL]
    del g_card, g_cpu
    batches_t = [{"image": rng.integers(0, 256, (B_TRAIN, 224, 224, 3),
                                        dtype=np.uint8),
                  "label": rng.integers(0, 2, (B_TRAIN,))} for _ in range(3)]
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    # the loss does not reach fc_norm (Q7): the L2 term moves its ones, not
    # its zeros
    out[f"{what} (1 step)"] = three_steps(
        torch, fa, failures, what, model, state, step, batches_t, trainable,
        before, {k: 12 for k in F32_TRAIN}, cases, ("fc_norm.bias",))
    del before
    time_step(torch, model, state, step, batches_t, card, what, 1, f32)
    del model, state, step, batches_t
    torch.cuda.empty_cache()

    # ---- refusals: forms with no float32 kernel ----
    for what, S, kw in (("a float32 R4r block", 86,
                         dict(init_values=1e-5, attn_drop=DROP,
                              mlp_drop=DROP)),
                        ("a float32 86-token block", 86, {})):
        blk = ScaleBlock(C, HEADS, generator=torch.Generator().manual_seed(
            SEED), **kw).cuda().eval()
        x = torch.randn(2, S, C, device="cuda")
        try:
            with torch.no_grad():
                blk(x)
            msg = None
        except NotImplementedError as e:
            msg = str(e)
        log(f"refusal of {what}: {msg!r}")
        if msg is None or "B5a" not in msg:
            failures.append(f"{what} did not raise NotImplementedError "
                            f"naming B5a: {msg!r}")
    return out


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
            f"(atol=rtol={res.get('tol', TOL)}), branch rel L2 err "
            f"{res['rel_err']:.4g} (<= {res.get('rel_tol', BRANCH_REL_TOL)}; "
            f"branch rms {res['branch_rms']:.3g}) "
            f"{'ok' if res['ok'] else 'FAIL'}"
            + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
               f"ms, library {res['library_ms']:.4f} ms, bound "
               f"{res['bound_ms']:.4f} ms ({res['bound_by']})"
               if "ms" in res else "")
            + (f"; bf16 mismatch fraction {res['mismatch']:.3g}"
               if "mismatch" in res else "")
            + (f"; second launch bit-identical {res['repeat_identical']}"
               if "repeat_identical" in res else "")
            + (f"; finite {res['finite']}, rows past a guarded output "
               f"untouched {res['guard_untouched']}, its rows the "
               f"wrapper's {res['guarded_equal']}"
               if "guard_untouched" in res else "")
            + (f"; chunks {res['chunks']}" if "chunks" in res else "")
            + (f"; vs the float32-input plain version: rel L2 err "
               f"{res['f32_rel_err']:.4g} (<= {BRANCH_REL_TOL}), max_abs_err "
               f"{res['f32_max_abs_err']:.6g}, elementwise bar alone "
               f"{'passes' if res['f32_close'] else 'fails'} ("
               f"{'held' if res.get('f32_bars_held') else 'not held'})"
               if "f32_rel_err" in res else "")
            + (f"; vs the dw=False route {res['vs_dw_false']:.4g}"
               if "vs_dw_false" in res else "")
            + (f"; rounding points: dqkv vs the bf16-input plain version "
               f"{res['vs_twin']:.4g} (<= {ROUND_REL_TOL})"
               if "vs_twin" in res else "")
            + (f"; device memory beyond dx, the sums and the weight "
               f"gradients {res['extra_bytes'] / 1e6:.1f} MB"
               if "extra_bytes" in res else ""))
        for out, r in res.get("outputs", {}).items():
            log(f"  {out}: max_abs_err {r['max_abs_err']:.6g}, rel L2 err "
                f"{r['rel_err']:.4g} {'ok' if r['ok'] else 'FAIL'}")
        if not res["ok"]:
            failures.append(f"kernel check {name}")
    for label in ("fused_attention_residual_bwd_long_dw",
                  "fused_attention_residual_bwd_long_dw n_seg=1024 S=197"):
        res = cases.get(label) or others[label]
        log(f"the 197-token dw form's extra device memory ({label}): "
            f"{res['extra_bytes'] / 1e6:.1f} MB (bar "
            f"{DW_EXTRA_BYTES / 1e6:.0f} MB)")
        if not res["extra_bytes"] <= DW_EXTRA_BYTES:
            failures.append(f"{label} held {res['extra_bytes'] / 1e6:.1f} "
                            f"MB of scratch")
    for dw_form, label in (
            ("fused_attention_residual_bwd_s86_dw",
             "fused_attention_residual_bwd_s86"),
            ("fused_attention_residual_bwd_s86_reg_dw",
             "fused_attention_residual_bwd_s86_reg proj dropout + gamma (gm) "
             "n_seg=3136"),
            ("fused_attention_residual_bwd_s86_reg_dw proj dropout + gamma "
             "n_seg=6272", None)):
        dw86 = cases.get(dw_form) or others[dw_form]
        rows = (cases.get(label) or others[label]) if label else None
        log(f"the 86-token dw form's extra device memory ({dw_form}) at "
            f"n_seg {B_TRAIN * 49}: {dw86['extra_bytes'] / 1e6:.1f} MB (bar "
            f"{DW_EXTRA_BYTES / 1e6:.0f} MB)" + (
                f", against {rows['extra_bytes'] / 1e6:.1f} MB of row-space "
                f"tensors and scratch on the dw=False route ({label})"
                if rows else ""))
        if not dw86["extra_bytes"] <= DW_EXTRA_BYTES:
            failures.append(f"{dw_form} held "
                            f"{dw86['extra_bytes'] / 1e6:.1f} MB of scratch")

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 3. the serving path ----
    torch.cuda.reset_peak_memory_stats()    # its own peak, not phase 2's
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

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 5. int8 serving, beside the bf16 Predictor of phase 3 ----
    int8_launches = int8_phase(torch, port, fa, failures, card, cases,
                               dict(pred=pred, stages=stages))
    del pred
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 4. the training step ----
    train_launches = train_phase(torch, port, fa, failures, card)
    torch.cuda.empty_cache()
    check_launches(failures, "train step", train_launches,
                   {k: 12 for k in TRAINING_FORMS}, cases)

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 6. the legacy family: serving and training ----
    legacy_serve, legacy_train = legacy_phase(torch, port, fa, failures,
                                              card, cases, others)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 7. the memory-lean training steps; the block-diagonal op ----
    lean_launches = lean_phase(torch, port, fa, failures, card, cases)
    op_launches = block_attention_op_path(torch, fa, failures)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 8. 3- and 4-scale serving, bf16 and int8 ----
    scales_launches = scales_phase(torch, port, fa, failures, card, cases)

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 9. 3- and 4-scale training, default and memory-lean routes ----
    scales_train_launches = scales_train_phase(torch, port, fa, failures,
                                               card, cases)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 10. the ViT-B/16 baseline: serving and training ----
    vit_launches = vit_phase(torch, port, fa, failures, card, cases)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 11. the ResNetV2 hybrid baselines: serving and training ----
    hybrid_launches = hybrid_phase(torch, port, fa, failures, card, cases)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 12. the regularised release DuoFormer (R4r, R3r) ----
    reg_launches = reg_scales_phase(torch, port, fa, failures, card, cases)
    torch.cuda.empty_cache()

    log(f"at {time.perf_counter() - t_start:.0f} s")
    # ---- 13. float32: serving and training, TF32 on around the phase ----
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        f32_launches = f32_phase(torch, port, fa, failures, card, cases)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    paths = {f"serve ({len(batches)} forwards)": launches,
             "train (1 step)": train_launches,
             f"serve int8 ({len(batches)} forwards)": int8_launches,
             "legacy serve (3 forwards)": legacy_serve,
             "legacy train (1 step)": legacy_train, **lean_launches,
             "block_diag_attention op (2 calls)": op_launches,
             **scales_launches, **scales_train_launches, **vit_launches,
             **hybrid_launches, **reg_launches, **f32_launches}
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
