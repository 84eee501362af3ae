#!/usr/bin/env python3
"""Plant faults in copies of the port's CUDA kernels and show that the
kernel checks of chip_smoke.py fail on each.

    python3 chip_faults.py [word ...]

With words, only the faults whose names contain one of them run, and the
control runs only the cases of their kernel forms' sources. For each
fault in FAULTS, copies chip_smoke.py and duoformer_tcga_tpu_torch/
(without its build directory) into duoformer_tcga_tpu_torch/_build/faults/
<name>/, changes one place in one kernel source (or the header the
kernels share, or train.py) there, and runs chip_smoke.kernel_checks
(untimed, TF32 off) on the cases of the named kernel form's source (for
train.py chip_smoke.trunk_trains_case, phase 11's check that every
tensor of the hybrid, its trunk's too, moves in training), from that copy, in
a process of its own, at most PARALLEL at once (the reg cases' plain
versions hold several GB of mask counters each, and 8 processes of the
attention source's 72 cases ran the card out of memory). The fault "none"
changes nothing, runs every case and is the control. Prints, per fault
and case, whether the case passed, its relative L2 error, and whether the
elementwise bar alone (atol = rtol = 0.08; 1e-4 for the float32
forms) passed it. Exits non-zero when
the control fails a case or a fault passes every case of its kernel form,
unless the fault names why the checks may pass it (then it is listed
under "passed_as_allowed"). Needs one CUDA device and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "duoformer_tcga_tpu_torch"
WORK = os.path.join(HERE, PKG, "_build", "faults")
MLP = f"{PKG}/csrc/fused_mlp_residual.cu"
BWD = f"{PKG}/csrc/attention_bwd_sm90.cu"
ROWS = f"{PKG}/csrc/chain_rows.cuh"
DZ = f"{PKG}/csrc/mlp_dz.cu"
ATTN8 = f"{PKG}/csrc/fused_attention_residual_int8.cu"
MLP8 = f"{PKG}/csrc/fused_mlp_residual_int8.cu"
TILE = f"{PKG}/csrc/tile_ops.cuh"
HASH = f"{PKG}/csrc/dropout_hash.cuh"
EW = f"{PKG}/csrc/drop_ew.cu"
MLPB = f"{PKG}/csrc/fused_mlp_bwd.cu"
LN = f"{PKG}/csrc/layernorm.cu"
GEMM = f"{PKG}/csrc/gemm_sm90.cuh"
A90 = f"{PKG}/csrc/attention_sm90.cu"
ATTN886 = f"{PKG}/csrc/fused_attention_residual_int8_s86.cu"
REG_GRAD = f"{PKG}/csrc/reg_grad.cuh"
TRAIN = f"{PKG}/train.py"
F32 = f"{PKG}/csrc/f32_tile.cuh"
ATTN32 = f"{PKG}/csrc/fused_attention_residual_f32.cu"
# the pseudo-form whose case trains the R50ViT hybrid (chip_smoke.
# trunk_trains_case) where a fault of train.py shows
TRUNK = "hybrid_trunk_trains"
CHUNK_LOOP = "for (int ci = 0; ci < nchunks; ++ci) {"
# the attention core's key mask (csrc/attention_sm90.cu): key t of a strip
# is live for query r only in r's segment, [k0, k0 + S)
KEY_MASK = ("sc[j] = key >= k0 && key < k0 + S ? __fmul_rn(sc[j], scale)\n"
            "                                        : -CUDART_INF_F;")
GROUP_TOK = "const uint32_t tok0 = tok_base + (uint32_t)seg * (uint32_t)S;"
# the backward core's ds, cast once (csrc/attention_bwd_sm90.cu)
DS_PACK = ("pack_bf16(sc[j] * (dp[j] - r) * scale,\n"
           "                                          sc[j + 1] * (dp[j + 1] "
           "- r) * scale);")
STRIP_CALL = "strip_attention<RT>(sQKV, QKV_LD, warp, S, scale, lane);"
PARALLEL = 4

# name: (file, text, replacement, the kernel form whose cases must fail
# [, why the checks may pass it])
FAULTS = {
    "none": (None, None, None, None),
    "uniform softmax (attn)": (
        A90, "sc[j] = exp_sfu(__fsub_rn(sc[j], mx[(j >> 1) & 1]));",
        "sc[j] = sc[j] > -CUDART_INF_F ? 1.f : 0.f;",
        "fused_attention_residual"),
    "scores not scaled (attn)": (
        A90, KEY_MASK, KEY_MASK.replace("__fmul_rn(sc[j], scale)", "sc[j]"),
        "fused_attention_residual"),
    "mask spans the strip (attn)": (
        A90, KEY_MASK, KEY_MASK.replace("key >= k0 && key < k0 + S",
                                        "key < NK"),
        "fused_attention_residual"),
    "last head skipped (attn)": (
        A90, "    if (64 * m + r < live) {",
        "    if (64 * m + r < live && h != C / HD - 1) {",
        "fused_attention_residual"),
    "relu for gelu (mlp)": (
        GEMM, "float a0 = gelu(acc[c8 * 4 + 2 * hr] + bb.x);",
        "float a0 = fmaxf(acc[c8 * 4 + 2 * hr] + bb.x, 0.f);",
        "fused_mlp_residual"),
    "last hidden chunk skipped (mlp)": (
        GEMM, "st_shared(tile_addr + out_offset(r, col), pack_bf16(a0, a1));",
        "st_shared(tile_addr + out_offset(r, col),\n"
        "                      n0 + BN == g.N ? 0u : pack_bf16(a0, a1));",
        "fused_mlp_residual"),
    "z written after gelu (mlp)": (
        GEMM, "pack_bf16(acc[c8 * 4 + 2 * hr] + bb.x,\n"
              "                          acc[c8 * 4 + 2 * hr + 1] + bb.y)",
        "pack_bf16(gelu(acc[c8 * 4 + 2 * hr] + bb.x),\n"
        "                          gelu(acc[c8 * 4 + 2 * hr + 1] + bb.y))",
        "fused_mlp_residual_z"),
    "last k-tile of the TMA ring skipped (mlp)": (
        GEMM, "  const int ktiles = (g.K + R::KT - 1) / R::KT;",
        "  const int ktiles = (g.K + R::KT - 1) / R::KT - 1;",
        "fused_mlp_residual"),
    "second row chunk's masks from chunk-local rows (mlp)": (
        MLP, "make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale),\n"
             "                    (uint32_t)row0};",
        "make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale),\n"
        "                    (uint32_t)0};", "fused_mlp_residual_reg"),
    "rowsum(dp p) dropped": (
        BWD, "const float r = rs[(j >> 1) & 1];", "const float r = 0.f;",
        "fused_attention_residual_bwd"),
    "ds not scaled": (
        BWD, DS_PACK, DS_PACK.replace(" * scale", ""),
        "fused_attention_residual_bwd"),
    "dq and dk swapped": (
        BWD, "  stage_frags(dq, qa, warp, lane);\n"
             "  stage_frags(dk, ka, warp, lane);",
        "  stage_frags(dk, qa, warp, lane);\n"
        "  stage_frags(dq, ka, warp, lane);", "fused_attention_residual_bwd"),
    "LN backward mean terms dropped": (
        ROWS, "out[e] = istd * (dxh - m1 - xs[e] * m2);",
        "out[e] = istd * dxh;", "fused_attention_residual_bwd"),
    "last head's dqkv skipped": (
        BWD, "  for (int w = 0; w < 3; ++w)\n    store_tile(",
        "  for (int w = 0; w < 3 * (h != C / HD - 1); ++w)\n    store_tile(",
        "fused_attention_residual_bwd"),
    "gelu for gelu'": (
        GEMM, "  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +\n"
              "         z * (0.39894228040143268f * expf(-0.5f * z * z));",
        "  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));",
        "mlp_dz"),
    "o row scale from the first head's columns": (
        ATTN8, "        amax = fmaxf(amax, fmaxf(fabsf(v[i].x), fabsf(v[i].y)));",
        "        if (i == 0) amax = fmaxf(amax, fmaxf(fabsf(v[i].x), "
        "fabsf(v[i].y)));", "fused_attention_residual_int8"),
    "qkv column scale dropped": (
        ATTN8, "const float cs0 = sqkv[gcol], cs1 = sqkv[gcol + 1];",
        "const float cs0 = 1.f, cs1 = 1.f;", "fused_attention_residual_int8"),
    "last head skipped (int8)": (
        ATTN8, "    if (j == Sh::QSLABS - 1) {",
        "    if (j == Sh::QSLABS - 1 && h != Sh::H - 1) {",
        "fused_attention_residual_int8"),
    "h row scale from the first 128-wide chunk": (
        MLP8, "amax[m][hr] = fmaxf(amax[m][hr], fmaxf(fabsf(a0), fabsf(a1)));",
        "if (sl.chunk == 0) amax[m][hr] = fmaxf(amax[m][hr], "
        "fmaxf(fabsf(a0), fabsf(a1)));", "fused_mlp_residual_int8"),
    "fc1 column scale dropped": (
        MLP8, "const float cs0 = s1[c0 + col], cs1 = s1[c0 + col + 1];",
        "const float cs0 = 1.f, cs1 = 1.f;", "fused_mlp_residual_int8"),
    "half to even for away from zero (int8)": (
        TILE, "roundf(v / scale)", "rintf(v / scale)",
        "fused_mlp_residual_int8",
        "exact ties k + 0.5 of the row scale are rare in float32 data; "
        "tests/test_torch_port_int8.py::test_rowquant_matches_jax_bit_for_bit"
        " guards the rounding on built ties"),
    "block-local row counter of the dp mask (reg backward)": (
        BWD, "dp[j] = (keep >> j) & 1u ? dp[j] * drop.scale : 0.f;",
        "dp[j] = keep_mask(drop.seed_plus, 16 * warp + g + 8 * ((j >> 1) & "
        "1),\n                         tok0 + 8 * (j >> 2) + 2 * t + (j & 1),"
        "\n                         drop.thr) ? dp[j] * drop.scale : 0.f;",
        "fused_attention_residual_bwd_reg"),
    "arithmetic shift in the hash": (
        HASH, "return (x >> 8) < thr;",
        "return (uint32_t)((int32_t)x >> 8) < thr;", "drop_ew_gm"),
    "mlp output dropout salted as the hidden's": (
        MLP, "make_drop(seed, SITE_MLP_OUT, drop_thr, drop_scale)",
        "make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale)",
        "fused_mlp_residual_reg"),
    "softmax Jacobian on the dropped p (reg backward)": (
        BWD, "  // ---- o = p v and dp = do v^T ----",
        "  for (int j = 0; j < 32; ++j)\n"
        "    sc[j] = __bfloat162float(__float2bfloat16(\n"
        "        (keep >> j) & 1u ? sc[j] * drop.scale : 0.f));",
        "fused_attention_residual_bwd_reg"),
    "gamma left out of geff (reg backward)": (
        REG_GRAD, "      v.x = __fmul_rn(v.x, gamma[col]);\n"
             "      v.y = __fmul_rn(v.y, gamma[col + 1]);\n", "",
        "fused_attention_residual_bwd_reg"),
    "dz reads dh through bf16 (drop_ew)": (
        EW, "const float dd = keep ? d[e] * drop.scale : 0.f;",
        "const float dd = keep ? __bfloat162float(__float2bfloat16(d[e])) "
        "* drop.scale : 0.f;", "drop_ew_dz"),
    # the MLP backward (csrc/fused_mlp_bwd.cu): its dln product is the
    # shared header's float32 product with w1 read K-major (EPI_F32, BT),
    # hidden columns 128..255 its k-tiles 2 and 3
    "one hidden chunk left out of dln (MLP backward)": (
        GEMM, "          wgmma<AT, !BT>(acc,",
        "          if (EPI != EPI_F32 || !BT || kt / 2 != 1)\n"
        "          wgmma<AT, !BT>(acc,", "fused_mlp_bwd"),
    "z phi(z) dropped from gelu' (MLP backward)": (
        MLPB, "slope = Phi + z * phi;", "slope = Phi;", "fused_mlp_bwd"),
    "b1 dropped from z (MLP backward)": (
        MLPB, "const float2 bb = *reinterpret_cast<const float2*>(b1 + n0 + "
              "col);", "const float2 bb = make_float2(0.f, 0.f);",
        "fused_mlp_bwd"),
    "w2 read as stored instead of K-major (MLP backward)": (
        MLPB, "wgmma<0, 0>(dacc, desc128(a + kk * 32, 16, 1024),\n"
              "                      desc128(b + kk * 32, 16, 1024),",
        "wgmma<0, 1>(dacc, desc128(a + kk * 32, 16, 1024),\n"
        "                      desc128(b + kk * 2048, 8192, 1024),",
        "fused_mlp_bwd"),
    "last chunk of rows left out of the column sums (MLP backward)": (
        MLPB, "return sum_rows(sc.chunk_sums, nchunks, 3 * C,",
        "return sum_rows(sc.chunk_sums, nchunks - 1, 3 * C,",
        "fused_mlp_bwd"),
    "g not added to dx (MLP backward)": (
        MLPB, "sc.part, n, 1, 1,", "sc.part, n, 1, 0,", "fused_mlp_bwd"),
    "LN backward's mean term dropped (MLP backward)": (
        ROWS, "out[e] = istd * (dxh - m1 - xs[e] * m2);",
        "out[e] = istd * (dxh - xs[e] * m2);", "fused_mlp_bwd"),
    "dwA against g where gm is due (dw form)": (
        BWD, "const bf16* gacc = gmc != nullptr ? gmc : gc;",
        "const bf16* gacc = gc;", "fused_attention_residual_bwd_reg_dw"),
    "ragged last rows of a chunk left out of dwqkv (dw form)": (
        BWD, "GemmArgs w{C, 3 * C, rows, nullptr};",
        "GemmArgs w{C, 3 * C, rows / 64 * 64, nullptr};",
        "fused_attention_residual_bwd_dw"),
    "bias left out (LayerNorm)": (
        LN, "(v[2 * i] - mean) * inv * lns[c + 2 * i] + lnb[c + 2 * i],",
        "(v[2 * i] - mean) * inv * lns[c + 2 * i],", "fused_layernorm"),
    "score mask spans two segments (attn block_diag_attention)": (
        A90, KEY_MASK, KEY_MASK.replace("key >= k0 &&", "key >= k0 - S &&"),
        "block_diag_attention"),
    "score mask sees the padding rows 86..95 (int8 s86)": (
        ATTN886, STRIP_CALL, STRIP_CALL.replace(", S,", ", RT,"),
        "fused_attention_residual_int8_s86"),
    "o row scale from its first 128 columns only (int8 s86 proj)": (
        ATTN886, "          amax = fmaxf(amax, fmaxf(fabsf(v[u][i].x), "
                 "fabsf(v[u][i].y)));",
        "          if (2 * (lane + 32 * i) < BN)\n"
        "            amax = fmaxf(amax, fmaxf(fabsf(v[u][i].x), "
        "fabsf(v[u][i].y)));",
        "fused_attention_residual_int8_s86_proj"),
    "query rows at or past S taken into dk and dv (s86 backward)": (
        BWD, "sc[j] = rlive[(j >> 1) & 1] ? __fmul_rn(sc[j], inv[(j >> 1) "
             "& 1]) : 0.f;", "sc[j] = __fmul_rn(sc[j], inv[(j >> 1) & 1]);",
        "fused_attention_residual_bwd_s86"),
    "softmax Jacobian on the bf16 p (s86 backward)": (
        BWD, "  return p * (d - r) * scale;",
        "  return __bfloat162float(__float2bfloat16(p)) * (d - r) * scale;",
        "fused_attention_residual_bwd_s86"),
    "head 1's dq over head 0's columns (s86 backward)": (
        BWD, "store_tile(stg, dqkv + h * HD, 3 * C, live, tid);",
        "store_tile(stg, dqkv + (h == 1 ? 0 : h) * HD, 3 * C, live, tid);",
        "fused_attention_residual_bwd_s86"),
    "last chunk of segments skipped (s86 dw form)": (
        BWD, CHUNK_LOOP,
        "for (int ci = 0; ci < nchunks - (dw ? 1 : 0); ++ci) {",
        "fused_attention_residual_bwd_s86_dw"),
    "keys at or past S not masked (long backward)": (
        BWD, "sc[j] = key < S ? __fmul_rn(sc[j], scale) : -CUDART_INF_F;",
        "sc[j] = key < NK ? __fmul_rn(sc[j], scale) : -CUDART_INF_F;",
        "fused_attention_residual_bwd_long"),
    "key strips skip the last query strip (long backward)": (
        BWD, "for (int qs = 0; qs < ql; ++qs) {",
        "for (int qs = 0; qs < ql - 1; ++qs) {",
        "fused_attention_residual_bwd_long"),
    "last chunk of segments skipped (long dw form)": (
        BWD, CHUNK_LOOP,
        "for (int ci = 0; ci < nchunks - (dw ? 1 : 0); ++ci) {",
        "fused_attention_residual_bwd_long_dw"),
    "a key tile left out of the row sums (long backward)": (
        BWD, "for (int kt = 0; kt < KT; ++kt) {   // the row sums' key tiles",
        "for (int kt = 0; kt < KT - 1; ++kt) {",
        "fused_attention_residual_bwd_long"),
    "query rows at or past S taken into the key pass (long backward)": (
        BWD, "if (klv[hr] && q < S)", "if (klv[hr])",
        "fused_attention_residual_bwd_long"),
    "dq from the first key tile only (long backward)": (
        BWD, "for (int kt = 0; kt < KT; ++kt) {   // ds and dq's key tiles",
        "for (int kt = 0; kt < 1; ++kt) {",
        "fused_attention_residual_bwd_long"),
    "the second key strip's dk not stored (long backward)": (
        BWD, "store_tile(stg, dqkv + row + C + h * HD, 3 * C, klive, tid);",
        "store_tile(stg, dqkv + row + C + h * HD, 3 * C, ks == 1 ? 0 : klive,"
        " tid);", "fused_attention_residual_bwd_s86"),
    "last 128 output columns' product dropped at C=384 (attn proj)": (
        GEMM, "float y0 = acc[c8 * 4 + 2 * hr] + bb.x;",
        "float y0 = (g.N == 384 && n0 == 256 ? 0.f : acc[c8 * 4 + 2 * hr])"
        " + bb.x;", "fused_attention_residual_c384"),
    "last 128 input columns skipped at C=384 (mlp fc1)": (
        GEMM, "  const int ktiles = (g.K + R::KT - 1) / R::KT;",
        "  const int ktiles = (g.K + R::KT - 1) / R::KT - (EPI == EPI_GELU && "
        "g.K == 384 ? 2 : 0);",
        "fused_mlp_residual_c384"),
    "last head's dwqkv dropped at C=384 (dw form)": (
        GEMM, "            if (row >= M) continue;",
        "            if (row >= M || (EPI == EPI_ACC && N == 3 * 384 &&\n"
        "                             col % 384 >= 320))\n"
        "              continue;", "fused_attention_residual_bwd_dw_c384"),
    "segment mask dropped: queries attend across packed segments (bwd)": (
        BWD, KEY_MASK, KEY_MASK.replace("key >= k0 && key < k0 + S",
                                        "key < live"),
        "fused_attention_residual_bwd"),
    "ds^T q read with ds K-major, the wrong major-ness (bwd)": (
        BWD, "wgmma_ss<1, 1>(dk, desc128(dst + kk * 2048, 8192, 1024),",
        "wgmma_ss<0, 1>(dk, desc128(dst + kk * 32, 16, 1024),",
        "fused_attention_residual_bwd"),
    "dropout tokens counted from the strip, not globally (bwd)": (
        BWD, "scale, hdrop, tok_base + (uint32_t)row0, attn + row0 * C,",
        "scale, hdrop, 0u, attn + row0 * C,",
        "fused_attention_residual_bwd_reg"),
    "dw accumulation skips the last chunk (bwd dw form)": (
        BWD, "    if (dw) {\n      GemmArgs w{",
        "    if (dw && ci + 1 < nchunks) {\n      GemmArgs w{",
        "fused_attention_residual_bwd_dw"),
    "p dropped for o and dv but dp not (s86 reg backward)": (
        BWD, "        dp[j] = (keep[j >> 5] >> (j & 31)) & 1u ? dp[j] * "
             "drop.scale : 0.f;\n", "",
        "fused_attention_residual_bwd_s86_reg"),
    "the masks at segment-local tokens (s86 reg backward)": (
        BWD, "tok0 + 64 * m + 16 * warp + g + 8 * ((j >> 1) & 1);\n"
             "      const uint32_t kt = tok0 + 8",
        "64 * m + 16 * warp + g + 8 * ((j >> 1) & 1);\n"
        "      const uint32_t kt = 8",
        "fused_attention_residual_bwd_s86_reg"),
    "dwA from geff instead of gm (s86 reg dw form)": (
        BWD, "w, stream, attnc, gacc)));", "w, stream, attnc, gsrc)));",
        "fused_attention_residual_bwd_s86_reg_dw"),
    "key mask dropped (attn)": (
        A90, KEY_MASK, "sc[j] = __fmul_rn(sc[j], scale);",
        "fused_attention_residual_s86"),
    "segment mask dropped: queries attend across packed segments (attn)": (
        A90, KEY_MASK, KEY_MASK.replace("key >= k0 && key < k0 + S",
                                        "key < live"),
        "fused_attention_residual"),
    "a short last unit's segments taken as G (attn)": (
        A90, "const int live = min(G, n_seg - seg) * S;",
        "const int live = G * S;", "block_diag_attention"),
    "dropout tokens counted from the strip, not globally (attn)": (
        A90, GROUP_TOK, "const uint32_t tok0 = 0u;",
        "fused_attention_residual_reg"),
    "masks from chunk-local tokens (attn reg core)": (
        A90, "(uint32_t)seg0 * (uint32_t)S, (long)cap_rows,",
        "0u, (long)cap_rows,",
        "fused_attention_residual_s86_reg"),
    "mask counters from the unit's padded rows (attn reg core)": (
        A90, GROUP_TOK, GROUP_TOK.replace("(uint32_t)S;", "(uint32_t)NK;"),
        "fused_attention_residual_s86_reg"),
    "last k-step of P.V skipped (attn)": (
        A90, "for (int kb = 0; kb < NK / 16; ++kb)\n    wgmma_pv(",
        "for (int kb = 0; kb < NK / 16 - 1; ++kb)\n    wgmma_pv(",
        "block_diag_attention_long"),
    "qkv bias left out of the epilogue (attn)": (
        GEMM, "    const float2 bb = bias == nullptr ? make_float2(0.f, 0.f)\n"
              "        : *reinterpret_cast<const float2*>(bias + n0 + col);",
        "    const float2 bb = make_float2(0.f, 0.f);",
        "fused_attention_residual_s86"),
    "core's tensor map over its buffer's capacity (attn)": (
        A90, "tensor_map(&tm, qkv, 3 * H * HD, n_seg * S, NK)",
        "tensor_map(&tm, qkv, 3 * H * HD, (int)cap_rows, NK)",
        "block_diag_attention_long"),
    "core's tensor map over the scratch's capacity, packed units (attn)": (
        A90, "tensor_map(&tm, qkv, 3 * H * HD, n_seg * S, NK)",
        "tensor_map(&tm, qkv, 3 * H * HD, (int)cap_rows, NK)",
        "block_diag_attention"),
    "head 1's o over head 0's columns (attn)": (
        A90, "(row0 + 64 * m + r) * C + h * HD +",
        "(row0 + 64 * m + r) * C + (h == 1 ? 0 : h) * HD +",
        "fused_attention_residual_s86"),
    "last query strip skipped (attn)": (
        A90, "for (int m = PACKED ? 0 : cw; m < strips; m += 2)",
        "for (int m = PACKED ? 0 : cw; m < strips - 1; m += 2)",
        "fused_attention_residual_long"),
    "residual left out (attn proj)": (
        GEMM, "if (g.use_residual && row < g.M) {", "if (false) {",
        "fused_attention_residual_s86_proj"),
    "gamma left out (attn reg proj)": (
        GEMM, "            if (g.gamma != nullptr) {\n"
              "              y0 = __fmul_rn",
        "            if (false) {\n              y0 = __fmul_rn",
        "fused_attention_residual_s86_proj_reg"),
    "single-pass TF32 in the scores product (f32)": (
        F32, "        k[i] = *reinterpret_cast<const float4*>(kg + (j0 + i) * "
             "TL_LD + d);",
        "        k[i] = *reinterpret_cast<const float4*>(kg + (j0 + i) * "
        "TL_LD + d);\n"
        "        for (int u = 0; u < 4; ++u) {\n"
        "          float* qu = reinterpret_cast<float*>(&q[i]) + u;\n"
        "          float* ku = reinterpret_cast<float*>(&k[i]) + u;\n"
        "          *qu = __uint_as_float(__float_as_uint(*qu) & 0xffffe000u);\n"
        "          *ku = __uint_as_float(__float_as_uint(*ku) & 0xffffe000u);\n"
        "        }",
        "fused_attention_residual_f32"),
    "the full form without its LayerNorm (f32)": (
        ATTN32, "  if (use_ln) {", "  if (false) {",
        "fused_attention_residual_f32"),
    "the hi-lo term dropped (f32)": (
        GEMM, "            wgmma_tf32(part, ahi, blo, kk > 0);\n"
              "            wgmma_tf32(part, alo, bhi, 1);",
        "            wgmma_tf32(part, alo, bhi, kk > 0);",
        "fused_attention_residual_f32"),
    "the weights' lo plane left out (f32)": (
        ATTN32, "    j.lo[at] = lo;", "    j.lo[at] = 0.f;",
        "fused_attention_residual_f32"),
    "the last k-step skipped in the float32 product (f32)": (
        GEMM, "for (int kk = 0; kk < R::KT / 8; ++kk) {",
        "for (int kk = 0; kk < R::KT / 8 - 1; ++kk) {",
        "fused_attention_residual_f32"),
    "z read from the next column tile (mlp_dz)": (
        GEMM, "&tmZ, n0, mt0, &zfull[cw]);\n"
              "          tma_load(const_cast<uint8_t*>(tile) + 8192, &tmZ, "
              "n0 + 64, mt0,",
        "&tmZ, n0 + BN, mt0, &zfull[cw]);\n"
        "          tma_load(const_cast<uint8_t*>(tile) + 8192, &tmZ, "
        "n0 + BN + 64, mt0,", "mlp_dz"),
    "the last row tile's db1 partial left out (mlp_dz)": (
        DZ, "for (int b = 0; b < nb; ++b) s += part[(long)b * width + j];",
        "for (int b = 0; b < nb - 1; ++b) s += part[(long)b * width + j];",
        "mlp_dz"),
    "db1 without the ragged last chunk of rows (f32 mlp_dz)": (
        F32, "const long r1 = r0 + COLSUM_ROWS < rows ? r0 + COLSUM_ROWS : "
             "rows;",
        "const long r1 = r0 + COLSUM_ROWS <= rows ? r0 + COLSUM_ROWS : r0;",
        "mlp_dz_f32"),
    "dv from the unnormalised probabilities (f32 backward)": (
        F32, "dv = fmaf(se[j * SL + r] * sinv[j], sdo[j * ATT_LD + d], dv);",
        "dv = fmaf(se[j * SL + r], sdo[j * ATT_LD + d], dv);",
        "fused_attention_residual_bwd_f32"),
    "the hybrid's trunk frozen by the optimizer": (
        TRAIN, "        labels = frozen_label_fn(params) if frozen_label_fn "
               "else {}",
        "        labels = {n: \"frozen\" for n, _ in params.named_parameters()"
        "\n                  if \".backbone.\" in n}", TRUNK),
}

CHILD = """
import json, sys, torch, torch.nn.functional as F
import chip_smoke
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
assert fa.__file__.startswith(chip_smoke.HERE), fa.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
form = sys.argv[1] or None
if form == "%s":
    import duoformer_tcga_tpu_torch as port
    print(json.dumps(chip_smoke.trunk_trains_case(torch, port)))
    sys.exit(0)
if form is None and len(sys.argv) > 2:     # the control, on some sources
    results = {}
    for src in dict.fromkeys(chip_smoke.SOURCES[f]
                             for f in sys.argv[2].split(",")):
        cases, others = chip_smoke.kernel_checks(torch, F, fa, timed=False,
                                                 source=src)
        results.update(cases)
        results.update(others)
    print(json.dumps(results))
    sys.exit(0)
cases, others = chip_smoke.kernel_checks(
    torch, F, fa, timed=False,
    source=chip_smoke.SOURCES[form] if form else None)
print(json.dumps({**cases, **others}))
""" % TRUNK


def plant(name, fault):
    path, text, repl = fault[:3]
    dst = os.path.join(WORK, name.replace(" ", "_"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), dst)
    if path:
        src = open(os.path.join(dst, path)).read()
        if src.count(text) != 1:
            raise SystemExit(f"{name}: the text to change occurs "
                             f"{src.count(text)} times in {path}")
        with open(os.path.join(dst, path), "w") as f:
            f.write(src.replace(text, repl))
    return dst


def main() -> int:
    words = sys.argv[1:]
    chosen = {name: f for name, f in FAULTS.items()
              if not words or name == "none" or any(w in name for w in words)}
    dirs = {name: plant(name, f) for name, f in chosen.items()}
    names = list(dirs)
    procs, done = {}, {}
    # the control runs every case, or with words the cases of the chosen
    # faults' kernel forms' sources (the hybrid trunk's case has none)
    forms = [f[3] for n, f in chosen.items() if f[3] not in (None, TRUNK)]
    control = [",".join(forms)] if words else []

    def start(name):
        procs[name] = subprocess.Popen([sys.executable, "-c", CHILD,
                                        FAULTS[name][3] or "",
                                        *(control if name == "none"
                                          else [])],
                                       cwd=dirs[name],
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)

    for name in names[:PARALLEL]:
        start(name)
    for i, name in enumerate(names):
        done[name] = procs[name].communicate(timeout=900)
        if i + PARALLEL < len(names):
            start(names[i + PARALLEL])
    bad, passed_as_allowed = [], []
    for name, proc in procs.items():
        out, err = done[name]
        if proc.returncode != 0:
            print(f"{name}: the checks did not run (exit {proc.returncode})"
                  f"\n{err[-3000:]}", flush=True)
            bad.append(name)
            continue
        results = json.loads(out.strip().splitlines()[-1])
        kernel = FAULTS[name][3]
        mine = [c for c in results if c.split(" ")[0] == kernel]
        for case, r in results.items():
            print(f"{name} | {case}: {'ok' if r['ok'] else 'FAIL'}, branch "
                  f"rel err {r['rel_err']:.4g}, the elementwise bar alone "
                  f"{'passes' if r['close'] else 'fails'}", flush=True)
        if kernel is None and not all(r["ok"] for r in results.values()):
            bad.append(name)
        if kernel and all(results[c]["ok"] for c in mine):
            if len(FAULTS[name]) > 4:
                print(f"{name}: passed the checks, as it may: "
                      f"{FAULTS[name][4]}", flush=True)
                passed_as_allowed.append(name)
            else:
                bad.append(name)
    print(json.dumps({"faults_not_caught": bad,
                      "passed_as_allowed": passed_as_allowed}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
