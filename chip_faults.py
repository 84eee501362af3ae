#!/usr/bin/env python3
"""Plant faults in copies of the port's CUDA kernels and show that the
kernel checks of chip_smoke.py fail on each.

    python3 chip_faults.py

For each fault in FAULTS, copies chip_smoke.py and duoformer_tcga_tpu_torch/
(without its build directory) into duoformer_tcga_tpu_torch/_build/faults/
<name>/, changes one place in one kernel source (or the header the
kernels share) there, and runs chip_smoke.kernel_checks (untimed, TF32
off) on the cases of the named kernel form's source, from that copy, in
a process of its own, at most PARALLEL at once (the reg cases' plain
versions hold several GB of mask counters each). The fault "none"
changes nothing, runs every case and is the control. Prints, per fault
and case, whether the case passed, its relative L2 error, and whether the
elementwise atol = rtol = 0.08 bar alone passed it. Exits non-zero when
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
ATTN = f"{PKG}/csrc/fused_attention_residual.cu"
MLP = f"{PKG}/csrc/fused_mlp_residual.cu"
BWD = f"{PKG}/csrc/fused_attention_residual_bwd.cu"
DZ = f"{PKG}/csrc/mlp_dz.cu"
ATTN8 = f"{PKG}/csrc/fused_attention_residual_int8.cu"
MLP8 = f"{PKG}/csrc/fused_mlp_residual_int8.cu"
TILE = f"{PKG}/csrc/tile_ops.cuh"
HASH = f"{PKG}/csrc/dropout_hash.cuh"
EW = f"{PKG}/csrc/drop_ew.cu"
MLPB = f"{PKG}/csrc/fused_mlp_bwd.cu"
LN = f"{PKG}/csrc/layernorm.cu"
BDA = f"{PKG}/csrc/block_diag_attention.cu"
PARALLEL = 8

# name: (file, text, replacement, the kernel form whose cases must fail
# [, why the checks may pass it])
FAULTS = {
    "none": (None, None, None, None),
    "uniform softmax": (
        ATTN, "e[u] = in[u] ? expf(sv[u] - mx) : 0.f;",
        "e[u] = in[u] ? 1.f : 0.f;", "fused_attention_residual"),
    "scores not scaled": (
        ATTN, "sS[r * Sh::S_LD + c] * scale", "sS[r * Sh::S_LD + c]",
        "fused_attention_residual"),
    "mask spans the block": (
        ATTN, "in[u] = live && c >= c0 && c < c0 + S;", "in[u] = c < R;",
        "fused_attention_residual"),
    "last head skipped": (
        ATTN, "    } else {\n      // ---- 6.",
        "    } else if (h != Sh::H - 1) {\n      // ---- 6.",
        "fused_attention_residual"),
    "relu for gelu": (
        MLP, "a0 = 0.5f * z0 * (1.f + erff(z0 * 0.70710678118654752f));",
        "a0 = fmaxf(z0, 0.f);", "fused_mlp_residual"),
    "last hidden chunk skipped": (
        MLP, "    } else {\n      // ---- 3.",
        "    } else if (s / S::SLABS != hidden / HC - 1) {\n      // ---- 3.",
        "fused_mlp_residual"),
    "z written after gelu": (
        MLP, "zout + (row0 + row) * hidden + c0 + col) =\n"
             "                    __floats2bfloat162_rn(z0, z1);",
        "zout + (row0 + row) * hidden + c0 + col) =\n"
        "                    __floats2bfloat162_rn(a0, a1);",
        "fused_mlp_residual_z"),
    "rowsum(dp p) dropped": (
        BWD, "pv[u] * (dpv[u] - rs) * scale", "pv[u] * dpv[u] * scale",
        "fused_attention_residual_bwd"),
    "ds not scaled": (
        BWD, "pv[u] * (dpv[u] - rs) * scale", "pv[u] * (dpv[u] - rs)",
        "fused_attention_residual_bwd"),
    "dq and dk swapped": (
        BWD, "QKV_LD + which * D +", "QKV_LD + (1 - which) * D +",
        "fused_attention_residual_bwd"),
    "LN backward mean terms dropped": (
        BWD, "istd[m][hr] * (dxh - m1[m][hr] - xh * m2[m][hr])",
        "istd[m][hr] * dxh", "fused_attention_residual_bwd"),
    "last head's dqkv skipped": (
        BWD, "h * D + seg * 8) =\n          *reinterpret_cast<const uint4*>(",
        "h * D + seg * 8) = h == Sh::H - 1 ? make_uint4(0, 0, 0, 0) :\n"
        "          *reinterpret_cast<const uint4*>(",
        "fused_attention_residual_bwd"),
    "gelu for gelu'": (
        DZ, "const float d0 = p0 + zf.x * (INV_SQRT_2PI * expf(-0.5f * zf.x "
            "* zf.x));\n        const float d1 = p1 + zf.y * (INV_SQRT_2PI "
            "* expf(-0.5f * zf.y * zf.y));",
        "const float d0 = zf.x * p0;\n        const float d1 = zf.y * p1;",
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
        BWD, "dpv[u] = keep_mask(hseed, (uint32_t)(row0 + r),",
        "dpv[u] = keep_mask(hseed, (uint32_t)r,",
        "fused_attention_residual_bwd_reg"),
    "arithmetic shift in the hash": (
        HASH, "return (x >> 8) < thr;",
        "return (uint32_t)((int32_t)x >> 8) < thr;", "drop_ew_gm"),
    "MLP output dropout salted as the hidden's": (
        MLP, "make_drop(seed, SITE_MLP_OUT, drop_thr, drop_scale)",
        "make_drop(seed, SITE_MLP_HID, drop_thr, drop_scale)",
        "fused_mlp_residual_reg"),
    "softmax Jacobian on the dropped p (reg backward)": (
        BWD, "pv[u] = c < RT ? sS[r * Sh::S_LD + c] : 0.f;",
        "pv[u] = c < RT ? __bfloat162float(sP[r * Sh::P_LD + c]) : 0.f;",
        "fused_attention_residual_bwd_reg"),
    "gamma left out of geff (reg backward)": (
        BWD, "      v.x = __fmul_rn(v.x, gamma[col]);\n"
             "      v.y = __fmul_rn(v.y, gamma[col + 1]);\n", "",
        "fused_attention_residual_bwd_reg"),
    "dz reads dh through bf16 (drop_ew)": (
        EW, "const float dd = keep ? d[e] * drop.scale : 0.f;",
        "const float dd = keep ? __bfloat162float(__float2bfloat16(d[e])) "
        "* drop.scale : 0.f;", "drop_ew_dz"),
    "one hidden chunk left out of dln (MLP backward)": (
        MLPB, "          mma16816(acc[m][2 * k], a, b[0], b[1]);\n"
              "          mma16816(acc[m][2 * k + 1], a, b[2], b[3]);",
        "          if (chunk != 1) {\n"
        "          mma16816(acc[m][2 * k], a, b[0], b[1]);\n"
        "          mma16816(acc[m][2 * k + 1], a, b[2], b[3]);\n"
        "          }", "fused_mlp_bwd"),
    "z phi(z) dropped from gelu' (MLP backward)": (
        MLPB, "(phi + z * (INV_SQRT_2PI * expf(-0.5f * z * z)))", "phi",
        "fused_mlp_bwd"),
    "dwA against g where gm is due (dw form)": (
        BWD, "        if (pdrop.on) {                    "
             "// gacc = bf16(g * mask / keep)",
        "        if (false) {", "fused_attention_residual_bwd_reg_dw"),
    "ragged last row tile left out of dwqkv (dw form)": (
        BWD, "    if (dw)\n      for (int mt = warp; mt < C / 16; "
             "mt += WARPS) {",
        "    if (dw && !(R < RT && blockIdx.x + 1 == gridDim.x))\n"
        "      for (int mt = warp; mt < C / 16; mt += WARPS) {",
        "fused_attention_residual_bwd_dw"),
    "bias left out (LayerNorm)": (
        LN, "(v[2 * i] - mean) * inv * lns[c + 2 * i] + lnb[c + 2 * i],",
        "(v[2 * i] - mean) * inv * lns[c + 2 * i],", "fused_layernorm"),
    "score mask spans two segments (block_diag_attention)": (
        BDA, "in[u] = live && c >= c0 && c < c0 + S;",
        "in[u] = live && c >= c0 - S && c < c0 + S;",
        "block_diag_attention"),
}

CHILD = """
import json, sys, torch, torch.nn.functional as F
import chip_smoke
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
assert fa.__file__.startswith(chip_smoke.HERE), fa.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
form = sys.argv[1] or None
cases, others = chip_smoke.kernel_checks(
    torch, F, fa, timed=False,
    source=chip_smoke.SOURCES[form] if form else None)
print(json.dumps({**cases, **others}))
"""


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
    dirs = {name: plant(name, f) for name, f in FAULTS.items()}
    names = list(dirs)
    procs, done = {}, {}

    def start(name):
        procs[name] = subprocess.Popen([sys.executable, "-c", CHILD,
                                        FAULTS[name][3] or ""],
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
                  f"rel err {r['rel_err']:.4g}, atol=rtol=0.08 alone "
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
