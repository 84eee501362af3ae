"""The port's fused transformer kernels, their plain PyTorch versions,
their launch counts and the autograd functions built on them (counterpart
of duoformer_tcga_tpu/ops/pallas_attention.py, inert forms; the reg forms'
flags are keyword arguments of the same wrappers, whose autograd functions
and the drop_ew kernel are in ops/fused_reg.py).

  fused_attention_residual: y = [x +] proj(block-diag attn(qkv([LN] x)))
    kernels: csrc/attention_sm90.cu (on csrc/gemm_sm90.cuh): the core (o =
    block-diag attn(qkv([LN] x)), with the attention dropout up to 86
    tokens: a chain over chunks of segments, attention_seg_chunks, of a
    LayerNorm pass, the TMA/wgmma qkv product and the wgmma attention
    core, whose units pack unit_segments(S) whole segments up to 64
    tokens) and the proj (y = [x +] gamma * drop(proj(o)), the same
    product); up to 64 tokens both inside this one wrapper call, for 65 to
    197 (the 4-scale model's 86, the ViT's 197) two wrapper calls,
    attention_core_s86 or attention_core_long, then attention_proj
  fused_attention_residual_bwd: its backward (dx, ln, attn, dqkv and the
    column sums dlns, dlnb, dbqkv, dbproj), recomputing the forward; a
    chain of launches over chunks of segments (LN, the qkv and dattn
    products, the attention backward core, the dln product, the LN
    backward; in the dw form the weight-gradient products): up to 64
    tokens csrc/attention_bwd_sm90.cu (one C entry a call, the products
    on csrc/gemm_sm90.cuh, the core on packed units of unit_segments(S)
    whole segments, chunks from attention_bwd_seg_chunks); for 65 to 86
    csrc/fused_attention_residual_bwd_s86.cu; for 87 to 197 the same chain
    around csrc/attention_long.cu's backward core (both chains' launches
    in csrc/attention_chain.cuh)
  fused_mlp_residual:       y = [x +] fc2(gelu_erf(fc1(LN x))), and with
    return_hidden=True also the pre-GELU hidden z
    kernel: csrc/fused_mlp_residual.cu (per chunk of rows, mlp_row_chunks:
    a LayerNorm pass, then fc1 with GELU and fc2 with the residual, each
    csrc/gemm_sm90.cuh's TMA-fed wgmma product, through a bf16 scratch)
  mlp_dz:                   dz = (g w2^T) * gelu'(z), db1 = colsum(dz)
    kernel: csrc/mlp_dz.cu
  fused_mlp_bwd:            the MLP backward from x (no saved hidden): dx,
    ln, h, dz and the column sums dlns, dlnb
    kernel: csrc/fused_mlp_bwd.cu (one C entry a call, per chunk of rows,
    mlp_bwd_row_chunks: LN with its statistics, one wgmma product for z
    and dh writing h and dz, the dln product, the LN backward, the sums)
  block_diag_attention_fwd: softmax(q k^T * scale) v within each segment
    kernel: csrc/attention_sm90.cu's wgmma core

`attention_residual`, `mlp_residual` and `block_diag_attention` are the
differentiable entries (the JAX package's custom_vjp entries). The
attention backward runs its kernel and then the weight-gradient products
dwqkv = ln^T dqkv and dwproj = attn^T g, or with bwd_dw=True (the JAX
package's DUOFORMER_BWD_DW=1) the kernel's dw form, which forms both
itself. The MLP backward is the save-hidden one (pallas_attention.py:
1802-1852), with the dz pass as a kernel and the four large products as
plain matmuls, as the JAX package leaves them to XLA; or, with
save_hidden=False (DUOFORMER_MLP_SAVE_HIDDEN=0), the recompute-from-x
kernel and the two weight-gradient products (_fmr_bwd, :1870-1894).
block_diag_attention's backward is autograd through its plain version.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises (wrong dtype,
shape or layout, a failed build, a refused launch). There is no fallback
from the kernel to the plain version.

The kernels take bf16 activations and weights (linear weights (in, out),
as in the JAX package) and float32 vectors (LayerNorm scale/bias, biases),
the types the JAX path feeds its kernels. The plain versions round where
the TPU kernels round (each function's docstring and kernel source say
where).

Float32 on the card (the JAX package's dtype float32, ROADMAP B5a): a
float32 CUDA tensor reaching fused_attention_residual,
fused_attention_residual_bwd (dw=False), fused_mlp_residual (both forms)
or mlp_dz launches its float32 form, every operand float32, inert, at up
to 64 tokens a segment and C in F32_C (csrc/*_f32.cu, chains of the
float32 FMA tiles of csrc/f32_tile.cuh); its launch counts under the
form's name + "_f32" (the bare forms then + "_bare"). Every other form
raises NotImplementedError from _build.f32_form; nothing falls back to the
plain version.

The reg forms (pallas_attention.py:1119-1281, 1894-1946) are the same
kernels with runtime flags: gamma (LayerScale, float32 [C]) and an int32
dropout seed with its rates, up to ATTN_SERVE_MAX_SEG_LEN tokens a segment
for the attention branch and its backward (at 65..86 the core takes the
attention dropout, the proj gamma and the proj dropout, and the backward
chain all three). Their masks are ops/dropout.py's, which the kernels
compute with the same hash (csrc/dropout_hash.cuh); a wrapper given gamma
or a dropout rate counts its launch under the form's "_reg" name (the
65..86-token core only for the attention dropout, which is all it takes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import dropout as dr
from ._build import (F32_C, _check_tensor, _ptr, _require, _stream,
                     count_launch, f32_form, launch_counts)
from .nn import layernorm

# up to this many tokens the attention core packs whole segments into its
# 64-row units (csrc/attention_sm90.cu, and the backward's core in
# csrc/attention_bwd_sm90.cu), and both take C in SHORT_C
ATTN_MAX_SEG_LEN = 64
# the forward, bf16 and int8, and the backward in both forms also take
# 65..86 tokens (the bf16 forward csrc/attention_sm90.cu, the others one
# 96-row block a segment, csrc/*_s86.cu); so do the reg flags, which stop
# there
ATTN_SERVE_MAX_SEG_LEN = 86
# the bf16 forward, the backward in both forms and block_diag_attention
# take up to 197 tokens (ViT-B/16 at 224^2: 196 patches + CLS;
# csrc/attention_sm90.cu, csrc/attention_long.cu); int8 stops at
# ATTN_SERVE_MAX_SEG_LEN
ATTN_LONG_MAX_SEG_LEN = 197
HEAD_DIM = 64                 # the attention kernel's head width
SUPPORTED_C = (256, 512, 768)   # widths every kernel is instantiated for
# ... and 384 (ViT-S, the R26-S/32 hybrid's 6 heads) where instantiated:
# the seg_len <= 64 attention forward and backward (both forms), the MLP
# forward (serving and z forms), mlp_dz and the recompute-from-x MLP
# backward; a launch at 384 counts under its form's name + "_c384"
SHORT_C = (256, 384, 512, 768)
# fused_mlp_residual's bf16 kernel holds two scratches for a chunk of rows,
# the LayerNorm [rows, C] and the post-GELU hidden [rows, hidden] in bf16,
# together at most this many bytes (csrc/fused_mlp_residual.cu)
MLP_SCRATCH_BYTES = 192 << 20
MLP_ROW_TILE = 128            # the kernel's output tile rows
# fused_mlp_bwd's chain holds a float32 scratch for a chunk of rows, dln
# [rows, C], the LN statistics and the LN backward's partial rows, at most
# this many bytes (csrc/fused_mlp_bwd.cu; mlp_bwd_scratch_bytes)
MLP_BWD_SCRATCH_BYTES = 192 << 20
# the attention core's chain holds two scratches for a chunk of whole
# segments, the LayerNorm [rows rounded up to MLP_ROW_TILE, C] (full form)
# and qkv [rows, 3C] in bf16, together at most this many bytes
# (csrc/attention_sm90.cu). Chunks small enough to keep qkv in the 50 MB L2
# were slower on the card at 86 and 197 tokens (more launches and tails;
# PERF.md §6)
ATTN_SCRATCH_BYTES = 192 << 20


def reset_launch_counts():
    launch_counts.clear()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def attention_core_plain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                         seg_len, scale, ln_eps=1e-6, use_ln=True, seed=0,
                         attn_drop=0.0):
    """Plain twin of the 65..86-token core kernel, and the first half of
    fused_attention_residual_plain: x [n_seg, seg_len, C] -> o [n_seg,
    seg_len, C] in x's dtype, every head's output in its columns (the
    attention only within each segment). Dropout of the float32
    probabilities before their cast."""
    n_seg, S, C = x.shape
    if S != seg_len:
        raise ValueError(f"x has {S} tokens per segment, seg_len={seg_len}")
    dt = x.dtype
    D = C // num_heads
    ln = layernorm(x, ln_scale, ln_bias, ln_eps) if use_ln else x
    qkv = (torch.matmul(ln.float(), wqkv.float()) + bqkv.float()).to(dt)
    q, k, v = qkv.view(n_seg, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if attn_drop > 0.0:
        p = dr.drop(p, dr.attn_keep_masks(n_seg, S, num_heads, seed,
                                          attn_drop, x.device), attn_drop)
    o = torch.matmul(p.to(dt).float(), v.float()).to(dt)   # [n, H, S, D]
    return o.permute(0, 2, 1, 3).reshape(n_seg, S, C)


def attention_proj_plain(o, x, wproj, bproj, use_residual=True, gamma=None,
                         seed=0, proj_drop=0.0):
    """Plain twin of the proj kernel, and the second half of
    fused_attention_residual_plain: o, x [..., C] -> y = [x +] gamma *
    drop(o wproj + bproj) in x's dtype, accumulated in float32 and cast
    once (dropout at the global row and column)."""
    C = o.shape[-1]
    y = torch.matmul(o.float(), wproj.float()) + bproj.float()
    if proj_drop > 0.0:
        y = dr.drop(y, dr.row_keep_mask(o.numel() // C, C, seed,
                                        dr._SITE_PROJ, proj_drop,
                                        x.device).view(y.shape), proj_drop)
    if gamma is not None:
        y = y * gamma.float()
    if use_residual:
        y = y + x.float()
    return y.to(x.dtype)


def fused_attention_residual_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                   bproj, num_heads, seg_len, scale,
                                   ln_eps=1e-6, use_ln=True,
                                   use_residual=True, gamma=None, seed=0,
                                   attn_drop=0.0, proj_drop=0.0):
    """Plain twin of the attention kernel (pallas_attention.py:311-439 /
    _fused_block_xla, with the reg flags _fused_block_reg_xla :1156-1197):
    x [n_seg, seg_len, C]; attention only within each segment. Dropout of
    the float32 probabilities before their cast, of proj + bias, then
    times gamma, then the residual. It is attention_core_plain followed by
    attention_proj_plain, the two kernels of the 65..86-token form."""
    o = attention_core_plain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                             seg_len, scale, ln_eps, use_ln, seed, attn_drop)
    return attention_proj_plain(o, x, wproj, bproj, use_residual, gamma,
                                seed, proj_drop)


def fused_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                             ln_eps=1e-6, use_residual=True,
                             return_hidden=False, gamma=None, seed=0,
                             drop=0.0):
    """Plain twin of the MLP kernel (pallas_attention.py:1306-1396, with
    the reg flags _fused_mlp_reg_xla :1903-1936): exact-erf GELU in
    float32 from the unrounded z, dropped (site 2, global flat rows), the
    hidden rounded to x's dtype; fc2 + b2 dropped (site 3), times gamma,
    then the residual. return_hidden=True also returns z = fc1 + b1 [rows,
    hidden] rounded to x's dtype, before any dropout
    (_fused_mlp_kernel_z)."""
    dt = x.dtype
    ln = layernorm(x, ln_scale, ln_bias, ln_eps)
    z = torch.matmul(ln.float(), w1.float()) + b1.float()
    h = torch.nn.functional.gelu(z, approximate="none")
    C, hidden = x.shape[-1], z.shape[-1]
    rows = x.numel() // C if C else 0
    if drop > 0.0:
        h = dr.drop(h, dr.row_keep_mask(rows, hidden, seed, dr._SITE_MLP_HID,
                                        drop, x.device).view(h.shape), drop)
    y = torch.matmul(h.to(dt).float(), w2.float()) + b2.float()
    if drop > 0.0:
        y = dr.drop(y, dr.row_keep_mask(rows, C, seed, dr._SITE_MLP_OUT, drop,
                                        x.device).view(y.shape), drop)
    if gamma is not None:
        y = y * gamma.float()
    if use_residual:
        y = y + x.float()
    if return_hidden:
        return y.to(dt), z.to(dt).reshape(-1, z.shape[-1])
    return y.to(dt)


def ln_fwd_f32(xf, ln_scale, ln_bias, ln_eps):
    """LayerNorm of float32 rows -> (y, xhat, 1/std), float32
    (pallas_attention.py:694-699)."""
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + ln_eps)
    xhat = (xf - mean) * inv
    return xhat * ln_scale.float() + ln_bias.float(), xhat, inv


def ln_bwd_f32(dln, ln_scale, xhat, inv):
    """Cotangent through y = xhat * scale + bias for rows [N, C] -> (dx,
    column sums of dln * xhat and of dln), float32
    (pallas_attention.py:702-710)."""
    dxh = dln * ln_scale.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    return (inv * (dxh - m1 - xhat * m2), (dln * xhat).sum(0),
            dln.sum(0))


def fused_attention_residual_bwd_plain(x, g, ln_scale, ln_bias, wqkv, bqkv,
                                       wproj, num_heads, seg_len, scale,
                                       ln_eps=1e-6, use_ln=True,
                                       use_residual=True, gamma=None, seed=0,
                                       attn_drop=0.0, proj_drop=0.0,
                                       dw=False, seg0=0):
    """Plain twin of the attention backward kernel
    (_fused_block_bwd_kernel, dw=False, pallas_attention.py:723-918). x, g
    [n_seg, seg_len, C] -> (dx [n_seg, seg_len, C], ln [rows, C], attn
    [rows, C], dqkv [rows, 3C], dlns, dlnb, dbqkv, dbproj); the bare form's
    ln is x itself and its dlns, dlnb are zeros. Rounds where the kernel
    does: ln, qkv, p for P.V and dv, o, each head's dattn, ds * scale, dq,
    dk, dv; p stays float32 in ds, dln float32, dx rounded once.

    Reg flags (:809-905): geff = bf16(bf16(g * proj mask / keep) * gamma)
    feeds dattn; p for P.V and dv is dropped with the forward's mask, dp
    is dropped and rescaled, the Jacobian takes the undropped p; dbproj
    sums the float32 proj-masked g without gamma; the residual adds raw
    g. With proj_drop > 0 a ninth output gm = bf16(g * proj mask / keep)
    [rows, C].

    dw=True (the dw form, :885-895, 932-934): (dx, dlns, dlnb, dbqkv,
    dbproj, dwqkv, dwA) instead, dwqkv = ln^T dqkv [C, 3C] and dwA =
    attn^T (gm if proj_drop > 0 else g) [C, C], float32 sums of the
    rounded operands.

    seg0: the global index of x's first segment, where the masks count
    from (a caller that runs this over chunks of segments; 0 otherwise)."""
    n_seg, S, C = x.shape
    if S != seg_len:
        raise ValueError(f"x has {S} tokens per segment, seg_len={seg_len}")
    dt = x.dtype
    H = num_heads
    D = C // H
    rows = n_seg * S
    x2, g2 = x.reshape(rows, C), g.reshape(rows, C)
    gsum = g2.float()
    geff = g2
    if proj_drop > 0.0:
        gsum = dr.drop(gsum, dr.row_keep_mask(rows, C, seed, dr._SITE_PROJ,
                                              proj_drop, x.device,
                                              seg0 * S), proj_drop)
        geff = gm = gsum.to(dt)
    if gamma is not None:
        geff = (geff.float() * gamma.float()).to(dt)
    if use_ln:
        lnf, xhat, inv = ln_fwd_f32(x2.float(), ln_scale, ln_bias, ln_eps)
        ln = lnf.to(dt)
    else:
        ln = x2
    qkv = (torch.matmul(ln.float(), wqkv.float()) + bqkv.float()).to(dt)
    q, k, v = (t.float() for t in
               qkv.view(n_seg, S, 3, H, D).permute(2, 0, 3, 1, 4))
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    if attn_drop > 0.0:
        km = dr.attn_keep_masks(n_seg, S, H, seed, attn_drop, x.device,
                                seg0)
        pb = dr.drop(p, km, attn_drop).to(dt).float()
    else:
        pb = p.to(dt).float()
    attn = torch.matmul(pb, v).to(dt).permute(0, 2, 1, 3).reshape(rows, C)
    dattn = torch.matmul(geff.float(), wproj.float().t()).to(dt)
    do = dattn.float().view(n_seg, S, H, D).permute(0, 2, 1, 3)
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    if attn_drop > 0.0:
        dp = dr.drop(dp, km, attn_drop)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).to(dt)            # [3, n, H, S, D]
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(rows, 3 * C)
    dln = torch.matmul(dqkv.float(), wqkv.float().t())
    if use_ln:
        dxf, dlns, dlnb = ln_bwd_f32(dln, ln_scale, xhat, inv)
    else:
        dxf = dln
        dlns = dlnb = torch.zeros(C, dtype=torch.float32, device=x.device)
    if use_residual:
        dxf = dxf + g2.float()
    dx = dxf.to(dt).view(n_seg, S, C)
    if dw:
        gacc = gm if proj_drop > 0.0 else g2
        return (dx, dlns, dlnb, dqkv.float().sum(0), gsum.sum(0),
                torch.matmul(ln.float().t(), dqkv.float()),
                torch.matmul(attn.float().t(), gacc.float()))
    out = (dx, ln, attn, dqkv, dlns, dlnb, dqkv.float().sum(0), gsum.sum(0))
    return out + (gm,) if proj_drop > 0.0 else out


_SQRT1_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def mlp_dz_plain(g2, z, w2):
    """Plain twin of the dz kernel (_mlp_dz_kernel, emit_h=False,
    pallas_attention.py:1727-1748): g2 [rows, C], z [rows, hidden], w2
    [hidden, C] -> (dz [rows, hidden] in z's dtype, db1 [hidden] float32,
    the column sums of the rounded dz)."""
    zf = z.float()
    phi = 0.5 * (1.0 + torch.erf(zf * _SQRT1_2))
    dh = torch.matmul(g2.float(), w2.float().t())
    dgelu = phi + zf * (_INV_SQRT_2PI * torch.exp(-0.5 * zf * zf))
    dz = (dh * dgelu).to(z.dtype)
    return dz, dz.float().sum(0)


def fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2, ln_eps=1e-6):
    """Plain twin of the recompute-from-x MLP backward kernel
    (_fused_mlp_bwd_kernel, pallas_attention.py:1597-1631): x, g [..., C]
    -> (dx like x, ln [rows, C], h [rows, hidden], dz [rows, hidden], dlns,
    dlnb). LN in float32, ln rounded; z = ln w1 + b1 in float32; h =
    gelu(z) rounded from the float32 z; dz = (g w2^T) * gelu'(z) rounded;
    dln from the rounded dz; dx = LN backward + g, rounded once."""
    dt = x.dtype
    C = x.shape[-1]
    x2, g2 = x.reshape(-1, C), g.reshape(-1, C)
    lnf, xhat, inv = ln_fwd_f32(x2.float(), ln_scale, ln_bias, ln_eps)
    ln = lnf.to(dt)
    z = torch.matmul(ln.float(), w1.float()) + b1.float()
    phi = 0.5 * (1.0 + torch.erf(z * _SQRT1_2))
    h = (z * phi).to(dt)
    dh = torch.matmul(g2.float(), w2.float().t())
    dz = (dh * (phi + z * (_INV_SQRT_2PI * torch.exp(-0.5 * z * z)))).to(dt)
    dln = torch.matmul(dz.float(), w1.float().t())
    dxf, dlns, dlnb = ln_bwd_f32(dln, ln_scale, xhat, inv)
    return ((dxf + g2.float()).to(dt).view_as(x), ln, h, dz, dlns, dlnb)


def block_diag_attention_plain(qkv, num_heads, seg_len, scale):
    """Plain twin of the block-diagonal attention kernel (_kernel, the XLA
    reference _xla_reference, pallas_attention.py:175-216, 266-278): qkv
    [n_seg, seg_len, 3C], q | k | v with the heads contiguous -> [n_seg,
    seg_len, C]. Scores in float32 times scale, float32 softmax, p rounded
    to qkv's dtype for P.V, o rounded once."""
    n_seg, S, C3 = qkv.shape
    if S != seg_len:
        raise ValueError(f"qkv has {S} tokens per segment, seg_len={seg_len}")
    C = C3 // 3
    D = C // num_heads
    q, k, v = qkv.view(n_seg, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = torch.matmul(p.float(), v.float()).to(qkv.dtype)     # [n, H, S, D]
    return o.permute(0, 2, 1, 3).reshape(n_seg, S, C)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def attention_widths(seg_len):
    """The widths the attention kernels of seg_len are instantiated for:
    SHORT_C up to ATTN_MAX_SEG_LEN, SUPPORTED_C past it (the 65..86 and
    87..197-token kernels, and attention_proj)."""
    return SHORT_C if seg_len <= ATTN_MAX_SEG_LEN else SUPPORTED_C


def _check_width(C, what, widths=SUPPORTED_C):
    _require(C in widths,
             f"{what}: the kernel is instantiated for C in {widths}, "
             f"got {C}")


def int32_seed(seed) -> int:
    """A dropout seed as the kernels' signed 32-bit argument (the same
    32-bit word the plain versions hash)."""
    v = int(seed) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def drop_args(rate):
    """(keep threshold, keep scale) of a dropout site for a kernel call:
    (-1, 1.0) switches the site off (rate 0)."""
    if rate <= 0.0:
        return -1, 1.0
    _require(rate < 1.0, f"dropout rate {rate} must be below 1")
    return dr.keep_threshold(rate), dr.keep_scale(rate)


def _reg_name(name, gamma, *rates):
    return name + "_reg" if gamma is not None or any(
        r > 0.0 for r in rates) else name


def refuse_long_segments(what, seg_len, limit=ATTN_SERVE_MAX_SEG_LEN):
    """What runs only up to `limit` tokens a segment raises beyond it, on
    either device: the reg flags past ATTN_SERVE_MAX_SEG_LEN; the bf16
    forward, the backward (both forms) and block_diag_attention past
    ATTN_LONG_MAX_SEG_LEN."""
    if seg_len > limit:
        raise NotImplementedError(
            f"{what} at seg_len {seg_len} > {limit} is not ported to the "
            f"PyTorch package yet")


def _check_attention_x(x, seg_len, num_heads, what, max_len,
                       widths=SUPPORTED_C):
    """-> (n_seg, S, C) of a kernel's x [n_seg, seg_len, C]; the kernel
    is instantiated for C in `widths`."""
    _require(x.dim() == 3, f"x must be [n_seg, seg_len, C], got "
             f"{tuple(x.shape)}")
    n_seg, S, C = x.shape
    _require(S == seg_len, f"x has {S} tokens per segment, "
             f"seg_len={seg_len}")
    _require(1 <= S <= max_len,
             f"seg_len {S} outside the kernel's 1..{max_len}")
    _require(num_heads * HEAD_DIM == C,
             f"the kernel needs head width {HEAD_DIM}: C={C}, "
             f"num_heads={num_heads}")
    _check_width(C, what, widths)
    return n_seg, S, C


def fused_attention_residual(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                             num_heads, seg_len, scale, ln_eps=1e-6,
                             use_ln=True, use_residual=True, gamma=None,
                             seed=0, attn_drop=0.0, proj_drop=0.0):
    """y = [x +] proj(block_diag_attn(qkv([LN](x)))); x [n_seg, seg_len, C].

    The JAX signature (pallas_attention.py:1053). use_ln=use_residual=False
    is the bare form the patch blocks run. On the card: bf16 x and
    weights, float32 vectors, head width 64, C in attention_widths(seg_len)
    (384 only up to 64 tokens), seg_len <= 197 (up to 64 the core's chain
    and the proj, counted once; 65..86 in two wrapper calls,
    attention_core_s86 and attention_proj; 87..197 attention_core_long and
    attention_proj); or float32 x, weights and vectors, the float32 form
    (inert, seg_len <= 64, C in F32_C). gamma, seed, attn_drop, proj_drop:
    the reg form's LayerScale and dropout (fused_attention_residual_reg,
    pallas_attention.py:1202), seg_len <= 86 only."""
    reg = dict(gamma=gamma, seed=seed, attn_drop=attn_drop,
               proj_drop=proj_drop)
    if gamma is not None or attn_drop > 0.0 or proj_drop > 0.0:
        refuse_long_segments("the reg form (LayerScale, dropout) of "
                             "fused_attention_residual", seg_len)
    refuse_long_segments("fused_attention_residual", seg_len,
                         ATTN_LONG_MAX_SEG_LEN)
    if x.device.type == "cpu":
        return fused_attention_residual_plain(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads,
            seg_len, scale, ln_eps, use_ln, use_residual, **reg)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        return _fused_attention_residual_f32(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads,
            seg_len, scale, ln_eps, use_ln, use_residual,
            gamma is not None or attn_drop > 0.0 or proj_drop > 0.0)
    n_seg, S, C = _check_attention_x(
        x, seg_len, num_heads, "fused_attention_residual",
        ATTN_LONG_MAX_SEG_LEN, attention_widths(seg_len))
    if S > ATTN_SERVE_MAX_SEG_LEN:
        o = attention_core_long(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                                S, scale, ln_eps, use_ln)
        return attention_proj(o, x, wproj, bproj, use_residual)
    if S > ATTN_MAX_SEG_LEN:
        o = attention_core_s86(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                               S, scale, ln_eps, use_ln, seed, attn_drop)
        return attention_proj(o, x, wproj, bproj, use_residual, gamma, seed,
                              proj_drop)
    _check_proj_args(x, wproj, bproj, gamma)
    o = _attention_core_chain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                              scale, ln_eps, use_ln, seed, attn_drop,
                              "fused_attention_residual")
    out = _attention_proj_launch(o, x, wproj, bproj, use_residual, gamma,
                                 seed, proj_drop)
    name = _reg_name("fused_attention_residual", gamma, attn_drop, proj_drop)
    count_launch(name if use_ln else name + "_bare", C)
    return out


def _f32_scratch(*shape, device):
    return torch.empty(*shape, dtype=torch.float32, device=device)


def _fused_attention_residual_f32(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                  bproj, num_heads, seg_len, scale, ln_eps,
                                  use_ln, use_residual, reg):
    """fused_attention_residual's float32 form on the card
    (csrc/fused_attention_residual_f32.cu: LN, the qkv product, the
    attention core, the proj product with bias and residual, into float32
    scratch): every operand float32, inert, seg_len <= 64, C in F32_C;
    anything else raises NotImplementedError (f32_form)."""
    name = f32_form("fused_attention_residual", seg_len, x.shape[-1], reg)
    n_seg, S, C = _check_attention_x(x, seg_len, num_heads, name,
                                     ATTN_MAX_SEG_LEN, F32_C)
    dev, f32 = x.device, torch.float32
    for what, t, shape in (
            ("x", x, (n_seg, S, C)), ("ln_scale", ln_scale, (C,)),
            ("ln_bias", ln_bias, (C,)), ("wqkv", wqkv, (C, 3 * C)),
            ("bqkv", bqkv, (3 * C,)), ("wproj", wproj, (C, C)),
            ("bproj", bproj, (C,))):
        _check_tensor(what, t, dev, f32, shape)
    out = torch.empty_like(x)
    if n_seg == 0:
        return out
    rows = n_seg * S
    ln = _f32_scratch(rows, C, device=dev) if use_ln else None
    qkv = _f32_scratch(rows, 3 * C, device=dev)
    o = _f32_scratch(rows, C, device=dev)
    lib = _build.load_library("fused_attention_residual_f32")
    fn = lib.launch_fused_attention_residual_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv),
                    _ptr(bqkv), _ptr(wproj), _ptr(bproj), _ptr(out),
                    None if ln is None else _ptr(ln), _ptr(qkv), _ptr(o),
                    n_seg, S, C, num_heads, float(scale), float(ln_eps),
                    int(bool(use_ln)), int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, name)
    count_launch(name if use_ln else name + "_bare", C)
    return out


def attention_core_s86(x, ln_scale, ln_bias, wqkv, bqkv, num_heads, seg_len,
                       scale, ln_eps=1e-6, use_ln=True, seed=0,
                       attn_drop=0.0):
    """The first wrapper call of the 65..86-token attention branch: o =
    block_diag_attn(qkv([LN](x))), x [n_seg, seg_len, C] -> o [n_seg,
    seg_len, C], every head's output in its columns. On the card one call
    of _attention_core_chain, counted once: bf16 x and wqkv, float32
    vectors, head width 64, 65 <= seg_len <= 86. seed, attn_drop: the reg
    form's dropout of the probabilities (counted as
    "fused_attention_residual_s86_reg")."""
    if x.device.type == "cpu":
        return attention_core_plain(x, ln_scale, ln_bias, wqkv, bqkv,
                                    num_heads, seg_len, scale, ln_eps, use_ln,
                                    seed, attn_drop)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        f32_form("attention_core_s86", seg_len, x.shape[-1])
    _check_attention_x(x, seg_len, num_heads, "attention_core_s86",
                       ATTN_SERVE_MAX_SEG_LEN)
    _require(seg_len > ATTN_MAX_SEG_LEN, f"seg_len {seg_len}: the 86-token "
             f"kernel takes {ATTN_MAX_SEG_LEN + 1}..{ATTN_SERVE_MAX_SEG_LEN}")
    o = _attention_core_chain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                              scale, ln_eps, use_ln, seed, attn_drop,
                              "attention_core_s86")
    name = _reg_name("fused_attention_residual_s86", None, attn_drop)
    launch_counts[name if use_ln else name + "_bare"] += 1
    return o


def attention_core_long(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                        seg_len, scale, ln_eps=1e-6, use_ln=True):
    """The first wrapper call of the 87..197-token attention branch, as
    attention_core_s86: one call of _attention_core_chain, counted once:
    bf16 x and wqkv, float32 vectors, head width 64, 87 <= seg_len <=
    197."""
    if x.device.type == "cpu":
        return attention_core_plain(x, ln_scale, ln_bias, wqkv, bqkv,
                                    num_heads, seg_len, scale, ln_eps, use_ln)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        f32_form("attention_core_long", seg_len, x.shape[-1])
    _check_attention_x(x, seg_len, num_heads, "attention_core_long",
                       ATTN_LONG_MAX_SEG_LEN)
    _require(seg_len > ATTN_SERVE_MAX_SEG_LEN,
             f"seg_len {seg_len}: the long-segment chain takes "
             f"{ATTN_SERVE_MAX_SEG_LEN + 1}..{ATTN_LONG_MAX_SEG_LEN}")
    o = _attention_core_chain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                              scale, ln_eps, use_ln, 0, 0.0,
                              "attention_core_long")
    launch_counts["fused_attention_residual_long" if use_ln
                  else "fused_attention_residual_long_bare"] += 1
    return o


def attention_scratch_bytes(rows, C, use_ln=True):
    """The bytes of the attention core chain's scratch for a chunk of
    `rows` rows: qkv [rows, 3C] and, in the full form, the LayerNorm
    [rows rounded up to MLP_ROW_TILE, C], in bf16."""
    ln_rows = -(-rows // MLP_ROW_TILE) * MLP_ROW_TILE if use_ln else 0
    return 2 * (ln_rows * C + rows * 3 * C)


def attention_seg_chunks(n_seg, S, C, use_ln=True):
    """The segment chunks of one attention core call on the card:
    [(first segment, segments)], whole segments tiling [0, n_seg) in
    order, as few as keep each chunk's scratch (attention_scratch_bytes)
    within ATTN_SCRATCH_BYTES, of equal size but the last, that size a
    multiple of unit_segments(S) where the bound allows (so only the last
    chunk's last unit is short). A chunk's first token, first segment * S,
    is global: the attention dropout's masks count from it."""
    if n_seg <= 0:
        return []
    row = 2 * (4 if use_ln else 3) * C       # scratch bytes a row, unrounded
    most = max(1, ATTN_SCRATCH_BYTES // (row * S))
    while most > 1 and attention_scratch_bytes(most * S, C,
                                               use_ln) > ATTN_SCRATCH_BYTES:
        most -= 1
    n = -(-n_seg // most)
    size = -(-n_seg // n)
    G = unit_segments(S)
    if -(-size // G) * G <= most:
        size = -(-size // G) * G
    return [(s0, min(size, n_seg - s0)) for s0 in range(0, n_seg, size)]


def unit_segments(S):
    """The whole segments one unit of the attention core takes: up to
    ATTN_MAX_SEG_LEN tokens as many as its 64-row strip holds (10 at S=6,
    2 at 22, 1 at 50), past that one."""
    return ATTN_MAX_SEG_LEN // S if S <= ATTN_MAX_SEG_LEN else 1


def attention_seg_plan(n_seg, S, C, use_ln=True):
    """The core chain's plan on the card: [(first segment, segments, G)]
    for each chunk of attention_seg_chunks, G = unit_segments(S).
    csrc/attention_sm90.cu packs a chunk's segments into units from its
    first: unit group k holds the chunk's segments [k G, min(k G + G, n)),
    so only a chunk's last group may be short and none spans two
    chunks."""
    G = unit_segments(S)
    return [(s0, n, G)
            for s0, n in attention_seg_chunks(n_seg, S, C, use_ln)]


def attention_bwd_scratch_bytes(segs, S, C, dw, use_ln=True, geff=False,
                                gm=False):
    """The bytes of the backward chain's scratch up to 64 tokens
    (csrc/attention_bwd_sm90.cu's BwdScratch, in its order, each piece
    rounded up to 256 bytes) for a chunk of `segs` segments: qkv, dattn,
    the float32 dln, the LN statistics (full form), the LN backward's and
    the core's partial rows; the dw form's ln (full form), attn, dqkv and,
    with gm (the proj dropout on), gm; with geff (gamma given or the proj
    dropout on) the reg form's geff. The chunks' sums, 6C floats a chunk,
    come on top."""
    rows = segs * S
    pieces = [2 * rows * 3 * C, 2 * rows * C, 4 * rows * C]
    if use_ln:
        pieces.append(8 * rows)
    pieces += [4 * -(-rows // 64) * 3 * C,
               4 * -(-segs // unit_segments(S)) * 3 * C]
    if dw:
        pieces += ([2 * rows * C] if use_ln else []) + [2 * rows * C,
                                                        2 * rows * 3 * C]
        if gm:
            pieces.append(2 * rows * C)
    if geff:
        pieces.append(2 * rows * C)
    return sum(-(-n // 256) * 256 for n in pieces)


def attention_bwd_seg_chunks(n_seg, S, C, dw, use_ln=True, geff=False,
                             gm=False):
    """The segment chunks of one backward call up to 64 tokens on the
    card: [(first segment, segments)], whole segments tiling [0, n_seg) in
    order, as few as keep each chunk's scratch (attention_bwd_scratch_bytes
    with dw, use_ln, geff, gm) within ATTN_SCRATCH_BYTES, of equal size but
    the last, that size a multiple of unit_segments(S): a unit's group of
    segments never spans two chunks, and only the last chunk's last group
    may be short. A chunk's first segment is global: the dropout masks
    count from it."""
    if n_seg <= 0:
        return []
    G = unit_segments(S)
    need = functools.partial(attention_bwd_scratch_bytes, S=S, C=C, dw=dw,
                             use_ln=use_ln, geff=geff, gm=gm)
    lo, hi = 1, -(-n_seg // G)      # the most groups a chunk can hold
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if need(mid * G) <= ATTN_SCRATCH_BYTES else (
            lo, mid - 1)
    most = lo * G
    n = -(-n_seg // most)
    size = -(-(-(-n_seg // n)) // G) * G
    return [(s0, min(size, n_seg - s0)) for s0 in range(0, n_seg, size)]


def _attention_core_chain(x, ln_scale, ln_bias, wqkv, bqkv, num_heads,
                          scale, ln_eps, use_ln, seed, attn_drop, what):
    """o = block_diag_attn(qkv([LN](x))) on the card for x [n_seg, S, C]
    at 1..197 tokens (checked by the caller): for each chunk of
    attention_seg_plan, one call of csrc/attention_sm90.cu's chain (the
    LayerNorm pass, the qkv product, the attention core on units of G
    segments with the reg form's attention dropout), through one bf16
    scratch."""
    n_seg, S, C = x.shape
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    _check_tensor("x", x, dev, bf16, (n_seg, S, C))
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("wqkv", wqkv, dev, bf16, (C, 3 * C))
    _check_tensor("bqkv", bqkv, dev, f32, (3 * C,))
    a_thr, a_scale = drop_args(attn_drop)
    o = torch.empty_like(x)
    if n_seg == 0:
        return o
    lib = _build.load_library("attention_sm90")
    fn = lib.launch_attention_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    plan = attention_seg_plan(n_seg, S, C, use_ln)
    cap = plan[0][1] * S
    ln_rows = -(-cap // MLP_ROW_TILE) * MLP_ROW_TILE if use_ln else 0
    scratch = torch.empty(ln_rows * C + cap * 3 * C, dtype=bf16, device=dev)
    ln = ctypes.c_void_p(scratch.data_ptr()) if use_ln else None
    qkv = ctypes.c_void_p(scratch.data_ptr() + 2 * ln_rows * C)
    with torch.cuda.device(dev):
        for s0, ns, G in plan:
            off = 2 * s0 * S * C
            status = fn(ctypes.c_void_p(x.data_ptr() + off), _ptr(ln_scale),
                        _ptr(ln_bias), _ptr(wqkv), _ptr(bqkv),
                        ctypes.c_void_p(o.data_ptr() + off), ln, qkv, cap,
                        ns, S, G, C, num_heads, s0, float(scale),
                        float(ln_eps), int(bool(use_ln)), int32_seed(seed),
                        a_thr, a_scale, _stream(dev))
            _build.check(lib, status, what)
    return o


def attention_proj(o, x, wproj, bproj, use_residual=True, gamma=None, seed=0,
                   proj_drop=0.0):
    """The second launch of the 65..197-token attention branch: y = [x +]
    gamma * drop(o wproj + bproj), accumulated in float32 and cast once;
    o, x [..., C] (x is read only with use_residual). On the card: bf16 o,
    x and wproj, float32 bproj (and gamma), C in SUPPORTED_C. gamma, seed,
    proj_drop: the reg form's epilogue (counted as
    "fused_attention_residual_s86_proj_reg")."""
    if o.device.type == "cpu":
        return attention_proj_plain(o, x, wproj, bproj, use_residual, gamma,
                                    seed, proj_drop)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    if o.dtype == torch.float32:
        f32_form("attention_proj", C=o.shape[-1])
    _check_width(o.shape[-1], "attention_proj")
    _check_tensor("o", o, o.device, torch.bfloat16, o.shape)
    _check_proj_args(x, wproj, bproj, gamma)
    out = _attention_proj_launch(o, x, wproj, bproj, use_residual, gamma,
                                 seed, proj_drop)
    name = _reg_name("fused_attention_residual_s86_proj", gamma, proj_drop)
    launch_counts[name if use_residual else name + "_bare"] += 1
    return out


def _check_proj_args(x, wproj, bproj, gamma):
    """The proj's operands on x's device: bf16 x [..., C] and wproj [C, C],
    float32 bproj [C] (and gamma)."""
    C, dev = x.shape[-1], x.device
    _check_tensor("x", x, dev, torch.bfloat16, x.shape)
    _check_tensor("wproj", wproj, dev, torch.bfloat16, (C, C))
    _check_tensor("bproj", bproj, dev, torch.float32, (C,))
    if gamma is not None:
        _check_tensor("gamma", gamma, dev, torch.float32, (C,))


def _attention_proj_launch(o, x, wproj, bproj, use_residual, gamma, seed,
                           proj_drop):
    """The proj's launch (csrc/attention_sm90.cu's product with EPI_OUT)
    on operands its caller checked (_check_proj_args; o like x); counts
    nothing."""
    C = o.shape[-1]
    rows = o.numel() // C if C else 0
    p_thr, p_scale = drop_args(proj_drop)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library("attention_sm90")
    fn = lib.launch_attention_proj
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dev = o.device
    with torch.cuda.device(dev):
        status = fn(_ptr(o), _ptr(x), _ptr(wproj), _ptr(bproj), _ptr(out),
                    rows, C, int(bool(use_residual)),
                    None if gamma is None else _ptr(gamma), int32_seed(seed),
                    p_thr, p_scale, _stream(dev))
    _build.check(lib, status, "attention_proj")
    return out


def mlp_row_chunks(rows, C, hidden):
    """The row chunks of one fused_mlp_residual call on the card: [(first
    row, rows)], tiling [0, rows) in order, as few as keep each chunk's
    scratch (2 * (C + hidden) bytes a row) within MLP_SCRATCH_BYTES, of
    equal size rounded up to MLP_ROW_TILE rows but the last. Each chunk's
    first row is global: the dropout masks count from it."""
    tile = MLP_ROW_TILE
    cap = max(tile, MLP_SCRATCH_BYTES // (2 * (C + hidden)) // tile * tile)
    if rows <= 0:
        return []
    n = -(-rows // cap)
    size = -(-(-(-rows // n)) // tile) * tile    # ceil(ceil(rows / n), tile)
    return [(r, min(size, rows - r)) for r in range(0, rows, size)]


def mlp_bwd_scratch_bytes(rows, C):
    """The bytes of fused_mlp_bwd's scratch for a chunk of `rows` rows
    (csrc/fused_mlp_bwd.cu's MlpBwdScratch, in its order, each piece
    rounded up to 256 bytes): the float32 dln, the LN statistics and the
    LN backward's partial rows (3C floats a block of 64 rows). The chunks'
    sums, 3C floats a chunk, and g's C come on top."""
    pieces = [4 * rows * C, 8 * rows, 4 * -(-rows // 64) * 3 * C]
    return sum(-(-n // 256) * 256 for n in pieces)


def mlp_bwd_row_chunks(rows, C):
    """The row chunks of one fused_mlp_bwd call on the card: [(first row,
    rows)], tiling [0, rows) in order, as few as keep each chunk's scratch
    (mlp_bwd_scratch_bytes) within MLP_BWD_SCRATCH_BYTES, of equal size
    rounded up to MLP_ROW_TILE rows but the last."""
    if rows <= 0:
        return []
    tile = MLP_ROW_TILE
    # the most tiles a chunk can hold: at C % 32 == 0 a tile's pieces are
    # whole multiples of 256 bytes, so k tiles take k times one tile's
    most = max(1, MLP_BWD_SCRATCH_BYTES // mlp_bwd_scratch_bytes(tile, C))
    n = -(-rows // (most * tile))
    size = -(-(-(-rows // n)) // tile) * tile    # ceil(ceil(rows / n), tile)
    return [(r, min(size, rows - r)) for r in range(0, rows, size)]


def fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps=1e-6,
                       use_residual=True, return_hidden=False, gamma=None,
                       seed=0, drop=0.0):
    """y = [x +] fc2(gelu(fc1(LN(x)))); x [..., C]. The JAX signature
    (pallas_attention.py:1696). return_hidden=True -> (y, z), z the
    pre-GELU hidden [rows, hidden] (the z form, _fused_mlp_kernel_z). On
    the card: bf16 x and weights, float32 vectors, C in SHORT_C, hidden a
    multiple of 128; or every operand float32, the float32 form (inert, C
    in F32_C). gamma, seed, drop: the reg form's LayerScale and
    dropout of the hidden and the output (fused_mlp_residual_reg,
    :1940)."""
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        ln_eps, use_residual, return_hidden,
                                        gamma, seed, drop)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        return _fused_mlp_residual_f32(
            x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps, use_residual,
            return_hidden, gamma is not None or drop > 0.0)
    C = x.shape[-1]
    hidden = w1.shape[-1]
    rows = x.numel() // C if C else 0
    _check_width(C, "fused_mlp_residual", SHORT_C)
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    # what the LayerNorm pass reads is checked first: its launch overlaps
    # the rest of the host work
    _check_tensor("x", x, dev, bf16, x.shape)
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    lib = _build.load_library("fused_mlp_residual")
    ln_fn, fn = lib.launch_mlp_layernorm, lib.launch_mlp_products
    if fn.argtypes is None:
        ln_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p]
        ln_fn.restype = fn.restype = ctypes.c_int
    chunks = mlp_row_chunks(rows, C, hidden)
    cap = chunks[0][1] if chunks else 0
    ln_rows = -(-cap // MLP_ROW_TILE) * MLP_ROW_TILE   # ln_kernel's blocks
    scratch = torch.empty(ln_rows * C + cap * hidden, dtype=bf16, device=dev)
    ln = scratch.data_ptr()
    h = ln + 2 * ln_rows * C

    def at(t, r0, width):   # row r0 of a contiguous bf16 [rows, width]
        return ctypes.c_void_p(t.data_ptr() + 2 * r0 * width)

    def layernorm(r0, n):
        _build.check(lib, ln_fn(at(x, r0, C), _ptr(ln_scale), _ptr(ln_bias),
                                ln, n, C, float(ln_eps), _stream(dev)),
                     "fused_mlp_residual (LayerNorm)")

    with torch.cuda.device(dev):
        if chunks:
            layernorm(*chunks[0])
        _check_tensor("w1", w1, dev, bf16, (C, hidden))
        _check_tensor("b1", b1, dev, f32, (hidden,))
        _check_tensor("w2", w2, dev, bf16, (hidden, C))
        _check_tensor("b2", b2, dev, f32, (C,))
        if gamma is not None:
            _check_tensor("gamma", gamma, dev, f32, (C,))
        d_thr, d_scale = drop_args(drop)
        out = torch.empty_like(x)
        z = (torch.empty(rows, hidden, dtype=bf16, device=dev)
             if return_hidden else None)
        if rows == 0:
            return (out, z) if return_hidden else out
        name = _reg_name("fused_mlp_residual", gamma, drop)
        name += "_z" if return_hidden else ""
        for i, (r0, n) in enumerate(chunks):
            if i:
                layernorm(r0, n)
            status = fn(at(x, r0, C), _ptr(w1), _ptr(b1), _ptr(w2),
                        _ptr(b2), at(out, r0, C),
                        at(z, r0, hidden) if return_hidden else None,
                        ln, h, n, r0, C, hidden, int(bool(use_residual)),
                        None if gamma is None else _ptr(gamma),
                        int32_seed(seed), d_thr, d_scale, _stream(dev))
            _build.check(lib, status, name)
    count_launch(name, C)
    return (out, z) if return_hidden else out


def _fused_mlp_residual_f32(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps,
                            use_residual, return_hidden, reg):
    """fused_mlp_residual's float32 form on the card
    (csrc/fused_mlp_residual_f32.cu: LN, fc1 with the exact GELU in its
    epilogue, fc2 with bias and residual; the z form also writes z):
    every operand float32, inert, C in F32_C, hidden a multiple of 128;
    anything else raises NotImplementedError (f32_form)."""
    C = x.shape[-1]
    name = f32_form("fused_mlp_residual_z" if return_hidden
                    else "fused_mlp_residual", C=C, reg=reg)
    hidden = w1.shape[-1]
    rows = x.numel() // C
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32 = x.device, torch.float32
    for what, t, shape in (
            ("x", x, x.shape), ("ln_scale", ln_scale, (C,)),
            ("ln_bias", ln_bias, (C,)), ("w1", w1, (C, hidden)),
            ("b1", b1, (hidden,)), ("w2", w2, (hidden, C)), ("b2", b2, (C,))):
        _check_tensor(what, t, dev, f32, shape)
    out = torch.empty_like(x)
    z = _f32_scratch(rows, hidden, device=dev) if return_hidden else None
    if rows == 0:
        return (out, z) if return_hidden else out
    ln = _f32_scratch(rows, C, device=dev)
    h = _f32_scratch(rows, hidden, device=dev)
    lib = _build.load_library("fused_mlp_residual_f32")
    fn = lib.launch_fused_mlp_residual_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1),
                    _ptr(b1), _ptr(w2), _ptr(b2), _ptr(out),
                    None if z is None else _ptr(z), _ptr(ln), _ptr(h), rows,
                    C, hidden, float(ln_eps), int(bool(use_residual)),
                    _stream(dev))
    _build.check(lib, status, name)
    count_launch(name, C)
    return (out, z) if return_hidden else out


def fused_attention_residual_bwd(x, g, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                 num_heads, seg_len, scale, ln_eps=1e-6,
                                 use_ln=True, use_residual=True, gamma=None,
                                 seed=0, attn_drop=0.0, proj_drop=0.0,
                                 dw=False):
    """The attention branch's backward without the weight gradients
    (_fused_block_bwd_impl, dw=False, pallas_attention.py:921-1049): x, g
    [n_seg, seg_len, C] -> (dx, ln [rows, C], attn [rows, C], dqkv
    [rows, 3C], dlns, dlnb, dbqkv, dbproj). The bare form's ln is x
    itself. On the card: as fused_attention_residual, g like x (float32:
    the float32 form, dw=False only).
    gamma, seed, attn_drop, proj_drop: the reg form, as the forward took
    them; with proj_drop > 0 a ninth output gm [rows, C] (the proj-masked
    g) and dbproj sums it (float32, without gamma).

    dw=True (_fused_block_bwd_impl, dw=True, :921-1049): (dx, dlns, dlnb,
    dbqkv, dbproj, dwqkv [C, 3C], dwA [C, C]), the weight gradients formed
    by the kernels (float32, summed over chunks of rows in a fixed order
    without atomics: bit-reproducible) and no row-space tensor returned;
    dwA = attn^T gm (g without the proj dropout: no gamma). A chain runs
    over chunks of segments and the dw form's row-space tensors (and the
    reg form's geff and gm) live in per-chunk scratch (up to 64 tokens
    csrc/attention_bwd_sm90.cu, one C entry a call; 65..86
    csrc/fused_attention_residual_bwd_s86.cu, both with the reg flags;
    87..197 csrc/attention_long.cu, inert forms only)."""
    reg = dict(gamma=gamma, seed=seed, attn_drop=attn_drop,
               proj_drop=proj_drop)
    what = "fused_attention_residual_bwd" + (" (dw form)" if dw else "")
    if gamma is not None or attn_drop > 0.0 or proj_drop > 0.0:
        refuse_long_segments(f"the reg form (LayerScale, dropout) of {what}",
                             seg_len)
    refuse_long_segments(what, seg_len, ATTN_LONG_MAX_SEG_LEN)
    if x.device.type == "cpu":
        return fused_attention_residual_bwd_plain(
            x, g, ln_scale, ln_bias, wqkv, bqkv, wproj, num_heads, seg_len,
            scale, ln_eps, use_ln, use_residual, dw=dw, **reg)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        return _fused_attention_residual_bwd_f32(
            x, g, ln_scale, ln_bias, wqkv, bqkv, wproj, num_heads, seg_len,
            scale, ln_eps, use_ln, use_residual,
            gamma is not None or attn_drop > 0.0 or proj_drop > 0.0, dw)
    n_seg, S, C = _check_attention_x(
        x, seg_len, num_heads, "fused_attention_residual_bwd",
        ATTN_LONG_MAX_SEG_LEN, attention_widths(seg_len))
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    _check_tensor("x", x, dev, bf16, (n_seg, S, C))
    _check_tensor("g", g, dev, bf16, (n_seg, S, C))
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("wqkv", wqkv, dev, bf16, (C, 3 * C))
    _check_tensor("bqkv", bqkv, dev, f32, (3 * C,))
    _check_tensor("wproj", wproj, dev, bf16, (C, C))
    if gamma is not None:
        _check_tensor("gamma", gamma, dev, f32, (C,))
    rows = n_seg * S
    dx = torch.empty_like(x)
    sums = torch.empty(6 * C, dtype=f32, device=dev)
    gm = None
    if dw:
        dwqkv = torch.zeros(C, 3 * C, dtype=f32, device=dev)
        dwA = torch.zeros(C, C, dtype=f32, device=dev)
        out = (dx, sums[:C], sums[C:2 * C], sums[2 * C:5 * C], sums[5 * C:],
               dwqkv, dwA)
    else:
        ln = (torch.empty(rows, C, dtype=bf16, device=dev) if use_ln
              else x.view(rows, C))
        attn = torch.empty(rows, C, dtype=bf16, device=dev)
        dqkv = torch.empty(rows, 3 * C, dtype=bf16, device=dev)
        out = (dx, ln, attn, dqkv, sums[:C], sums[C:2 * C],
               sums[2 * C:5 * C], sums[5 * C:])
        if proj_drop > 0.0:
            gm = torch.empty(rows, C, dtype=bf16, device=dev)
            out = out + (gm,)
    if n_seg == 0:
        sums.zero_()
        return out
    chain = (_attention_bwd_chain if S > ATTN_MAX_SEG_LEN
             else _attention_bwd_sm90)
    return chain(x, g, ln_scale, ln_bias, wqkv, bqkv, wproj, out, sums, n_seg,
                 S, C, num_heads, scale, ln_eps, use_ln, use_residual, dw, gm,
                 **reg)


# launch_attention_bwd_sm90's arguments: x, g, lns, lnb, wqkv, bqkv, wproj,
# dx, ln, attn, dqkv, sums, dwqkv, dwA, scratch; scratch_bytes; n_seg, S,
# C, num_heads, chunk_segs; scale, eps; use_ln, use_residual; gamma, gm;
# seed, attn_thr, attn_scale, proj_thr, proj_scale; stream
_BWD_SM90_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 2
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                     ctypes.c_void_p])


def _attention_bwd_sm90(x, g, ln_scale, ln_bias, wqkv, bqkv, wproj, out,
                        sums, n_seg, S, C, num_heads, scale, ln_eps, use_ln,
                        use_residual, dw, gm=None, gamma=None, seed=0,
                        attn_drop=0.0, proj_drop=0.0):
    """fused_attention_residual_bwd up to 64 tokens on the card: one call
    of csrc/attention_bwd_sm90.cu's chain over the chunks of
    attention_bwd_seg_chunks, into the outputs `out` and the float32 [6C]
    column sums `sums` (checked and allocated by the caller; gm: the
    caller's proj-masked g where dw=False has the proj dropout), through
    one scratch buffer for a chunk plus the chunks' sums; counts one
    launch."""
    dev = x.device
    if dw:
        dx, dwqkv, dwA = out[0], out[5], out[6]
        ln = attn = dqkv = None
    else:
        dx, ln, attn, dqkv = out[:4]
        dwqkv = dwA = None
    geff = gamma is not None or proj_drop > 0.0
    gm_rows = dw and proj_drop > 0.0
    plan = attention_bwd_seg_chunks(n_seg, S, C, dw, use_ln, geff, gm_rows)
    chunk = plan[0][1]
    nbytes = (attention_bwd_scratch_bytes(chunk, S, C, dw, use_ln, geff,
                                          gm_rows)
              + -(-4 * len(plan) * 6 * C // 256) * 256)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    a_thr, a_scale = drop_args(attn_drop)
    p_thr, p_scale = drop_args(proj_drop)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.entry("attention_bwd_sm90", "launch_attention_bwd_sm90",
                      _BWD_SM90_ARGS)
    status = _build.call_on(
        dev, fn, x.data_ptr(), g.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        wproj.data_ptr(), dx.data_ptr(), ptr(ln) if use_ln else None,
        ptr(attn), ptr(dqkv), sums.data_ptr(), ptr(dwqkv), ptr(dwA),
        scratch.data_ptr(), nbytes, n_seg, S, C, num_heads, chunk,
        float(scale), float(ln_eps), int(bool(use_ln)),
        int(bool(use_residual)), ptr(gamma), ptr(gm), int32_seed(seed),
        a_thr, a_scale, p_thr, p_scale, _stream(dev))
    _build.check("attention_bwd_sm90", status, "fused_attention_residual_bwd")
    name = _reg_name("fused_attention_residual_bwd", gamma, attn_drop,
                     proj_drop) + ("_dw" if dw else "")
    count_launch(name if use_ln else name + "_bare", C)
    return out


def _fused_attention_residual_bwd_f32(x, g, ln_scale, ln_bias, wqkv, bqkv,
                                      wproj, num_heads, seg_len, scale,
                                      ln_eps, use_ln, use_residual, reg, dw):
    """fused_attention_residual_bwd's float32 form on the card, dw=False
    (csrc/fused_attention_residual_bwd_f32.cu): the outputs of the
    dw=False form, every operand float32, inert, seg_len <= 64, C in
    F32_C; anything else raises NotImplementedError (f32_form)."""
    name = f32_form("fused_attention_residual_bwd", seg_len, x.shape[-1],
                    reg, dw)
    n_seg, S, C = _check_attention_x(x, seg_len, num_heads, name,
                                     ATTN_MAX_SEG_LEN, F32_C)
    dev, f32 = x.device, torch.float32
    for what, t, shape in (
            ("x", x, (n_seg, S, C)), ("g", g, (n_seg, S, C)),
            ("ln_scale", ln_scale, (C,)), ("ln_bias", ln_bias, (C,)),
            ("wqkv", wqkv, (C, 3 * C)), ("bqkv", bqkv, (3 * C,)),
            ("wproj", wproj, (C, C))):
        _check_tensor(what, t, dev, f32, shape)
    rows = n_seg * S
    dx = torch.empty_like(x)
    sums = torch.zeros(6 * C, dtype=f32, device=dev)
    ln = _f32_scratch(rows, C, device=dev) if use_ln else x.view(rows, C)
    attn = _f32_scratch(rows, C, device=dev)
    dqkv = _f32_scratch(rows, 3 * C, device=dev)
    out = (dx, ln, attn, dqkv, sums[:C], sums[C:2 * C], sums[2 * C:5 * C],
           sums[5 * C:])
    if n_seg == 0:
        return out
    lib = _build.load_library("fused_attention_residual_bwd_f32")
    lib.attention_bwd_f32_part_floats.argtypes = [ctypes.c_int] * 2
    lib.attention_bwd_f32_part_floats.restype = ctypes.c_longlong
    part = _f32_scratch(lib.attention_bwd_f32_part_floats(rows, C),
                        device=dev)
    qkv = _f32_scratch(rows, 3 * C, device=dev)
    dattn = _f32_scratch(rows, C, device=dev)
    dln = _f32_scratch(rows, C, device=dev) if use_ln else None
    stats = _f32_scratch(rows, 2, device=dev) if use_ln else None
    fn = lib.launch_fused_attention_residual_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def opt(t):
        return None if t is None else _ptr(t)

    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(g), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(wqkv), _ptr(bqkv), _ptr(wproj), _ptr(dx),
                    _ptr(ln) if use_ln else None, _ptr(attn), _ptr(dqkv),
                    _ptr(sums), _ptr(qkv), _ptr(dattn), opt(dln), opt(stats),
                    _ptr(part), n_seg, S, C, num_heads, float(scale),
                    float(ln_eps), int(bool(use_ln)),
                    int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, name)
    count_launch(name if use_ln else name + "_bare", C)
    return out


def _attention_bwd_chain(x, g, ln_scale, ln_bias, wqkv, bqkv, wproj, out,
                         sums, n_seg, S, C, num_heads, scale, ln_eps, use_ln,
                         use_residual, dw, gm=None, gamma=None, seed=0,
                         attn_drop=0.0, proj_drop=0.0):
    """fused_attention_residual_bwd at 65..197 tokens on the card: the
    chain of csrc/fused_attention_residual_bwd_s86.cu (S <= 86, with the
    reg flags gamma, seed, attn_drop, proj_drop, and gm the caller's
    proj-masked g where dw=False has the proj dropout) or
    csrc/attention_long.cu (inert) into the outputs `out` and the float32
    [6C] column sums `sums` (checked and allocated by the caller), with a
    scratch buffer of the size the library names (bounded by its chunk of
    segments)."""
    dev = x.device
    if dw:
        dx, dwqkv, dwA = out[0], out[5], out[6]
        ln = attn = dqkv = None
    else:
        dx, ln, attn, dqkv = out[:4]
        dwqkv = dwA = None
    short = S <= ATTN_SERVE_MAX_SEG_LEN
    tag = "s86" if short else "long"
    lib = _build.load_library("fused_attention_residual_bwd_s86" if short
                              else "attention_long")
    size = getattr(lib, f"attention_bwd_{tag}_scratch_bytes")
    reg_args = []
    size_args = [n_seg, S, C, int(dw), int(bool(use_ln))]
    if short:
        a_thr, a_scale = drop_args(attn_drop)
        p_thr, p_scale = drop_args(proj_drop)
        reg_args = [None if gamma is None else _ptr(gamma),
                    None if gm is None else _ptr(gm), int32_seed(seed),
                    a_thr, a_scale, p_thr, p_scale]
        size_args += [int(gamma is not None or proj_drop > 0.0),
                      int(proj_drop > 0.0)]
    size.argtypes = [ctypes.c_int] * len(size_args)
    size.restype = ctypes.c_longlong
    scratch = torch.empty(size(*size_args), dtype=torch.uint8, device=dev)
    fn = getattr(lib, f"launch_attention_bwd_{tag}")
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + \
        ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
         [ctypes.c_float, ctypes.c_int, ctypes.c_float] if short else []) + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def opt(t):
        return None if t is None else _ptr(t)

    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(g), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(wqkv), _ptr(bqkv), _ptr(wproj), _ptr(dx),
                    opt(ln) if use_ln else None, opt(attn), opt(dqkv),
                    _ptr(sums), opt(dwqkv), opt(dwA), _ptr(scratch), n_seg,
                    S, C, num_heads, float(scale), float(ln_eps),
                    int(bool(use_ln)), int(bool(use_residual)), *reg_args,
                    _stream(dev))
    name = f"fused_attention_residual_bwd_{tag}"
    _build.check(lib, status, name)
    name = _reg_name(name, gamma, attn_drop, proj_drop) + ("_dw" if dw else "")
    launch_counts[name if use_ln else name + "_bare"] += 1
    return out


def mlp_dz(g2, z, w2):
    """dz = (g2 w2^T) * gelu'(z) and db1 = colsum(dz) (_mlp_dz_impl,
    emit_h=False, pallas_attention.py:1751-1789): g2 [rows, C], z [rows,
    hidden], w2 [hidden, C] -> (dz [rows, hidden], db1 [hidden] float32).
    On the card: bf16 g2, z and w2, C a multiple of 64, hidden a multiple
    of 128; or all three float32, the float32 form (C in F32_C)."""
    if g2.device.type == "cpu":
        return mlp_dz_plain(g2, z, w2)
    if g2.device.type != "cuda":
        raise ValueError(f"no kernel for device {g2.device}")
    _require(g2.dim() == 2 and z.dim() == 2,
             f"g2 and z must be 2-D, got {tuple(g2.shape)}, "
             f"{tuple(z.shape)}")
    rows, C = g2.shape
    hidden = z.shape[1]
    if g2.dtype == torch.float32:
        return _mlp_dz_f32(g2, z, w2, f32_form("mlp_dz", C=C))
    _require(C % 64 == 0 and C > 0, f"C={C} must be a multiple of 64")
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, bf16 = g2.device, torch.bfloat16
    _check_tensor("g2", g2, dev, bf16, (rows, C))
    _check_tensor("z", z, dev, bf16, (rows, hidden))
    _check_tensor("w2", w2, dev, bf16, (hidden, C))
    dz = torch.empty_like(z)
    db1 = torch.zeros(hidden, dtype=torch.float32, device=dev)
    if rows == 0:
        return dz, db1
    part = torch.empty(-(-rows // 128) * hidden, dtype=torch.float32,
                       device=dev)
    lib = _build.load_library("mlp_dz")
    fn = lib.launch_mlp_dz
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(g2), _ptr(z), _ptr(w2), _ptr(dz), _ptr(db1),
                    _ptr(part), rows, C, hidden, _stream(dev))
    _build.check(lib, status, "mlp_dz")
    count_launch("mlp_dz", C)
    return dz, db1


def _mlp_dz_f32(g2, z, w2, name):
    """mlp_dz's float32 form on the card (csrc/mlp_dz_f32.cu: the product
    with gelu' in its epilogue, then db1 as column sums in a fixed order):
    every operand float32, C in F32_C, hidden a multiple of 128."""
    rows, C = g2.shape
    hidden = z.shape[1]
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32 = g2.device, torch.float32
    _check_tensor("g2", g2, dev, f32, (rows, C))
    _check_tensor("z", z, dev, f32, (rows, hidden))
    _check_tensor("w2", w2, dev, f32, (hidden, C))
    dz = torch.empty_like(z)
    db1 = torch.zeros(hidden, dtype=f32, device=dev)
    if rows == 0:
        return dz, db1
    lib = _build.load_library("mlp_dz_f32")
    lib.mlp_dz_f32_part_floats.argtypes = [ctypes.c_int] * 2
    lib.mlp_dz_f32_part_floats.restype = ctypes.c_longlong
    part = _f32_scratch(lib.mlp_dz_f32_part_floats(rows, hidden), device=dev)
    fn = lib.launch_mlp_dz_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(g2), _ptr(z), _ptr(w2), _ptr(dz), _ptr(db1),
                    _ptr(part), rows, C, hidden, _stream(dev))
    _build.check(lib, status, name)
    count_launch(name, C)
    return dz, db1


# launch_fused_mlp_bwd's arguments: x, g, lns, lnb, w1, b1, w2, dx, ln, h,
# dz, sums, scratch; scratch_bytes; rows, C, hidden, chunk_rows; eps; stream
_MLP_BWD_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def fused_mlp_bwd(x, g, ln_scale, ln_bias, w1, b1, w2, ln_eps=1e-6):
    """The MLP residual branch's backward from x, with no saved hidden
    (_fused_mlp_bwd_impl, pallas_attention.py:1634-1693): x, g [..., C] ->
    (dx like x, ln [rows, C], h [rows, hidden], dz [rows, hidden], dlns,
    dlnb). dx includes the residual's g. On the card: bf16 x, g and
    weights, float32 vectors, C in SHORT_C, hidden a multiple of 128."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(x, g, ln_scale, ln_bias, w1, b1, w2,
                                   ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        f32_form("fused_mlp_bwd", C=x.shape[-1])
    C = x.shape[-1]
    hidden = w1.shape[-1]
    rows = x.numel() // C if C else 0
    _check_width(C, "fused_mlp_bwd", SHORT_C)
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    _check_tensor("x", x, dev, bf16, x.shape)
    _check_tensor("g", g, dev, bf16, x.shape)
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("w1", w1, dev, bf16, (C, hidden))
    _check_tensor("b1", b1, dev, f32, (hidden,))
    _check_tensor("w2", w2, dev, bf16, (hidden, C))
    dx = torch.empty_like(x)
    ln = torch.empty(rows, C, dtype=bf16, device=dev)
    h = torch.empty(rows, hidden, dtype=bf16, device=dev)
    dz = torch.empty(rows, hidden, dtype=bf16, device=dev)
    sums = torch.empty(2 * C, dtype=f32, device=dev)   # the kernel's sums
    out = (dx, ln, h, dz, sums[:C], sums[C:])
    if rows == 0:
        sums.zero_()
        return out
    plan = mlp_bwd_row_chunks(rows, C)
    # the chunk's scratch, then the chunks' sums (3C floats each) and g's
    nbytes = mlp_bwd_scratch_bytes(plan[0][1], C) + sum(
        -(-n // 256) * 256 for n in (4 * len(plan) * 3 * C, 4 * C))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    fn = _build.entry("fused_mlp_bwd", "launch_fused_mlp_bwd", _MLP_BWD_ARGS)
    status = _build.call_on(
        dev, fn, x.data_ptr(), g.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), ln.data_ptr(), h.data_ptr(), dz.data_ptr(),
        sums.data_ptr(), scratch.data_ptr(), nbytes, rows, C, hidden,
        plan[0][1], float(ln_eps), _stream(dev))
    _build.check("fused_mlp_bwd", status, "fused_mlp_bwd")
    count_launch("fused_mlp_bwd", C)
    return out


def block_diag_attention_fwd(qkv, num_heads, seg_len, scale):
    """softmax(q k^T * scale) v within each segment (_block_attention_impl,
    pallas_attention.py:230-263): qkv [n_seg, seg_len, 3C] -> [n_seg,
    seg_len, C]. On the card: bf16 qkv, head width 64, seg_len <= 197 (on
    either device), through csrc/attention_sm90.cu's core (counted as
    block_diag_attention, 65..197 as block_diag_attention_long)."""
    refuse_long_segments("block_diag_attention", seg_len,
                         ATTN_LONG_MAX_SEG_LEN)
    if qkv.device.type == "cpu":
        return block_diag_attention_plain(qkv, num_heads, seg_len, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype == torch.float32:
        f32_form("block_diag_attention", seg_len, qkv.shape[-1] // 3)
    _require(qkv.dim() == 3, f"qkv must be [n_seg, seg_len, 3C], got "
             f"{tuple(qkv.shape)}")
    n_seg, S, C3 = qkv.shape
    C = C3 // 3
    _require(S == seg_len, f"qkv has {S} tokens per segment, "
             f"seg_len={seg_len}")
    _require(1 <= S <= ATTN_LONG_MAX_SEG_LEN,
             f"seg_len {S} outside the kernels' 1..{ATTN_LONG_MAX_SEG_LEN}")
    _require(C3 == 3 * C and num_heads * HEAD_DIM == C,
             f"the kernel needs head width {HEAD_DIM}: 3C={C3}, "
             f"num_heads={num_heads}")
    _check_tensor("qkv", qkv, qkv.device, torch.bfloat16, (n_seg, S, C3))
    out = torch.empty(n_seg, S, C, dtype=torch.bfloat16, device=qkv.device)
    if n_seg == 0:
        return out
    _block_diag_launch(qkv, out, scale)
    launch_counts["block_diag_attention_long" if S > ATTN_MAX_SEG_LEN
                  else "block_diag_attention"] += 1
    return out


def _block_diag_launch(qkv, out, scale):
    """The core's launch on checked operands: out [n_seg, S, C] (or the
    first n_seg segments of a larger buffer, whose rows past them it never
    writes) from qkv [n_seg, S, 3C]; counts nothing. The core also takes
    the rows qkv's buffer holds from its start, and reads none past n_seg
    * S."""
    n_seg, S, C3 = qkv.shape
    cap = (qkv.untyped_storage().nbytes() // 2 - qkv.storage_offset()) // C3
    lib = _build.load_library("attention_sm90")
    fn = lib.launch_block_diag_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dev = qkv.device
    with torch.cuda.device(dev):
        status = fn(_ptr(qkv), _ptr(out), cap, n_seg, S, unit_segments(S),
                    C3 // 3, float(scale), _stream(dev))
    _build.check(lib, status, "block_diag_attention")


# ---------------------------------------------------------------------------
# Autograd functions (the JAX package's custom_vjp entries)
# ---------------------------------------------------------------------------

def _wgrad(a, b, dtype):
    """a^T b, the weight gradient of a linear layer, in `dtype`: float32
    accumulation rounded once, as JAX's preferred_element_type=float32
    followed by .astype(w.dtype)."""
    return torch.matmul(a.t(), b).to(dtype)


def _mm_f32(a, b):
    """a @ b accumulated and returned in float32 (JAX's
    preferred_element_type=float32); on the card bf16 operands go to a
    bf16 product with a float32 result."""
    if a.device.type == "cpu" or a.dtype == torch.float32:
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


class _FusedAttentionResidual(torch.autograd.Function):
    """fused_attention_residual with the backward of _far_bwd
    (pallas_attention.py:1068-1113): the forward saves x and the weights
    and nothing else; the backward kernel recomputes the rest, and with
    bwd_dw forms the weight gradients too (:1082-1090)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                num_heads, seg_len, scale, ln_eps, use_ln, use_residual,
                bwd_dw):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj)
        ctx.cfg = (num_heads, seg_len, scale, ln_eps, use_ln, use_residual)
        ctx.bproj_dtype = bproj.dtype
        ctx.dw = bwd_dw
        return fused_attention_residual(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wqkv, bqkv, wproj = ctx.saved_tensors
        outs = fused_attention_residual_bwd(x, g.contiguous(), ln_scale,
                                            ln_bias, wqkv, bqkv, wproj,
                                            *ctx.cfg, dw=ctx.dw)
        need = ctx.needs_input_grad
        if ctx.dw:
            dx, dlns, dlnb, dbqkv, dbproj, dwqkv, dwproj = outs
            dwqkv, dwproj = dwqkv.to(wqkv.dtype), dwproj.to(wproj.dtype)
        else:
            dx, ln, attn, dqkv, dlns, dlnb, dbqkv, dbproj = outs
            dwqkv = _wgrad(ln, dqkv, wqkv.dtype) if need[3] else None
            dwproj = (_wgrad(attn, g.reshape(-1, x.shape[-1]), wproj.dtype)
                      if need[5] else None)
        return (dx, dlns.to(ln_scale.dtype), dlnb.to(ln_bias.dtype), dwqkv,
                dbqkv.to(bqkv.dtype), dwproj, dbproj.to(ctx.bproj_dtype),
                None, None, None, None, None, None, None)


class _FusedMLPResidual(torch.autograd.Function):
    """fused_mlp_residual with a backward of _fmr_bwd (pallas_attention.py:
    1716-1894). save_hidden: the forward runs the z form and saves z; the
    backward recomputes LN in float32, runs the dz kernel and the four
    large products as plain matmuls (_fmr_bwd_saved_hidden). Without: the
    forward runs the serving form and saves x only; the backward runs the
    recompute-from-x kernel and the two weight-gradient products."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps,
                use_residual, save_hidden):
        if save_hidden:
            out, z = fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        ln_eps, use_residual,
                                        return_hidden=True)
        else:
            out = fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     ln_eps, use_residual)
            z = None
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, z)
        ctx.cfg = (ln_eps, use_residual, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2, z = ctx.saved_tensors
        ln_eps, use_residual, b2_dtype = ctx.cfg
        C = x.shape[-1]
        x2, g2 = x.reshape(-1, C), g.reshape(-1, C).contiguous()
        if z is None:
            dx, ln, h, dz, dlns, dlnb = fused_mlp_bwd(
                x, g2.view_as(x), ln_scale, ln_bias, w1, b1, w2, ln_eps)
            db1 = dz.sum(0, dtype=torch.float32)
            dw1 = _wgrad(ln, dz, w1.dtype)
            dw2 = _wgrad(h, g2, w2.dtype)
        else:
            lnf, xhat, inv = ln_fwd_f32(x2.float(), ln_scale, ln_bias,
                                        ln_eps)
            ln = lnf.to(x.dtype)
            dz, db1 = mlp_dz(g2, z, w2)
            # h = gelu(z): the exact GELU in float32 from the rounded z,
            # rounded once to z's dtype (gelu computes bf16 in float32), in
            # one pass
            h = torch.nn.functional.gelu(z, approximate="none")
            dw1 = _wgrad(ln, dz, w1.dtype)
            dw2 = _wgrad(h, g2, w2.dtype)
            del h
            dln = _mm_f32(dz, w1.t())
            dxf, dlns, dlnb = ln_bwd_f32(dln, ln_scale, xhat, inv)
            if use_residual:
                dxf += g2                    # float32 += bf16, in place
            dx = dxf.to(x.dtype).view_as(x)
        return (dx, dlns.to(ln_scale.dtype), dlnb.to(ln_bias.dtype), dw1,
                db1.to(b1.dtype), dw2,
                g2.sum(0, dtype=torch.float32).to(b2_dtype), None, None,
                None)


class _BlockDiagAttention(torch.autograd.Function):
    """block_diag_attention (pallas_attention.py:2129-2150): the kernel
    forward; the backward recomputes from qkv through the plain version's
    autograd, as _bwd takes the XLA reference's vjp."""

    @staticmethod
    def forward(ctx, qkv, num_heads, seg_len, scale):
        ctx.save_for_backward(qkv)
        ctx.cfg = (num_heads, seg_len, scale)
        return block_diag_attention_fwd(qkv, num_heads, seg_len, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            t = qkv.detach().requires_grad_(True)
            out = block_diag_attention_plain(t, *ctx.cfg)
            (dqkv,) = torch.autograd.grad(out, t, g)
        return dqkv, None, None, None


def attention_residual(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                       num_heads, seg_len, scale, ln_eps=1e-6, use_ln=True,
                       use_residual=True, bwd_dw=False):
    """fused_attention_residual, differentiable (pallas_attention.py:1053).
    bwd_dw: the backward's dw form (DUOFORMER_BWD_DW=1)."""
    return _FusedAttentionResidual.apply(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, seg_len,
        scale, ln_eps, use_ln, use_residual, bwd_dw)


def mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps=1e-6,
                 use_residual=True, save_hidden=True):
    """fused_mlp_residual, differentiable (pallas_attention.py:1696): where
    a gradient will be taken, the z form and its saved hidden, or with
    save_hidden=False (DUOFORMER_MLP_SAVE_HIDDEN=0) the serving form and
    the recompute-from-x backward; the serving form otherwise.
    use_residual=False without a saved hidden (the JAX package's TP shards)
    raises NotImplementedError."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, w1, b1, w2, b2)):
        if not save_hidden and not use_residual:
            raise NotImplementedError(
                "the recompute-from-x MLP backward without the residual "
                "(tensor-parallel shards) is not ported to the PyTorch "
                "package yet")
        return _FusedMLPResidual.apply(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                       ln_eps, use_residual, save_hidden)
    return fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps,
                              use_residual)


def block_diag_attention(qkv, num_heads, seg_len, scale):
    """Attention over independent fixed-length segments, differentiable
    (pallas_attention.py:2129): qkv [n_seg, seg_len, 3C] (q | k | v, heads
    contiguous in each) -> [n_seg, seg_len, C]."""
    return _BlockDiagAttention.apply(qkv, num_heads, seg_len, scale)
