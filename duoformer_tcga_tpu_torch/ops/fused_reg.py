"""The reg (dropout + LayerScale) forms of the fused kernels: the drop_ew
kernel, its plain version, and the differentiable entries the models call
(counterpart of duoformer_tcga_tpu/ops/pallas_attention.py:1119-1281 and
:1894-2125).

  drop_ew:                  the reg MLP backward's elementwise mask passes
    (hd = drop(gelu(z)), dz = drop(dh) * gelu'(z), gm = drop(g))
    kernel: csrc/drop_ew.cu
  attention_residual_reg:   y = [x +] gamma * drop_p(proj(drop_a(attn(...))))
  mlp_residual_reg:         y = [x +] gamma * drop(fc2(drop(gelu(fc1(LN x)))))

The two forward kernels and the attention backward kernel are the inert
ones of ops/fused_attention.py with their reg flags (gamma, seed, rates);
the backwards follow _far_reg_bwd (:1228-1278) and _fmr_reg_bwd
(:2038-2122): the weight-gradient products stay torch.matmul, as they stay
XLA there, and LayerScale's gradients come from identities outside the
kernels, dgamma = sum_k A * W + b * colsum(gm) and dW = A * gamma, with A
the one product attn^T gm (h_d^T gm for the MLP), so the branch output is
never formed again. The seed gets no gradient. With bwd_dw=True the
attention backward kernel's dw form gives A itself (:1239-1245); with
save_hidden=False the MLP forward saves no z and the backward recomputes
it from x before the same mask passes (:2069-2077).

gamma is a float32 [C] tensor on every call (ones where a block has no
LayerScale, as the JAX package passes); seed is a Python int (an int32
drawn on the host), ignored where every rate is 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import dropout as dr
from .fused_attention import (_check_tensor, _mm_f32, _ptr, _require,
                              _stream, _wgrad, drop_args,
                              fused_attention_residual,
                              fused_attention_residual_bwd,
                              fused_mlp_residual, int32_seed, launch_counts,
                              ln_bwd_f32, ln_fwd_f32, mlp_dz)

_SQRT1_2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
DROP_EW_MODES = ("hd", "dz", "gm")


# ---------------------------------------------------------------------------
# drop_ew
# ---------------------------------------------------------------------------

def drop_ew_plain(z, seed, rate, site, mode, dh=None):
    """Plain twin of the drop_ew kernel (_drop_ew_kernel,
    pallas_attention.py:1949-1982): z [rows, cols] (and dh [rows, cols]
    float32 for "dz") -> [rows, cols] in z's dtype, computed in float32
    with the mask of (seed, site) at global rows."""
    rows, cols = z.shape
    km = dr.row_keep_mask(rows, cols, seed, site, rate, z.device)
    zf = z.float()
    if mode == "gm":
        out = dr.drop(zf, km, rate)
    else:
        phi = 0.5 * (1.0 + torch.erf(zf * _SQRT1_2))
        if mode == "hd":
            out = dr.drop(zf * phi, km, rate)
        elif mode == "dz":
            dgelu = phi + zf * (_INV_SQRT_2PI * torch.exp(-0.5 * zf * zf))
            out = dr.drop(dh.float(), km, rate) * dgelu
        else:
            raise ValueError(f"mode must be one of {DROP_EW_MODES}, got "
                             f"{mode!r}")
    return out.to(z.dtype)


def drop_ew(z, seed, rate, site, mode, dh=None):
    """The mask passes of the reg MLP backward (_drop_ew,
    pallas_attention.py:1985): "hd" drop(gelu(z)), "dz" drop(dh) *
    gelu'(z), "gm" drop(z), over [rows, cols] at the global rows of the
    forward. On the card: bf16 z, float32 dh, cols a multiple of 8."""
    if z.device.type == "cpu":
        return drop_ew_plain(z, seed, rate, site, mode, dh)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    _require(mode in DROP_EW_MODES,
             f"mode must be one of {DROP_EW_MODES}, got {mode!r}")
    _require(z.dim() == 2, f"z must be [rows, cols], got {tuple(z.shape)}")
    rows, cols = z.shape
    _require(cols % 8 == 0 and cols > 0,
             f"cols={cols} must be a positive multiple of 8")
    _require(rate > 0.0, f"drop_ew needs a dropout rate > 0, got {rate}")
    dev = z.device
    _check_tensor("z", z, dev, torch.bfloat16, (rows, cols))
    if mode == "dz":
        _check_tensor("dh", dh, dev, torch.float32, (rows, cols))
    thr, scale = drop_args(rate)
    out = torch.empty_like(z)
    if rows == 0:
        return out
    lib = _build.load_library("drop_ew")
    fn = lib.launch_drop_ew
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(z), _ptr(dh) if mode == "dz" else None, _ptr(out),
                    rows, cols, DROP_EW_MODES.index(mode), int32_seed(seed),
                    int(site), thr, scale, _stream(dev))
    _build.check(lib, status, "drop_ew")
    launch_counts["drop_ew_" + mode] += 1
    return out


# ---------------------------------------------------------------------------
# The reg entries' autograd functions
# ---------------------------------------------------------------------------

class _AttentionResidualReg(torch.autograd.Function):
    """fused_attention_residual_reg with the backward of _far_reg_bwd
    (pallas_attention.py:1228-1278): the forward saves x and the weights;
    the backward kernel regenerates the masks and emits gm."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, gamma,
                seed, num_heads, seg_len, scale, ln_eps, use_ln,
                use_residual, attn_drop, proj_drop, bwd_dw):
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              gamma)
        ctx.cfg = (num_heads, seg_len, scale, ln_eps, use_ln, use_residual)
        ctx.reg = dict(seed=seed, attn_drop=attn_drop, proj_drop=proj_drop)
        ctx.dw = bwd_dw
        return fused_attention_residual(x, ln_scale, ln_bias, wqkv, bqkv,
                                        wproj, bproj, *ctx.cfg, gamma=gamma,
                                        **ctx.reg)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, gamma = \
            ctx.saved_tensors
        outs = fused_attention_residual_bwd(
            x, g.contiguous(), ln_scale, ln_bias, wqkv, bqkv, wproj,
            *ctx.cfg, gamma=gamma, dw=ctx.dw, **ctx.reg)
        if ctx.dw:
            dx, dlns, dlnb, dbqkv, dbp, dwqkv, A = outs
            dwqkv = dwqkv.to(wqkv.dtype)
        else:
            dx, ln, attn, dqkv, dlns, dlnb, dbqkv, dbp = outs[:8]
            C = x.shape[-1]
            gm = outs[8] if len(outs) > 8 else g.reshape(-1, C)
            dwqkv = _wgrad(ln, dqkv, wqkv.dtype)
            # A = attn^T gm yields dwproj and dgamma's weight term
            A = _mm_f32(attn.t(), gm)
        gf = gamma.float()
        dwproj = (A * gf).to(wproj.dtype)
        dgamma = (A * wproj.float()).sum(0) + bproj.float() * dbp
        return (dx, dlns.to(ln_scale.dtype), dlnb.to(ln_bias.dtype), dwqkv,
                dbqkv.to(bqkv.dtype), dwproj, (gf * dbp).to(bproj.dtype),
                dgamma.to(gamma.dtype), None, None, None, None, None, None,
                None, None, None, None)


class _MLPResidualReg(torch.autograd.Function):
    """fused_mlp_residual_reg with the backward of _fmr_reg_bwd
    (pallas_attention.py:2038-2122): the forward runs the z form (z before
    dropout) and saves z, or with save_hidden=False the serving form and
    no z, which the backward recomputes, z = bf16(ln w1 + b1); the
    backward regenerates the masks with drop_ew (gm, hd, dz), or, without
    dropout, runs the dz kernel on g * gamma; the products are plain
    matmuls."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, seed,
                ln_eps, use_residual, drop, save_hidden):
        flags = dict(gamma=gamma, seed=seed, drop=drop)
        if save_hidden:
            out, z = fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        ln_eps, use_residual,
                                        return_hidden=True, **flags)
        else:
            out = fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     ln_eps, use_residual, **flags)
            z = None
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, z)
        ctx.cfg = (seed, ln_eps, use_residual, drop)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, z = ctx.saved_tensors
        seed, ln_eps, use_residual, drop = ctx.cfg
        C, dt = x.shape[-1], x.dtype
        x2, g2 = x.reshape(-1, C), g.reshape(-1, C).contiguous()
        lnf, xhat, inv = ln_fwd_f32(x2.float(), ln_scale, ln_bias, ln_eps)
        ln = lnf.to(dt)
        if z is None:             # recompute-from-x, then the same passes
            z = (_mm_f32(ln, w1) + b1.float()).to(dt)
        gf = gamma.float()
        if drop > 0.0:
            gm2b = drop_ew(g2, seed, drop, dr._SITE_MLP_OUT, "gm")
            h_db = drop_ew(z, seed, drop, dr._SITE_MLP_HID, "hd")
            gm2 = gm2b.float()
            dh = _mm_f32((gm2 * gf).to(dt), w2.t())
            dz = drop_ew(z, seed, drop, dr._SITE_MLP_HID, "dz", dh=dh)
            del dh
            db1 = dz.float().sum(0)
        else:
            gm2b, gm2 = g2, g2.float()
            dz, db1 = mlp_dz((gm2 * gf).to(dt), z, w2)
            # gelu(z) in float32 from the rounded z, rounded once
            h_db = torch.nn.functional.gelu(z, approximate="none")
        dw1 = _wgrad(ln, dz, w1.dtype)
        A2 = _mm_f32(h_db.t(), gm2b)
        del h_db
        colsum = gm2.sum(0)
        dgamma = (A2 * w2.float()).sum(0) + b2.float() * colsum
        dw2 = (A2 * gf).to(w2.dtype)
        dln = _mm_f32(dz, w1.t())
        dxf, dlns, dlnb = ln_bwd_f32(dln, ln_scale, xhat, inv)
        if use_residual:
            dxf += g2                        # float32 += bf16, in place
        return (dxf.to(dt).view_as(x), dlns.to(ln_scale.dtype),
                dlnb.to(ln_bias.dtype), dw1, db1.to(b1.dtype), dw2,
                (gf * colsum).to(b2.dtype), dgamma.to(gamma.dtype), None,
                None, None, None, None)


def attention_residual_reg(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                           gamma, seed, num_heads, seg_len, scale,
                           ln_eps=1e-6, use_ln=True, use_residual=True,
                           attn_drop=0.0, proj_drop=0.0, bwd_dw=False):
    """fused_attention_residual_reg, differentiable (:1202). bwd_dw: the
    backward kernel's dw form (DUOFORMER_BWD_DW=1)."""
    return _AttentionResidualReg.apply(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, gamma, seed,
        num_heads, seg_len, scale, ln_eps, use_ln, use_residual, attn_drop,
        proj_drop, bwd_dw)


def mlp_residual_reg(x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, seed,
                     ln_eps=1e-6, use_residual=True, drop=0.0,
                     save_hidden=True):
    """fused_mlp_residual_reg, differentiable (:1940): where a gradient will
    be taken the z form, or with save_hidden=False
    (DUOFORMER_MLP_SAVE_HIDDEN=0) the serving form and a backward that
    recomputes z; the serving form otherwise."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      gamma)):
        return _MLPResidualReg.apply(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                     gamma, seed, ln_eps, use_residual, drop,
                                     save_hidden)
    return fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps,
                              use_residual, gamma=gamma, seed=seed,
                              drop=drop)
