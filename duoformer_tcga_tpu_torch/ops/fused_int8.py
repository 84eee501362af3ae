"""The port's int8 (a8w8) serving kernels, their plain PyTorch versions
and launch counts (counterpart of the int8 forms of
duoformer_tcga_tpu/ops/pallas_attention.py).

  fused_attention_residual_int8: y = [x +] proj_q(rowquant(attn(
      qkv_q(rowquant([LN] x))))), the attention core in x's dtype
    kernel: csrc/fused_attention_residual_int8.cu (seg_len <= 64); for 65
    to 86 tokens two launches, attention_core_int8_s86 (o = attn(qkv_q(
    rowquant([LN] x)))) and attention_proj_int8 (y = [x +] proj_q(
    rowquant(o))), kernels: csrc/fused_attention_residual_int8_s86.cu
  fused_mlp_residual_int8: y = [x +] fc2_q(rowquant(gelu(fc1_q(
      rowquant(LN x)))))
    kernel: csrc/fused_mlp_residual_int8.cu

Weights are int8 [out, in] (QuantLinear's layout, K contiguous) with a
float32 scale per output channel; activations are quantized per row,
inside the kernel, from float32. Serving only: there is no backward, as
the JAX package has no vjp for these kernels, so a call that autograd
would record raises.

Dispatch is by the tensor's device and nothing else: a CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises. There is
no fallback from the kernel to the plain version. Launches are counted in
fused_attention.launch_counts, beside the bf16 forms.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_attention import (ATTN_MAX_SEG_LEN, ATTN_SERVE_MAX_SEG_LEN,
                              _check_attention_x, _check_tensor,
                              _check_width, _ptr, _require, _stream,
                              launch_counts)

_INT8 = torch.int8


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def round_half_away(v):
    """Round to nearest, ties away from zero (jax.lax.round's default).
    torch.round ties to even; sign(v) * floor(|v| + 0.5) is wrong just
    below 0.5 in float32, where |v| + 0.5 rounds up to 1."""
    t = v.trunc()
    return torch.where((v - t).abs() == 0.5, t + v.sign(), v.round())


def rowquant_plain(v):
    """Per-row symmetric int8 of float32 v [..., K] (_rowquant,
    pallas_attention.py:1491-1496) -> (q int8, scale float32 [..., 1]):
    scale = amax / 127 (1 for a zero row), q = clip(round(v / scale))."""
    v = v.float()
    amax = v.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(round_half_away(v / s), -127, 127).to(_INT8), s


def int8_matmul_plain(a_q, w_q):
    """a_q int8 [..., K] @ w_q int8 [N, K]^T, exact, as float32 [..., N].
    Accumulated in float64: |acc| reaches 127^2 * K (5e7 at K = 3072),
    beyond float32's 2^24, and every sum of int8 products below 2^53 is
    exact in float64. The result is the int32 accumulator's value, then
    rounded to float32 as the kernels' (float)acc."""
    return torch.matmul(a_q.double(), w_q.double().t()).float()


def _ln_f32(x, ln_scale, ln_bias, ln_eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + ln_eps) * ln_scale.float()
            + ln_bias.float())


def attention_core_int8_plain(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                              num_heads, seg_len, scale, ln_eps=1e-6,
                              use_ln=True):
    """Plain twin of the 65..86-token int8 core kernel, and the first half
    of fused_attention_residual_int8_plain: x [n_seg, seg_len, C] -> o
    [n_seg, seg_len, C] in x's dtype. LN (or x) row-quantized from
    float32; qkv = acc * s_row * s_col + b in float32, cast to x's dtype;
    p cast to x's dtype; each head's o cast to x's dtype."""
    n_seg, S, C = x.shape
    if S != seg_len:
        raise ValueError(f"x has {S} tokens per segment, seg_len={seg_len}")
    dt = x.dtype
    D = C // num_heads
    ln = _ln_f32(x, ln_scale, ln_bias, ln_eps) if use_ln else x.float()
    lq, ls = rowquant_plain(ln)
    qkv = (int8_matmul_plain(lq, wqkv_q) * ls * sqkv.float()
           + bqkv.float()).to(dt)
    q, k, v = qkv.view(n_seg, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p.float(), v.float()).to(dt)           # [n, H, S, D]
    return o.permute(0, 2, 1, 3).reshape(n_seg, S, C)


def attention_proj_int8_plain(o, x, wproj_q, sproj, bproj,
                              use_residual=True):
    """Plain twin of the int8 proj kernel, and the second half of
    fused_attention_residual_int8_plain: o, x [..., C] -> y = acc * s_row
    * s_col + b [+ x] in float32, cast once to x's dtype, with o
    row-quantized over all C columns."""
    aq, as_ = rowquant_plain(o)
    y = int8_matmul_plain(aq, wproj_q) * as_ * sproj.float() + bproj.float()
    if use_residual:
        y = y + x.float()
    return y.to(x.dtype)


def fused_attention_residual_int8_plain(x, ln_scale, ln_bias, wqkv_q, sqkv,
                                        bqkv, wproj_q, sproj, bproj,
                                        num_heads, seg_len, scale,
                                        ln_eps=1e-6, use_ln=True,
                                        use_residual=True):
    """Plain twin of the int8 attention kernel (_fused_block_int8_kernel,
    pallas_attention.py:442-506): x [n_seg, seg_len, C]; wqkv_q int8
    [3C, C], wproj_q int8 [C, C]. Rounds where the TPU kernel does: LN
    (or x) row-quantized from float32; qkv = acc * s_row * s_col + b in
    float32, cast to x's dtype; p cast to x's dtype; each head's o cast
    to x's dtype, then o row-quantized over all C columns; y = acc * s_row
    * s_col + b [+ x] in float32, cast once. It is
    attention_core_int8_plain followed by attention_proj_int8_plain, the
    two kernels of the 65..86-token form."""
    o = attention_core_int8_plain(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                                  num_heads, seg_len, scale, ln_eps, use_ln)
    return attention_proj_int8_plain(o, x, wproj_q, sproj, bproj,
                                     use_residual)


def fused_mlp_residual_int8_plain(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q,
                                  s2, b2, ln_eps=1e-6, use_residual=True):
    """Plain twin of the int8 MLP kernel (_fused_mlp_int8_kernel,
    pallas_attention.py:1499-1524): x [..., C]; w1_q int8 [hidden, C],
    w2_q int8 [C, hidden]. LN row-quantized from float32; h = gelu(acc *
    s_row * s1 + b1) in float32 (exact erf), row-quantized over the whole
    hidden row from float32, never rounded to x's dtype; y = acc * s_row
    * s2 + b2 [+ x] in float32, cast once."""
    dt = x.dtype
    lq, ls = rowquant_plain(_ln_f32(x, ln_scale, ln_bias, ln_eps))
    h = int8_matmul_plain(lq, w1_q) * ls * s1.float() + b1.float()
    h = torch.nn.functional.gelu(h, approximate="none")
    hq, hs = rowquant_plain(h)
    y = int8_matmul_plain(hq, w2_q) * hs * s2.float() + b2.float()
    if use_residual:
        y = y + x.float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _refuse_autograd(what, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is serving only: it has no backward (nor has the JAX "
            f"package's); call it under torch.no_grad() or "
            f"torch.inference_mode()")


def fused_attention_residual_int8(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                                  wproj_q, sproj, bproj, num_heads, seg_len,
                                  scale, ln_eps=1e-6, use_ln=True,
                                  use_residual=True):
    """int8 serving form of the attention branch (pallas_attention.py:512);
    x [n_seg, seg_len, C], wqkv_q int8 [3C, C], wproj_q int8 [C, C].
    use_ln=use_residual=False is the bare form the patch blocks run. On
    the card: bf16 x, float32 vectors, head width 64, seg_len <= 86 (65..86
    in two launches, attention_core_int8_s86 and attention_proj_int8)."""
    _refuse_autograd("fused_attention_residual_int8", x, ln_scale, ln_bias,
                     sqkv, bqkv, sproj, bproj)
    if x.device.type == "cpu":
        return fused_attention_residual_int8_plain(
            x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv, wproj_q, sproj, bproj,
            num_heads, seg_len, scale, ln_eps, use_ln, use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n_seg, S, C = _check_attention_x(x, seg_len, num_heads,
                                     "fused_attention_residual_int8",
                                     ATTN_SERVE_MAX_SEG_LEN)
    if S > ATTN_MAX_SEG_LEN:
        o = attention_core_int8_s86(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                                    num_heads, S, scale, ln_eps, use_ln)
        return attention_proj_int8(o, x, wproj_q, sproj, bproj, use_residual)
    dev, f32 = x.device, torch.float32
    _check_tensor("x", x, dev, torch.bfloat16, (n_seg, S, C))
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("wqkv_q", wqkv_q, dev, _INT8, (3 * C, C))
    _check_tensor("sqkv", sqkv, dev, f32, (3 * C,))
    _check_tensor("bqkv", bqkv, dev, f32, (3 * C,))
    _check_tensor("wproj_q", wproj_q, dev, _INT8, (C, C))
    _check_tensor("sproj", sproj, dev, f32, (C,))
    _check_tensor("bproj", bproj, dev, f32, (C,))
    out = torch.empty_like(x)
    if n_seg == 0:
        return out
    lib = _build.load_library("fused_attention_residual_int8")
    fn = lib.launch_fused_attention_residual_int8
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv_q),
                    _ptr(sqkv), _ptr(bqkv), _ptr(wproj_q), _ptr(sproj),
                    _ptr(bproj), _ptr(out), n_seg, S, C, num_heads,
                    float(scale), float(ln_eps), int(bool(use_ln)),
                    int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, "fused_attention_residual_int8")
    launch_counts["fused_attention_residual_int8" if use_ln
                  else "fused_attention_residual_int8_bare"] += 1
    return out


def attention_core_int8_s86(x, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                            num_heads, seg_len, scale, ln_eps=1e-6,
                            use_ln=True):
    """The first launch of the 65..86-token int8 attention branch: o =
    attn(qkv_q(rowquant([LN](x)))), x [n_seg, seg_len, C] -> o [n_seg,
    seg_len, C] in bf16. On the card: bf16 x, int8 wqkv_q [3C, C],
    float32 vectors, head width 64, 65 <= seg_len <= 86."""
    _refuse_autograd("attention_core_int8_s86", x, ln_scale, ln_bias, sqkv,
                     bqkv)
    if x.device.type == "cpu":
        return attention_core_int8_plain(x, ln_scale, ln_bias, wqkv_q, sqkv,
                                         bqkv, num_heads, seg_len, scale,
                                         ln_eps, use_ln)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n_seg, S, C = _check_attention_x(x, seg_len, num_heads,
                                     "attention_core_int8_s86",
                                     ATTN_SERVE_MAX_SEG_LEN)
    _require(S > ATTN_MAX_SEG_LEN, f"seg_len {S}: the 86-token kernel takes "
             f"{ATTN_MAX_SEG_LEN + 1}..{ATTN_SERVE_MAX_SEG_LEN}")
    dev, f32 = x.device, torch.float32
    _check_tensor("x", x, dev, torch.bfloat16, (n_seg, S, C))
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("wqkv_q", wqkv_q, dev, _INT8, (3 * C, C))
    _check_tensor("sqkv", sqkv, dev, f32, (3 * C,))
    _check_tensor("bqkv", bqkv, dev, f32, (3 * C,))
    o = torch.empty_like(x)
    if n_seg == 0:
        return o
    lib = _build.load_library("fused_attention_residual_int8_s86")
    fn = lib.launch_attention_core_int8_s86
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv_q),
                    _ptr(sqkv), _ptr(bqkv), _ptr(o), n_seg, S, C, num_heads,
                    float(scale), float(ln_eps), int(bool(use_ln)),
                    _stream(dev))
    _build.check(lib, status, "attention_core_int8_s86")
    launch_counts["fused_attention_residual_int8_s86" if use_ln
                  else "fused_attention_residual_int8_s86_bare"] += 1
    return o


def attention_proj_int8(o, x, wproj_q, sproj, bproj, use_residual=True):
    """The second launch of the 65..86-token int8 attention branch: y =
    [x +] proj_q(rowquant(o)), each row of o quantized over all C, then
    acc * s_row * s_col + b in float32, cast once; o, x [..., C]. On the
    card: bf16 o and x, int8 wproj_q [C, C], float32 vectors, C in
    SUPPORTED_C."""
    _refuse_autograd("attention_proj_int8", o, x, sproj, bproj)
    if o.device.type == "cpu":
        return attention_proj_int8_plain(o, x, wproj_q, sproj, bproj,
                                         use_residual)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    C = o.shape[-1]
    rows = o.numel() // C if C else 0
    _check_width(C, "attention_proj_int8")
    dev, f32 = o.device, torch.float32
    _check_tensor("o", o, dev, torch.bfloat16, o.shape)
    _check_tensor("x", x, dev, torch.bfloat16, o.shape)
    _check_tensor("wproj_q", wproj_q, dev, _INT8, (C, C))
    _check_tensor("sproj", sproj, dev, f32, (C,))
    _check_tensor("bproj", bproj, dev, f32, (C,))
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library("fused_attention_residual_int8_s86")
    fn = lib.launch_attention_proj_int8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(o), _ptr(x), _ptr(wproj_q), _ptr(sproj),
                    _ptr(bproj), _ptr(out), rows, C, int(bool(use_residual)),
                    _stream(dev))
    _build.check(lib, status, "attention_proj_int8")
    launch_counts["fused_attention_residual_int8_s86_proj" if use_residual
                  else "fused_attention_residual_int8_s86_proj_bare"] += 1
    return out


def fused_mlp_residual_int8(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                            ln_eps=1e-6, use_residual=True):
    """int8 serving form of the MLP branch (pallas_attention.py:1527); x
    [..., C], w1_q int8 [hidden, C], w2_q int8 [C, hidden]. On the card:
    bf16 x, float32 vectors, hidden a multiple of 128."""
    _refuse_autograd("fused_mlp_residual_int8", x, ln_scale, ln_bias, s1, b1,
                     s2, b2)
    if x.device.type == "cpu":
        return fused_mlp_residual_int8_plain(x, ln_scale, ln_bias, w1_q, s1,
                                             b1, w2_q, s2, b2, ln_eps,
                                             use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    C = x.shape[-1]
    hidden = w1_q.shape[0]
    rows = x.numel() // C if C else 0
    _check_width(C, "fused_mlp_residual_int8")
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32 = x.device, torch.float32
    _check_tensor("x", x, dev, torch.bfloat16, x.shape)
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("w1_q", w1_q, dev, _INT8, (hidden, C))
    _check_tensor("s1", s1, dev, f32, (hidden,))
    _check_tensor("b1", b1, dev, f32, (hidden,))
    _check_tensor("w2_q", w2_q, dev, _INT8, (C, hidden))
    _check_tensor("s2", s2, dev, f32, (C,))
    _check_tensor("b2", b2, dev, f32, (C,))
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library("fused_mlp_residual_int8")
    fn = lib.launch_fused_mlp_residual_int8
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1_q),
                    _ptr(s1), _ptr(b1), _ptr(w2_q), _ptr(s2), _ptr(b2),
                    _ptr(out), rows, C, hidden, float(ln_eps),
                    int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, "fused_mlp_residual_int8")
    launch_counts["fused_mlp_residual_int8"] += 1
    return out
