"""The port's two fused transformer kernels, their plain PyTorch versions
and their launch counts (counterpart of
duoformer_tcga_tpu/ops/pallas_attention.py, inert forward forms only).

  fused_attention_residual: y = [x +] proj(block-diag attn(qkv([LN] x)))
    kernel: csrc/fused_attention_residual.cu
  fused_mlp_residual:       y = [x +] fc2(gelu_erf(fc1(LN x)))
    kernel: csrc/fused_mlp_residual.cu

Dispatch is by the tensor's device and nothing else: a CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises (wrong dtype,
shape or layout, a failed build, a refused launch). There is no fallback
from the kernel to the plain version.

The kernels take bf16 activations and weights (linear weights (in, out),
as in the JAX package) and float32 vectors (LayerNorm scale/bias, biases),
the types the JAX serving path feeds its kernels. Both plain versions
round where the TPU kernels round: LN output, qkv after its bias, softmax
probabilities, each head's output, the MLP hidden after GELU, and the
float32 proj/fc2 + residual sum once at the end.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .nn import layernorm

# Launches of each kernel form since the last reset_launch_counts(); a
# wrapper adds one where it launches its kernel and nowhere else.
launch_counts: collections.Counter = collections.Counter()

ATTN_MAX_SEG_LEN = 64         # a block holds at most 64 rows (csrc note)
HEAD_DIM = 64                 # the attention kernel's head width
SUPPORTED_C = (256, 512, 768)   # widths the kernels are instantiated for


def reset_launch_counts():
    launch_counts.clear()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fused_attention_residual_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                   bproj, num_heads, seg_len, scale,
                                   ln_eps=1e-6, use_ln=True,
                                   use_residual=True):
    """Plain twin of the attention kernel (pallas_attention.py:311-439 /
    _fused_block_xla): x [n_seg, seg_len, C]; attention only within each
    segment."""
    n_seg, S, C = x.shape
    if S != seg_len:
        raise ValueError(f"x has {S} tokens per segment, seg_len={seg_len}")
    dt = x.dtype
    D = C // num_heads
    ln = layernorm(x, ln_scale, ln_bias, ln_eps) if use_ln else x
    qkv = (torch.matmul(ln.float(), wqkv.float()) + bqkv.float()).to(dt)
    q, k, v = qkv.view(n_seg, S, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p.float(), v.float()).to(dt)          # [n, H, S, D]
    attn = o.permute(0, 2, 1, 3).reshape(n_seg, S, C)
    y = torch.matmul(attn.float(), wproj.float()) + bproj.float()
    if use_residual:
        y = y + x.float()
    return y.to(dt)


def fused_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                             ln_eps=1e-6, use_residual=True):
    """Plain twin of the MLP kernel (pallas_attention.py:1306-1347):
    exact-erf GELU in float32, hidden rounded to x's dtype."""
    dt = x.dtype
    ln = layernorm(x, ln_scale, ln_bias, ln_eps)
    h = torch.matmul(ln.float(), w1.float()) + b1.float()
    h = torch.nn.functional.gelu(h, approximate="none").to(dt)
    y = torch.matmul(h.float(), w2.float()) + b2.float()
    if use_residual:
        y = y + x.float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    # the kernels copy rows in 16-byte cp.async chunks from aligned starts
    _require(t.data_ptr() % 32 == 0, f"{name} must be 32-byte aligned")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_width(C, what):
    _require(C in SUPPORTED_C,
             f"{what}: the kernel is instantiated for C in {SUPPORTED_C}, "
             f"got {C}")


def fused_attention_residual(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                             num_heads, seg_len, scale, ln_eps=1e-6,
                             use_ln=True, use_residual=True):
    """y = [x +] proj(block_diag_attn(qkv([LN](x)))); x [n_seg, seg_len, C].

    The JAX signature (pallas_attention.py:1053). use_ln=use_residual=False
    is the bare form the patch blocks run. On the card: bf16 x and
    weights, float32 vectors, head width 64, seg_len <= 64."""
    if x.device.type == "cpu":
        return fused_attention_residual_plain(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads,
            seg_len, scale, ln_eps, use_ln, use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _require(x.dim() == 3, f"x must be [n_seg, seg_len, C], got "
             f"{tuple(x.shape)}")
    n_seg, S, C = x.shape
    _require(S == seg_len, f"x has {S} tokens per segment, "
             f"seg_len={seg_len}")
    _require(1 <= S <= ATTN_MAX_SEG_LEN,
             f"seg_len {S} outside the kernel's 1..{ATTN_MAX_SEG_LEN}")
    _require(num_heads * HEAD_DIM == C,
             f"the kernel needs head width {HEAD_DIM}: C={C}, "
             f"num_heads={num_heads}")
    _check_width(C, "fused_attention_residual")
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    _check_tensor("x", x, dev, bf16, (n_seg, S, C))
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("wqkv", wqkv, dev, bf16, (C, 3 * C))
    _check_tensor("bqkv", bqkv, dev, f32, (3 * C,))
    _check_tensor("wproj", wproj, dev, bf16, (C, C))
    _check_tensor("bproj", bproj, dev, f32, (C,))
    out = torch.empty_like(x)
    if n_seg == 0:
        return out
    lib = _build.load_library("fused_attention_residual")
    fn = lib.launch_fused_attention_residual
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
        [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv),
                    _ptr(bqkv), _ptr(wproj), _ptr(bproj), _ptr(out),
                    n_seg, S, C, num_heads, float(scale), float(ln_eps),
                    int(bool(use_ln)), int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, "fused_attention_residual")
    launch_counts["fused_attention_residual" if use_ln
                  else "fused_attention_residual_bare"] += 1
    return out


def fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps=1e-6,
                       use_residual=True):
    """y = [x +] fc2(gelu(fc1(LN(x)))); x [..., C]. The JAX signature
    (pallas_attention.py:1696). On the card: bf16 x and weights, float32
    vectors, hidden a multiple of 128."""
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                        ln_eps, use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    C = x.shape[-1]
    hidden = w1.shape[-1]
    rows = x.numel() // C if C else 0
    _check_width(C, "fused_mlp_residual")
    _require(hidden % 128 == 0 and hidden > 0,
             f"hidden width {hidden} must be a positive multiple of 128")
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    _check_tensor("x", x, dev, bf16, x.shape)
    _check_tensor("ln_scale", ln_scale, dev, f32, (C,))
    _check_tensor("ln_bias", ln_bias, dev, f32, (C,))
    _check_tensor("w1", w1, dev, bf16, (C, hidden))
    _check_tensor("b1", b1, dev, f32, (hidden,))
    _check_tensor("w2", w2, dev, bf16, (hidden, C))
    _check_tensor("b2", b2, dev, f32, (C,))
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library("fused_mlp_residual")
    fn = lib.launch_fused_mlp_residual
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(w1),
                    _ptr(b1), _ptr(w2), _ptr(b2), _ptr(out), rows, C, hidden,
                    float(ln_eps), int(bool(use_residual)), _stream(dev))
    _build.check(lib, status, "fused_mlp_residual")
    launch_counts["fused_mlp_residual"] += 1
    return out
