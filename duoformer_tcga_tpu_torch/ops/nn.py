"""Neural-net primitives of the port (counterpart of
duoformer_tcga_tpu/ops/nn.py), as plain functions plus the small
parameter-holding modules built on them.

`fused_layernorm` is the row LayerNorm kernel (csrc/layernorm.cu, the JAX
package's ops/pallas_norm.py), which LayerNorm(fused=True) takes for a
width that is a multiple of 128, as pallas_norm.use_fused_ln gates it.

Layouts: linear weights are kept (in, out), as in the JAX package, so the
fused kernels take them as they are. Convolutions run NCHW with OIHW
weights, the layout cuDNN expects; the models keep both in channels_last
memory on the card, so a permute of an NHWC batch is already the
operand cuDNN wants. Vectors (biases, norm scales, folded BN) stay float32
in every serving dtype: the JAX package reads them as float32 too.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from . import _build
from . import initializers as init
from ._build import (_check_tensor, _ptr, _require, _stream, count_launch,
                     f32_form)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def linear(x, w, b=None):
    """y = x @ w + b with w (in, out) cast to x's dtype, accumulated in
    float32 and rounded once to x's dtype (nn.py:56-61)."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def layernorm(x, scale, bias, eps=1e-6):
    """LayerNorm over the last axis, float32 statistics (two-pass
    variance, as nn.py:72-87)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_layernorm_plain(x, scale, bias, eps=1e-6):
    """Plain twin of the LayerNorm kernel (_ln_kernel, pallas_norm.py:47-53):
    float32 mean and two-pass variance, one rounding to x's dtype."""
    return layernorm(x, scale, bias, eps)


def _fused_layernorm_fwd(x, scale, bias, eps):
    """The LayerNorm kernel (pallas_norm._impl, :65-93): x [..., C] -> like
    x. On the card: bf16 x, float32 scale and bias, C a multiple of 128
    (the kernel walks a row in 256-column strides, the last one partial at
    C = 384; a launch at 384 counts as fused_layernorm_c384)."""
    if x.device.type == "cpu":
        return fused_layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.float32:
        f32_form("fused_layernorm", C=x.shape[-1])
    C = x.shape[-1]
    _require(C > 0 and C % 128 == 0,
             f"the LayerNorm kernel needs C a multiple of 128, got {C}")
    dev = x.device
    _check_tensor("x", x, dev, torch.bfloat16, x.shape)
    _check_tensor("scale", scale, dev, torch.float32, (C,))
    _check_tensor("bias", bias, dev, torch.float32, (C,))
    out = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return out
    lib = _build.load_library("layernorm")
    fn = lib.launch_layernorm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(_ptr(x), _ptr(scale), _ptr(bias), _ptr(out), rows, C,
                    float(eps), _stream(dev))
    _build.check(lib, status, "layernorm")
    count_launch("fused_layernorm", C)
    return out


class _FusedLayerNorm(torch.autograd.Function):
    """fused_layernorm (pallas_norm.py:96-112): the kernel forward; the
    backward recomputes through the plain version's autograd, as _bwd
    takes the XLA reference's vjp."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _fused_layernorm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = fused_layernorm_plain(*leaves, ctx.eps)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def fused_layernorm(x, scale, bias, eps=1e-6):
    """LayerNorm over the last axis through the kernel, differentiable
    (pallas_norm.fused_layernorm); x [..., C], C % 128 == 0. A strided x
    (the CLS rows of a token batch) is copied to rows first, as the JAX
    package's reshape does."""
    return _FusedLayerNorm.apply(x.contiguous(), scale, bias, eps)


def _same_padding(size, k, s):
    """XLA 'SAME': total = max((ceil(n/s)-1)*s + k - n, 0), low half
    rounded down."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, b=None, stride=1, padding="SAME"):
    """x: [N, C, H, W]; w: OIHW. padding: 'SAME', 'VALID' or an int
    (symmetric, torch style) — the JAX conv2d's three forms. The bias is
    added in float32 after the convolution, as nn.py:135-137 does."""
    if isinstance(padding, int):
        y = F.conv2d(x, w, stride=stride, padding=padding)
    elif padding == "VALID":
        y = F.conv2d(x, w, stride=stride)
    elif padding == "SAME":
        kh, kw = w.shape[2:]
        ph = _same_padding(x.shape[2], kh, stride)
        pw = _same_padding(x.shape[3], kw, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
        else:
            y = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                         stride=stride)
    else:
        raise ValueError(f"padding must be 'SAME', 'VALID' or an int, "
                         f"got {padding!r}")
    if b is not None:
        y = (y.float() + b.float()[:, None, None]).to(x.dtype)
    return y


def batchnorm(x, scale, bias, mean, var, eps=1e-5):
    """Inference BatchNorm over dim 1 of an NCHW tensor (running stats),
    computed in float32 and rounded once to x's dtype: one pass over x."""
    return F.batch_norm(x, mean.float(), var.float(), scale.float(),
                        bias.float(), training=False, momentum=0.0, eps=eps)


def batchnorm_batch_stats(x, scale, bias, eps=1e-5):
    """Training BatchNorm over dim 1 of an NCHW tensor: the batch's mean
    and biased variance (float32), differentiable through both, and no
    running statistics updated (nn.py:153-170 with train=True, stats
    None)."""
    return F.batch_norm(x, None, None, scale.float(), bias.float(),
                        training=True, momentum=0.0, eps=eps)


def fold_batchnorm(scale, bias, mean, var, eps=1e-5):
    """Inference BN -> per-channel float32 (scale, bias) for `affine`."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


# eps of a folded BN: batch_norm wants eps > 0, and 1 + 1e-12 rounds to 1
# in float32, so mean 0 / variance 1 / this eps is exactly x * scale + bias
AFFINE_EPS = 1e-12


def affine(x, scale, bias):
    """Per-channel x * scale + bias over dim 1 of NCHW, in float32: a batch
    norm with mean 0 and variance 1, which is exactly that."""
    return batchnorm(x, scale, bias, torch.zeros_like(scale),
                     torch.ones_like(scale), AFFINE_EPS)


def maxpool2d(x, window=2, stride=2, padding="VALID"):
    """torch MaxPool2d (floor mode) over NCHW; an int padding pads with
    -inf, as the JAX reduce_window does; "SAME" pads XLA's way (low half
    rounded down, so (0, 1) for the 3x3 stride-2 pool at 112^2) with -inf
    (nn.py:254-267)."""
    if padding == "SAME":
        ph = _same_padding(x.shape[2], window, stride)
        pw = _same_padding(x.shape[3], window, stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        padding = 0
    elif padding == "VALID":
        padding = 0
    return F.max_pool2d(x, window, stride, padding)


def groupnorm(x, scale, bias, groups=32, eps=1e-5):
    """GroupNorm over an NCHW tensor (nn.py:208-221): each group of C /
    groups channels normalised over (C / groups, H, W) per sample with
    float32 statistics, then the float32 per-channel affine, rounded once
    to x's dtype."""
    return F.group_norm(x.float(), groups, scale.float(), bias.float(),
                        eps).to(x.dtype)


STD_CONV_EPS = 1e-8


def standardize_weight(w, eps=STD_CONV_EPS):
    """Weight standardisation of an OIHW kernel (nn.py:223-233): per
    output channel over (I, H, W), biased variance, in float32."""
    w = w.float()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (w - mean) * torch.rsqrt(var + eps)


def stdconv2d(x, w, stride=1, padding="SAME", eps=STD_CONV_EPS):
    """The weight-standardised convolution of the ResNetV2 trunks (timm
    StdConv2dSame): w standardised in float32 from the float32 weight, then
    conv2d in x's dtype."""
    return conv2d(x, standardize_weight(w, eps).to(x.dtype), None, stride,
                  padding)


def relu(x):
    return torch.relu(x)


def gelu(x):
    """Exact (erf) GELU computed in float32."""
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def mlp(x, w1, b1, w2, b2):
    """timm Mlp forward without dropout: fc1 -> GELU -> fc2."""
    return linear(gelu(linear(x, w1, b1)), w2, b2)


# ---------------------------------------------------------------------------
# Modules (parameter names follow the JAX param-tree keys)
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias=True, scheme="vit",
                 generator=None):
        super().__init__()
        w, b = init.linear_init(in_features, out_features, bias, scheme,
                                generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b) if b is not None else None

    def forward(self, x):
        return linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    """fused: run the LayerNorm kernel where the width is a multiple of 128
    (the JAX package's DUOFORMER_FUSED_LN=1 and its gate,
    pallas_norm.py:35-44), the plain layernorm otherwise."""

    def __init__(self, dim, eps=1e-6, fused=False):
        super().__init__()
        self.eps = eps
        self.fused = fused
        self.scale = nn.Parameter(init.ones((dim,)))
        self.bias = nn.Parameter(init.zeros((dim,)))

    def forward(self, x):
        if self.fused and x.shape[-1] % 128 == 0:
            return fused_layernorm(x, self.scale, self.bias, self.eps)
        return layernorm(x, self.scale, self.bias, self.eps)


class Conv2d(nn.Module):
    """Conv with an OIHW weight `w` (initialised HWIO as the JAX package
    does, then transposed). scheme: 'kaiming' (fan_in, bias normal 1e-6),
    'kaiming_fan_out' (torchvision ResNet, no bias), 'torch' (the
    nn.Conv2d default: weight and bias uniform in 1/sqrt(fan_in))."""

    def __init__(self, kh, kw, cin, cout, bias=True, scheme="kaiming",
                 generator=None):
        super().__init__()
        shape = (kh, kw, cin, cout)
        if scheme == "kaiming":
            w = init.kaiming_normal_conv(shape, generator)
        elif scheme == "kaiming_fan_out":
            w = init.kaiming_normal_conv_fan_out(shape, generator)
        elif scheme == "torch":
            w = init.uniform(shape, (kh * kw * cin) ** -0.5, generator)
        else:
            raise ValueError(f"unknown conv init scheme: {scheme}")
        self.w = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        if not bias:
            self.b = None
        elif scheme == "torch":
            self.b = nn.Parameter(init.torch_default_bias(
                (cout,), kh * kw * cin, generator))
        else:
            self.b = nn.Parameter(init.normal((cout,), 1e-6, generator))

    def forward(self, x, stride=1, padding="SAME"):
        return conv2d(x, self.w.to(x.dtype), self.b, stride, padding)


class StdConv2d(Conv2d):
    """A bias-free Conv2d (torchvision's kaiming fan_out init, as the JAX
    trunk draws it) whose kernel is standardised at every forward
    (stdconv2d). standardize_() replaces the kernel by its standardised
    float32 form once, for serving: the Predictor does it before casting
    the weights, so the bf16 kernel is the rounded standardised float32
    one, as the JAX package computes it from its float32 masters."""

    def __init__(self, kh, kw, cin, cout, generator=None):
        super().__init__(kh, kw, cin, cout, False, "kaiming_fan_out",
                         generator)
        self.standardized = False

    @torch.no_grad()
    def standardize_(self):
        if not self.standardized:
            self.w.copy_(standardize_weight(self.w))
            self.standardized = True
        return self

    def forward(self, x, stride=1, padding="SAME"):
        if self.standardized:
            return conv2d(x, self.w.to(x.dtype), None, stride, padding)
        return stdconv2d(x, self.w, stride, padding)


class GroupNorm(nn.Module):
    def __init__(self, ch, groups=32, eps=1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.scale = nn.Parameter(init.ones((ch,)))
        self.bias = nn.Parameter(init.zeros((ch,)))

    def forward(self, x):
        return groupnorm(x, self.scale, self.bias, self.groups, self.eps)


def standardize_weights_(module):
    """In place: every StdConv2d under `module` to its standardised kernel
    (StdConv2d.standardize_). Returns `module`."""
    for m in module.modules():
        if isinstance(m, StdConv2d):
            m.standardize_()
    return module


def cast_weights_(module, dtype):
    """In place: every parameter of 2 or more dims (a weight) under
    `module` to `dtype`, vectors (biases, norms, BN) kept float32, as the
    JAX package reads them; on the card conv weights channels_last, the
    NHWC layout of the JAX package in memory. Returns `module`."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(dtype)
        for m in module.modules():
            if isinstance(m, Conv2d) and m.w.device.type == "cuda":
                m.w.data = m.w.data.contiguous(
                    memory_format=torch.channels_last)
    return module


class BatchNorm(nn.Module):
    """BatchNorm; fold() turns it into the bare float32 affine the serving
    path runs (exact under eval-mode BN). A folded BN keeps mean 0 and
    variance 1 as non-persistent buffers (and AFFINE_EPS), so both states
    take the same one-pass batch-norm call. In training mode an unfolded
    BN normalises with the batch's statistics and leaves the running ones
    as they are (the channel token's fusers, projection.py:119-126); the
    frozen backbone's BNs stay in eval mode."""

    def __init__(self, ch, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.folded = False
        self.scale = nn.Parameter(init.ones((ch,)))
        self.bias = nn.Parameter(init.zeros((ch,)))
        self.register_buffer("mean", init.zeros((ch,)))
        self.register_buffer("var", init.ones((ch,)))

    @torch.no_grad()
    def fold(self):
        if self.folded:
            return
        s, b = fold_batchnorm(self.scale, self.bias, self.mean, self.var,
                              self.eps)
        self.scale = nn.Parameter(s, requires_grad=False)
        self.bias = nn.Parameter(b, requires_grad=False)
        del self.mean, self.var
        self.register_buffer("mean", torch.zeros_like(s), persistent=False)
        self.register_buffer("var", torch.ones_like(s), persistent=False)
        self.folded = True

    def forward(self, x):
        if self.training and not self.folded:
            return batchnorm_batch_stats(x, self.scale, self.bias, self.eps)
        return batchnorm(x, self.scale, self.bias, self.mean, self.var,
                         AFFINE_EPS if self.folded else self.eps)
