"""Neural-net primitives of the port (counterpart of
duoformer_tcga_tpu/ops/nn.py), as plain functions plus the small
parameter-holding modules built on them.

Layouts: linear weights are kept (in, out), as in the JAX package, so the
fused kernels take them as they are. Convolutions run NCHW with OIHW
weights, the layout cuDNN expects; the models keep both in channels_last
memory on the card, so a permute of an NHWC batch is already the
operand cuDNN wants. Vectors (biases, norm scales, folded BN) stay float32
in every serving dtype: the JAX package reads them as float32 too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import initializers as init


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
    -inf, as the JAX reduce_window does."""
    if padding == "VALID":
        padding = 0
    return F.max_pool2d(x, window, stride, padding)


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
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(init.ones((dim,)))
        self.bias = nn.Parameter(init.zeros((dim,)))

    def forward(self, x):
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
