"""Parameter initializers with the reference's torch/timm init semantics.

Counterpart of duoformer_tcga_tpu/ops/initializers.py. Every function
draws from an explicit torch.Generator on the CPU, so one seed gives the
same weights whatever device the model is later moved to. Shapes follow
the JAX package: linear weights (in, out), conv weights HWIO at the
call site (the conv modules transpose to OIHW themselves).
"""

from __future__ import annotations

import math

import torch


def trunc_normal(shape, std=0.02, generator=None):
    """timm trunc_normal_: N(0, std^2) truncated at +/- 2*std."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def normal(shape, std=1.0, generator=None):
    return torch.randn(shape, generator=generator) * std


def uniform(shape, bound, generator=None):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def zeros(shape):
    return torch.zeros(shape)


def ones(shape):
    return torch.ones(shape)


def kaiming_normal_conv(shape, generator=None):
    """torch kaiming_normal_ defaults (fan_in, gain sqrt(2)); shape HWIO."""
    kh, kw, cin, _ = shape
    return normal(shape, math.sqrt(2.0 / (kh * kw * cin)), generator)


def kaiming_normal_conv_fan_out(shape, generator=None):
    """torchvision ResNet conv init: kaiming_normal_(mode='fan_out',
    nonlinearity='relu'); shape HWIO."""
    kh, kw, _, cout = shape
    return normal(shape, math.sqrt(2.0 / (kh * kw * cout)), generator)


def torch_default_linear_weight(shape, generator=None):
    """torch nn.Linear default (kaiming_uniform a=sqrt(5)) for a weight
    stored (in, out): bound = 1/sqrt(fan_in)."""
    return uniform(shape, 1.0 / math.sqrt(shape[0]), generator)


def torch_default_bias(shape, fan_in, generator=None):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(shape, bound, generator)


def linear_init(in_features, out_features, bias=True, scheme="vit",
                generator=None):
    """-> (w [in, out], b [out] or None). scheme 'vit': trunc_normal .02
    and zero bias (timm ViT); 'torch': the nn.Linear default."""
    if scheme == "vit":
        w = trunc_normal((in_features, out_features), 0.02, generator)
        b = zeros((out_features,)) if bias else None
    elif scheme == "torch":
        w = torch_default_linear_weight((in_features, out_features),
                                        generator)
        b = (torch_default_bias((out_features,), in_features, generator)
             if bias else None)
    else:
        raise ValueError(f"unknown linear init scheme: {scheme}")
    return w, b
