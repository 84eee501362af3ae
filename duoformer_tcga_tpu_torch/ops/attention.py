"""Multi-head attention of the port (counterpart of
duoformer_tcga_tpu/ops/attention.py).

`multihead_attention` is the bare attention of the PatchBlocks and of the
legacy family's region pass: qkv -> softmax(q k^T * scale) v per head ->
proj, with no LayerNorm and no residual. It runs as the bare form of the
fused attention kernel and its backward (ops/fused_attention.py), which
replace attention.py:174-239; an attention with a dropout rate runs the
bare reg form (ops/fused_reg.py, attention.py:218-228), its mask drawn
from the seed in training and off in eval. The weights are cast to x's
dtype where they are used. `_qkv_heads`
and `_sdpa` are the unfused composition (attention.py:52-71), kept for
the tests only.
"""

from __future__ import annotations

import torch
from torch import nn

from . import nn as ops
from .fused_attention import attention_residual
from .fused_int8 import fused_attention_residual_int8
from .fused_reg import attention_residual_reg
from .quantize import QuantLinear


class Attention(nn.Module):
    """One attention parameter set: qkv (dim -> 3*dim) and proj, timm ViT
    init. qk_norm=True adds per-head LayerNorms q_norm, k_norm over the
    head width (quirk Q9: the reference creates them when attn_drop > 0,
    attention.py:45-48). The paths ported so far carry them unapplied, as
    the scale blocks and the legacy region pass do (transformer.py:736);
    they load and export with the rest."""

    def __init__(self, dim, num_heads, qkv_bias=True, generator=None,
                 qk_norm=False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = ops.Linear(dim, 3 * dim, qkv_bias, "vit", generator)
        self.proj = ops.Linear(dim, dim, True, "vit", generator)
        if qk_norm:
            self.q_norm = ops.LayerNorm(dim // num_heads)
            self.k_norm = ops.LayerNorm(dim // num_heads)


def _bias(linear, width, like):
    if linear.b is not None:
        return linear.b
    return like.new_zeros(width, dtype=torch.float32)


def multihead_attention(attn: Attention, x, num_heads, scale=None,
                        attn_drop=0.0, seed=None, bwd_dw=False):
    """Bare MHSA over the second-to-last axis: x [..., S, C] -> same. A
    quantized Attention (QuantLinear qkv/proj) runs the bare int8 form
    (attention.py:209-217). attn_drop > 0: the bare reg form, dropping
    the probabilities with the mask of `seed` (an int32, given in
    training) or, with seed None, not at all. bwd_dw: the backward
    kernel's dw form."""
    *lead, S, C = x.shape
    if scale is None:
        scale = (C // num_heads) ** -0.5
    zeros = x.new_zeros(C, dtype=torch.float32)
    if attn_drop > 0.0 and not isinstance(attn.qkv, QuantLinear):
        out = attention_residual_reg(
            x.reshape(-1, S, C), zeros, zeros, attn.qkv.w.to(x.dtype),
            _bias(attn.qkv, 3 * C, x), attn.proj.w.to(x.dtype),
            _bias(attn.proj, C, x), x.new_ones(C, dtype=torch.float32),
            0 if seed is None else seed, num_heads, S, float(scale), 1e-6,
            use_ln=False, use_residual=False,
            attn_drop=0.0 if seed is None else attn_drop, bwd_dw=bwd_dw)
        return out.reshape(*lead, S, C)
    if isinstance(attn.qkv, QuantLinear):
        out = fused_attention_residual_int8(
            x.reshape(-1, S, C), zeros, zeros, attn.qkv.w_q,
            attn.qkv.w_scale, _bias(attn.qkv, 3 * C, x), attn.proj.w_q,
            attn.proj.w_scale, _bias(attn.proj, C, x), num_heads, S,
            float(scale), 1e-6, use_ln=False, use_residual=False)
        return out.reshape(*lead, S, C)
    out = attention_residual(
        x.reshape(-1, S, C), zeros, zeros, attn.qkv.w.to(x.dtype),
        _bias(attn.qkv, 3 * C, x), attn.proj.w.to(x.dtype),
        _bias(attn.proj, C, x), num_heads, S, float(scale), 1e-6,
        use_ln=False, use_residual=False, bwd_dw=bwd_dw)
    return out.reshape(*lead, S, C)


def _qkv_heads(attn: Attention, x, num_heads):
    """x [..., S, C] -> q, k, v each [..., H, S, D] (torch head layout)."""
    *lead, S, C = x.shape
    D = C // num_heads
    qkv = attn.qkv(x).reshape(*lead, S, 3, num_heads, D)
    qkv = torch.movedim(qkv, (-3, -2), (0, -3))          # [3, ..., H, S, D]
    return qkv[0], qkv[1], qkv[2]


def _sdpa(q, k, v, scale):
    """softmax(q k^T * scale) v over the last two axes, float32 softmax."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def multihead_attention_unfused(attn: Attention, x, num_heads, scale=None):
    """The unfused composition of `multihead_attention` (tests only)."""
    *lead, S, C = x.shape
    if scale is None:
        scale = (C // num_heads) ** -0.5
    q, k, v = _qkv_heads(attn, x, num_heads)
    out = torch.movedim(_sdpa(q, k, v, scale), -3, -2).reshape(*lead, S, C)
    return attn.proj(out)
