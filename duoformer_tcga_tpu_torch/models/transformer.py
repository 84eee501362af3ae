"""The release DuoFormer transformer core (counterpart of
duoformer_tcga_tpu/models/transformer.py: num_scale_tokens, ScaleBlock,
PatchBlock, MultiscaleFormer; transformer.py:58-72, 192-358, 430-594).

The JAX package stacks each depth's params and runs them with lax.scan;
here each stack is a ModuleList of `depth` blocks run in a Python loop.
Every ScaleBlock runs the two fused kernels (attention branch, then MLP
branch); every PatchBlock runs the bare form of the attention kernel. Both
go through the kernels' autograd functions, so the same forward trains.
A model quantized by ops/quantize.quantize_model_ (QuantLinear qkv, proj,
fc1, fc2) runs the int8 forms of both kernels instead, serving only.
Every weight and embedding is cast to the activations' dtype where it is
used, as the JAX package's `.astype(x.dtype)`: float32 master parameters
train through bf16 kernels; vectors (norms, biases) stay float32.

Reference quirks kept:
  * Q7: the head reads the raw CLS; fc_norm exists (and loads from
    checkpoints) but is applied only with apply_fc_norm=True.
  * Scale = head_dim ** -0.5 in both stacks (the release family).
  * Q6 (fixed in the JAX package too): num_scale_tokens counts 1 + 4^i.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import initializers as init
from ..ops import nn as ops
from ..ops.attention import Attention, multihead_attention
from ..ops.fused_attention import attention_residual, mlp_residual
from ..ops.fused_int8 import (fused_attention_residual_int8,
                              fused_mlp_residual_int8)
from ..ops.quantize import QuantLinear


def num_scale_tokens(scales: int) -> int:
    """1 scale/cls token + 4^0 + ... + 4^(scales-1): {1:2, 2:6, 3:22, 4:86}."""
    return 1 + sum(4 ** i for i in range(scales))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, generator=None):
        super().__init__()
        self.fc1 = ops.Linear(dim, hidden, True, "vit", generator)
        self.fc2 = ops.Linear(hidden, dim, True, "vit", generator)


class ScaleBlock(nn.Module):
    """Pre-norm attention + MLP over [..., S, C] (scale_attention.py:48-93),
    each branch one fused kernel."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 ln_eps=1e-6, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.ln_eps = ln_eps
        self.norm1 = ops.LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, generator)
        self.norm2 = ops.LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)

    def forward(self, x):
        *lead, S, C = x.shape
        dt = x.dtype
        qkv, proj = self.attn.qkv, self.attn.proj
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        bqkv = (qkv.b if qkv.b is not None
                else x.new_zeros(3 * C, dtype=torch.float32))
        scale = (C // self.num_heads) ** -0.5
        if isinstance(qkv, QuantLinear):
            # int8 serving weights (ops/quantize.py): a8w8 qkv/proj and
            # fc1/fc2 (transformer.py:267-276, 304-312)
            x = fused_attention_residual_int8(
                x.reshape(-1, S, C), self.norm1.scale, self.norm1.bias,
                qkv.w_q, qkv.w_scale, bqkv, proj.w_q, proj.w_scale, proj.b,
                self.num_heads, S, scale, self.ln_eps)
            x = fused_mlp_residual_int8(
                x, self.norm2.scale, self.norm2.bias, fc1.w_q, fc1.w_scale,
                fc1.b, fc2.w_q, fc2.w_scale, fc2.b, self.ln_eps)
            return x.reshape(*lead, S, C)
        x = attention_residual(
            x.reshape(-1, S, C), self.norm1.scale, self.norm1.bias,
            qkv.w.to(dt), bqkv, proj.w.to(dt), proj.b, self.num_heads, S,
            scale, self.ln_eps)
        x = mlp_residual(
            x, self.norm2.scale, self.norm2.bias, fc1.w.to(dt), fc1.b,
            fc2.w.to(dt), fc2.b, self.ln_eps)
        return x.reshape(*lead, S, C)


class PatchBlock(nn.Module):
    """Bare attention, no residual and no MLP (scale_attention.py:214-236)."""

    def __init__(self, dim, num_heads, qkv_bias=True, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn = Attention(dim, num_heads, qkv_bias, generator)

    def forward(self, x):
        return multihead_attention(self.attn, x, self.num_heads)


class MultiscaleFormer(nn.Module):
    """`depth` ScaleBlocks over [B, 49, S, C], then `depth` chained
    PatchBlocks over [B, 50, C]; the head on the un-normalised CLS (Q7).
    patch_attn=False classifies from the mean of the per-region scale
    tokens instead (the JAX package's extension)."""

    def __init__(self, depth=12, scales=2, num_heads=12, embed_dim=768,
                 mlp_ratio=4.0, qkv_bias=True, num_classes=100,
                 num_patches=49, patch_attn=True, ln_eps=1e-6,
                 apply_fc_norm=False, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.patch_attn = patch_attn
        self.ln_eps = ln_eps
        self.apply_fc_norm = apply_fc_norm
        self.fea_dim = num_scale_tokens(scales)
        g = generator
        self.scale_blocks = nn.ModuleList(
            ScaleBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, ln_eps, g)
            for _ in range(depth))
        self.patch_blocks = nn.ModuleList(
            PatchBlock(embed_dim, num_heads, qkv_bias, g)
            for _ in range(depth))
        # trunc_normal / normal std 0.036 (scale_attention.py:324-326)
        self.pos_embed_for_scale = nn.Parameter(init.trunc_normal(
            (1, 1, self.fea_dim, embed_dim), 0.036, g))
        self.pos_embed = nn.Parameter(init.trunc_normal(
            (1, num_patches + 1, embed_dim), 0.036, g))
        self.cls_token = nn.Parameter(init.normal((1, 1, embed_dim), 0.036, g))
        # fc_norm + head keep torch defaults (scale_attention.py:318-320)
        self.fc_norm = ops.LayerNorm(embed_dim, ln_eps)
        self.head = ops.Linear(embed_dim, num_classes, True, "torch", g)

    def scale_stack(self, x):
        """[B, 49, S, C] (scale token prepended) -> after the ScaleBlocks."""
        x = x + self.pos_embed_for_scale.to(x.dtype)
        for blk in self.scale_blocks:
            x = blk(x)
        return x

    def cls_embedding(self, x):
        """Scale-stack output [B, 49, S, C] -> the CLS the head reads
        [B, C]: CLS + region tokens + pos_embed through the PatchBlocks."""
        if not self.patch_attn:
            return x[:, :, 0, :].float().mean(1).to(x.dtype)
        B = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        tokens = torch.cat([cls, x[:, :, 0, :]], dim=1)          # [B, 50, C]
        tokens = tokens + self.pos_embed.to(x.dtype)
        for blk in self.patch_blocks:
            tokens = blk(tokens)
        cls = tokens[:, 0, :]
        return self.fc_norm(cls) if self.apply_fc_norm else cls

    def forward(self, x, with_embedding=False):
        """x: [B, 49, S, C] -> logits [B, num_classes]; with_embedding=True
        -> (logits, cls [B, C]), the raw CLS the head reads."""
        cls = self.cls_embedding(self.scale_stack(x))
        logits = self.head(cls)
        return (logits, cls) if with_embedding else logits
