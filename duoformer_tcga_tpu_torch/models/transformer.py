"""The DuoFormer transformer cores (counterpart of
duoformer_tcga_tpu/models/transformer.py: num_scale_tokens, ScaleBlock,
PatchBlock, MultiscaleFormer, MultiscaleBlock, MultiscaleTransformer;
transformer.py:58-72, 192-381, 430-594, 668-797).

The JAX package stacks each depth's params and runs them with lax.scan;
here each stack is a ModuleList of `depth` blocks run in a Python loop.
Every ScaleBlock runs the two fused kernels (attention branch, then MLP
branch); every PatchBlock runs the bare form of the attention kernel. Both
go through the kernels' autograd functions, so the same forward trains.
At 4 scales (S = 86 tokens a region) the attention branch runs its
86-token kernels, inert, reg or int8, and its backward (both forms, inert
or reg).
A block with LayerScale (ls1, ls2) or an active dropout runs the reg forms
instead (ops/fused_reg.py, transformer.py:277-327), as every block of the
legacy family does. A release model with attn_drop_rate > 0 (quirk Q9)
creates q/k norms in every ScaleBlock and PatchBlock: the ScaleBlocks
carry them unapplied and stay on the kernels; the PatchBlocks apply them
and leave the kernels for the JAX package's XLA route in plain PyTorch
(ops/attention.qk_norm_attention, transformer.py:342-352). A model
quantized by ops/quantize.quantize_model_ (QuantLinear qkv, proj, fc1,
fc2) runs the int8 forms of both kernels instead, serving only.

Dropout seeds. A core's forward takes an optional list of int32 seeds, one
per dropout call, in one order: for each scale block i, (attention i,
MLP i); then the release family's patch blocks 0..depth-1, or the legacy
family's region blocks 0 and depth-1 (`num_seeds()` of them). They are
used in training mode only; without them a training forward runs without
dropout, as the JAX package's does without an rng.

Backward routes. Each ScaleBlock carries mlp_save_hidden (True: the MLP
forward saves its pre-GELU hidden; False: it saves x and the backward
recomputes from it) and attn_bwd_dw (True: the attention backward kernel
forms the weight gradients itself), each PatchBlock attn_bwd_dw; the legacy
region pass takes its block's. They are the JAX package's
DUOFORMER_MLP_SAVE_HIDDEN and DUOFORMER_BWD_DW, as plain attributes that
train.make_train_step sets; their defaults are the JAX package's. fused_ln
(DUOFORMER_FUSED_LN) runs the LayerNorm outside the fused blocks, fc_norm
and norm, through the LayerNorm kernel.

Every weight and embedding is cast to the activations' dtype where it is
used, as the JAX package's `.astype(x.dtype)`: float32 master parameters
train through bf16 kernels; vectors (norms, biases) stay float32.

Reference quirks kept:
  * Q7: the head reads the raw CLS; fc_norm exists (and loads from
    checkpoints) but is applied only with apply_fc_norm=True.
  * Scale = head_dim ** -0.5 in both stacks (the release family).
  * Q6 (fixed in the JAX package too): num_scale_tokens counts 1 + 4^i.
  * Q9: the release family's dropout rates are shifted (attention
    probabilities and MLP at proj_drop_rate, attention proj at 0), and
    attn_drop_rate > 0 only creates q/k norms (applied by the PatchBlocks
    alone); the legacy blocks' attn2 carries q/k norms that no forward
    applies.
  * Q4, Q12, Q13 (legacy): the region pass runs block 0, then block
    depth-1 on block 0's output; both passes scale by 2 * dim ** -0.5;
    the logits are squeezed.
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
from ..ops.fused_reg import attention_residual_reg, mlp_residual_reg
from ..ops.quantize import QuantLinear


def num_scale_tokens(scales: int) -> int:
    """1 scale/cls token + 4^0 + ... + 4^(scales-1): {1:2, 2:6, 3:22, 4:86}."""
    return 1 + sum(4 ** i for i in range(scales))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, generator=None):
        super().__init__()
        self.fc1 = ops.Linear(dim, hidden, True, "vit", generator)
        self.fc2 = ops.Linear(hidden, dim, True, "vit", generator)


class LayerScale(nn.Module):
    def __init__(self, dim, init_values):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))


class ScaleBlock(nn.Module):
    """Pre-norm attention + MLP over [..., S, C] (scale_attention.py:48-93,
    transformer.py:192-337), each branch one fused kernel. init_values:
    LayerScale ls1, ls2; attn_drop, proj_drop, mlp_drop: the dropout
    rates of the attention probabilities, the attention proj output and
    the MLP (its hidden and output); scale: the attention scale (None:
    head_dim ** -0.5); qk_norm: q/k norms carried unapplied (the release
    family's Q9, scale_attention.py:28-45)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 ln_eps=1e-6, generator=None, init_values=None,
                 attn_drop=0.0, proj_drop=0.0, mlp_drop=0.0, scale=None,
                 qk_norm=False):
        super().__init__()
        self.num_heads = num_heads
        self.ln_eps = ln_eps
        self.rates = (attn_drop, proj_drop, mlp_drop)
        self.scale = scale
        self.norm1 = ops.LayerNorm(dim, ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, generator, qk_norm)
        self.norm2 = ops.LayerNorm(dim, ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator)
        self.mlp_save_hidden = True          # backward routes (see module)
        self.attn_bwd_dw = False
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)

    def scale_attention(self) -> Attention:
        return self.attn

    def _gamma(self, name, x):
        """LayerScale `name`'s gamma, or ones where the block has none (the
        reg kernels take a gamma on every call, as the JAX package's)."""
        if hasattr(self, name):
            return getattr(self, name).gamma
        return x.new_ones(x.shape[-1], dtype=torch.float32)

    def forward(self, x, seeds=None):
        """seeds: (attention seed, MLP seed), used in training mode."""
        *lead, S, C = x.shape
        dt = x.dtype
        qkv, proj = self.scale_attention().qkv, self.scale_attention().proj
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        bqkv = (qkv.b if qkv.b is not None
                else x.new_zeros(3 * C, dtype=torch.float32))
        scale = (self.scale if self.scale is not None
                 else (C // self.num_heads) ** -0.5)
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
        live = self.training and seeds is not None
        attn_drop, proj_drop, mlp_drop = (r if live else 0.0
                                          for r in self.rates)
        seed_a, seed_m = seeds if live else (0, 0)
        args = (x.reshape(-1, S, C), self.norm1.scale, self.norm1.bias,
                qkv.w.to(dt), bqkv, proj.w.to(dt), proj.b)
        if hasattr(self, "ls1") or attn_drop > 0.0 or proj_drop > 0.0:
            x = attention_residual_reg(
                *args, self._gamma("ls1", x), seed_a, self.num_heads, S,
                scale, self.ln_eps, attn_drop=attn_drop, proj_drop=proj_drop,
                bwd_dw=self.attn_bwd_dw)
        else:
            x = attention_residual(*args, self.num_heads, S, scale,
                                   self.ln_eps, bwd_dw=self.attn_bwd_dw)
        margs = (x, self.norm2.scale, self.norm2.bias, fc1.w.to(dt), fc1.b,
                 fc2.w.to(dt), fc2.b)
        if hasattr(self, "ls2") or mlp_drop > 0.0:
            x = mlp_residual_reg(*margs, self._gamma("ls2", x), seed_m,
                                 self.ln_eps, drop=mlp_drop,
                                 save_hidden=self.mlp_save_hidden)
        else:
            x = mlp_residual(*margs, self.ln_eps,
                             save_hidden=self.mlp_save_hidden)
        return x.reshape(*lead, S, C)


class PatchBlock(nn.Module):
    """Bare attention, no residual and no MLP (scale_attention.py:214-236);
    attn_drop: the dropout rate of its probabilities; qk_norm: q/k norms,
    applied (AttentionForPatch, scale_attention.py:201)."""

    def __init__(self, dim, num_heads, qkv_bias=True, generator=None,
                 attn_drop=0.0, qk_norm=False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.attn_bwd_dw = False             # backward route (see module)
        self.attn = Attention(dim, num_heads, qkv_bias, generator, qk_norm)

    def forward(self, x, seed=None):
        return multihead_attention(self.attn, x, self.num_heads,
                                   attn_drop=self.attn_drop,
                                   seed=seed if self.training else None,
                                   bwd_dw=self.attn_bwd_dw)


class MultiscaleFormer(nn.Module):
    """`depth` ScaleBlocks over [B, 49, S, C], then `depth` chained
    PatchBlocks over [B, 50, C]; the head on the un-normalised CLS (Q7).
    patch_attn=False classifies from the mean of the per-region scale
    tokens instead (the JAX package's extension). fused_ln: fc_norm
    through the LayerNorm kernel. attn_drop_rate > 0 creates q/k norms in
    every block (Q9)."""

    def __init__(self, depth=12, scales=2, num_heads=12, embed_dim=768,
                 mlp_ratio=4.0, qkv_bias=True, num_classes=100,
                 num_patches=49, patch_attn=True, ln_eps=1e-6,
                 apply_fc_norm=False, proj_drop_rate=0.0, init_values=None,
                 fused_ln=False, generator=None, attn_drop_rate=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.patch_attn = patch_attn
        self.ln_eps = ln_eps
        self.apply_fc_norm = apply_fc_norm
        self.fea_dim = num_scale_tokens(scales)
        self.has_dropout = proj_drop_rate > 0.0
        # Q9 creation rule (transformer.py:462-464)
        self.qk_norm = attn_drop_rate > 0.0
        g = generator
        # Q9 effective rates (transformer.py:529-536, 574-583)
        self.scale_blocks = nn.ModuleList(
            ScaleBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, ln_eps, g,
                       init_values, attn_drop=proj_drop_rate,
                       mlp_drop=proj_drop_rate, qk_norm=self.qk_norm)
            for _ in range(depth))
        self.patch_blocks = nn.ModuleList(
            PatchBlock(embed_dim, num_heads, qkv_bias, g,
                       attn_drop=proj_drop_rate, qk_norm=self.qk_norm)
            for _ in range(depth))
        # trunc_normal / normal std 0.036 (scale_attention.py:324-326)
        self.pos_embed_for_scale = nn.Parameter(init.trunc_normal(
            (1, 1, self.fea_dim, embed_dim), 0.036, g))
        self.pos_embed = nn.Parameter(init.trunc_normal(
            (1, num_patches + 1, embed_dim), 0.036, g))
        self.cls_token = nn.Parameter(init.normal((1, 1, embed_dim), 0.036, g))
        # fc_norm + head keep torch defaults (scale_attention.py:318-320)
        self.fc_norm = ops.LayerNorm(embed_dim, ln_eps, fused=fused_ln)
        self.head = ops.Linear(embed_dim, num_classes, True, "torch", g)

    def num_seeds(self) -> int:
        return len(self.scale_blocks) * 2 + (
            len(self.patch_blocks) if self.patch_attn else 0)

    def scale_stack(self, x, seeds=None):
        """[B, 49, S, C] (scale token prepended) -> after the ScaleBlocks."""
        x = x + self.pos_embed_for_scale.to(x.dtype)
        for i, blk in enumerate(self.scale_blocks):
            x = blk(x, None if seeds is None else seeds[2 * i:2 * i + 2])
        return x

    def cls_embedding(self, x, seeds=None):
        """Scale-stack output [B, 49, S, C] -> the CLS the head reads
        [B, C]: CLS + region tokens + pos_embed through the PatchBlocks
        (seeds: the patch blocks' own)."""
        if not self.patch_attn:
            return x[:, :, 0, :].float().mean(1).to(x.dtype)
        B = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        tokens = torch.cat([cls, x[:, :, 0, :]], dim=1)          # [B, 50, C]
        tokens = tokens + self.pos_embed.to(x.dtype)
        for i, blk in enumerate(self.patch_blocks):
            tokens = blk(tokens, None if seeds is None else seeds[i])
        cls = tokens[:, 0, :]
        return self.fc_norm(cls) if self.apply_fc_norm else cls

    def forward(self, x, with_embedding=False, seeds=None):
        """x: [B, 49, S, C] -> logits [B, num_classes]; with_embedding=True
        -> (logits, cls [B, C]), the raw CLS the head reads. seeds: see the
        module's docstring."""
        n = 2 * len(self.scale_blocks)
        cls = self.cls_embedding(
            self.scale_stack(x, None if seeds is None else seeds[:n]),
            None if seeds is None else seeds[n:])
        logits = self.head(cls)
        return (logits, cls) if with_embedding else logits


class MultiscaleBlock(ScaleBlock):
    """The legacy block (multiscale_attn.py:224-259, transformer.py:
    360-381): a ScaleBlock over attn1 (the scale pass) that also owns
    attn2, the inherited set its region pass uses, which carries the Q9
    q/k norms when qk_norm."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True,
                 qk_norm=False, ln_eps=1e-6, generator=None,
                 init_values=None, attn_drop=0.0, proj_drop=0.0,
                 mlp_drop=0.0, scale=None):
        super().__init__(dim, num_heads, mlp_ratio, qkv_bias, ln_eps,
                         generator, init_values, attn_drop, proj_drop,
                         mlp_drop, scale)
        self.attn1 = self.attn
        del self.attn
        self.attn2 = Attention(dim, num_heads, qkv_bias, generator, qk_norm)

    def scale_attention(self) -> Attention:
        return self.attn1


class MultiscaleTransformer(nn.Module):
    """The legacy core (transformer.py:668-797): the scale pass through
    every MultiscaleBlock (attn1, scale 2 * dim ** -0.5, Q12; attention
    dropout attn_drop_rate, proj and MLP dropout drop_rate), then the
    region pass over [B, 50, C] with attn2 (probability dropout drop_rate)
    of block 0 and then of block depth-1 on block 0's output (Q4), the
    final norm on its CLS, the head, and the logits squeezed (Q13).
    fused_ln: the final norm through the LayerNorm kernel."""

    def __init__(self, depth=12, scales=2, num_heads=6, embed_dim=384,
                 mlp_ratio=4.0, qkv_bias=True, qk_norm=None, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.0, init_values=1e-5,
                 num_classes=1000, num_patches=49, ln_eps=1e-6,
                 fused_ln=False, generator=None):
        super().__init__()
        if drop_path_rate:
            raise NotImplementedError(
                "stochastic depth (drop_path_rate > 0) is not ported to the "
                "PyTorch package yet")
        self.depth = depth
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.drop_rate = drop_rate
        self.ln_eps = ln_eps
        self.fea_dim = num_scale_tokens(scales)
        self.has_dropout = drop_rate > 0.0 or attn_drop_rate > 0.0
        # Q12: one scale for both passes; Q9: q/k norms iff attn_drop > 0
        self.attn_scale = 2.0 * embed_dim ** -0.5
        qk_norm = attn_drop_rate > 0.0 if qk_norm is None else qk_norm
        g = generator
        self.blocks = nn.ModuleList(
            MultiscaleBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                            qk_norm, ln_eps, g, init_values,
                            attn_drop=attn_drop_rate, proj_drop=drop_rate,
                            mlp_drop=drop_rate, scale=self.attn_scale)
            for _ in range(depth))
        self.pos_embed_for_scale = nn.Parameter(init.trunc_normal(
            (1, 1, self.fea_dim, embed_dim), 0.036, g))
        # timm VisionTransformer's inherited parameters and init
        self.pos_embed = nn.Parameter(init.trunc_normal(
            (1, num_patches + 1, embed_dim), 0.02, g))
        self.cls_token = nn.Parameter(init.normal((1, 1, embed_dim), 1e-6, g))
        self.norm = ops.LayerNorm(embed_dim, ln_eps, fused=fused_ln)
        self.head = ops.Linear(embed_dim, num_classes, True, "vit", g)

    def num_seeds(self) -> int:
        return 2 * self.depth + 2

    def scale_stack(self, x, seeds=None):
        x = x + self.pos_embed_for_scale.to(x.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if seeds is None else seeds[2 * i:2 * i + 2])
        return x

    def _region(self, blk, tokens, seed):
        """forward_with_region (transformer.py:725-736): attn2, the shared
        scale, probability dropout drop_rate; q/k norms not applied."""
        return multihead_attention(blk.attn2, tokens, self.num_heads,
                                   scale=self.attn_scale,
                                   attn_drop=self.drop_rate,
                                   seed=seed if self.training else None,
                                   bwd_dw=blk.attn_bwd_dw,
                                   apply_qk_norm=False)

    def cls_embedding(self, x, seeds=None):
        """Scale-stack output -> the post-norm CLS the head reads [B, C]
        (seeds: region block 0's, region block depth-1's)."""
        B = x.shape[0]
        r0, rn = (None, None) if seeds is None else seeds
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.embed_dim)
        tokens = torch.cat([cls, x[:, :, 0, :]], dim=1)          # [B, 50, C]
        tokens = tokens + self.pos_embed.to(x.dtype)
        tokens = self._region(self.blocks[0], tokens, r0)
        if self.depth > 1:
            cls = self._region(self.blocks[-1], tokens, rn)[:, 0, :]
        else:
            cls = tokens[:, 0, :]
        return self.norm(cls)

    def forward(self, x, with_embedding=False, seeds=None):
        """x: [B, 49, S, C] -> logits squeezed (Q13: [num_classes] at
        B=1); with_embedding=True -> (logits, cls [B, C]), the post-norm
        CLS (not squeezed)."""
        n = 2 * self.depth
        cls = self.cls_embedding(
            self.scale_stack(x, None if seeds is None else seeds[:n]),
            None if seeds is None else seeds[n:])
        logits = self.head(cls).squeeze()
        return (logits, cls) if with_embedding else logits
