"""The Vision Transformer of the baselines (counterpart of
duoformer_tcga_tpu/models/vit.py: VisionTransformer).

Conv patch embed, CLS token, learned position embedding, `depth` pre-norm
blocks, final LayerNorm, linear head on the CLS. As in the JAX package the
blocks are DuoFormer's ScaleBlock over [B, N, C] (one segment of N = 197
tokens a tile at 224^2 and patch 16), so every block runs the fused
attention and MLP kernels through their autograd functions: at 87..197
tokens the attention branch's long-segment chain (ops/fused_attention.py).
The patch embed is a 16x16 stride-16 VALID convolution through
ops/nn.conv2d (cuDNN, as the JAX package leaves it to XLA; the hybrids of
models/resnetv2.py build the ViT on their trunk's grid with a 1x1 one and
hand it the trunk's map through `tokens`); at C = 384 (ViT-S, 50 tokens)
the blocks run the seg_len <= 64 kernels at that width; the final
norm is the plain LayerNorm, or with fused_ln the LayerNorm kernel (the
JAX package's DUOFORMER_FUSED_LN=1).

Parameters are drawn from a torch.Generator with the JAX package's schemes
(vit.py:49-68): the conv with torch's Conv2d default, the CLS token normal
1e-6, the position embedding trunc_normal 0.02, the blocks and the head
timm's ViT init (trunc_normal 0.02, zero biases), the norms ones and
zeros. Weights and embeddings are cast to the activations' dtype where
they are used, vectors stay float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import initializers as init
from ..ops import nn as ops
from .transformer import ScaleBlock


class VisionTransformer(nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                 num_classes=1000, qkv_bias=True, init_values=None,
                 drop_rate=0.0, attn_drop_rate=0.0, ln_eps=1e-6,
                 fused_ln=False, generator=None):
        """The JAX constructor's arguments, and fused_ln (the final norm
        through the LayerNorm kernel). LayerScale and dropout (no
        baseline uses them) raise NotImplementedError: at 197 tokens they
        need the reg forms past 86 tokens, which are not ported."""
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch_size {patch_size}")
        if init_values is not None or drop_rate or attn_drop_rate:
            raise NotImplementedError(
                "LayerScale and dropout in the VisionTransformer are not "
                "ported to the PyTorch package yet")
        self.patch_size = patch_size
        self.num_patches = (img_size // patch_size) ** 2
        self.embed_dim = embed_dim
        g = generator
        self.patch_embed = ops.Conv2d(patch_size, patch_size, in_chans,
                                      embed_dim, True, "torch", g)
        self.cls_token = nn.Parameter(init.normal((1, 1, embed_dim), 1e-6, g))
        self.pos_embed = nn.Parameter(init.trunc_normal(
            (1, self.num_patches + 1, embed_dim), 0.02, g))
        self.blocks = nn.ModuleList(
            ScaleBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, ln_eps, g)
            for _ in range(depth))
        self.norm = ops.LayerNorm(embed_dim, ln_eps, fused=fused_ln)
        self.head = ops.Linear(embed_dim, num_classes, True, "vit", g)

    def embed(self, x):
        """Patch embed + CLS + position embedding: x [B, H, W, 3] NHWC ->
        tokens [B, num_patches + 1, C] (vit.py:70-78)."""
        return self.tokens(self.patch_embed(
            x.permute(0, 3, 1, 2), stride=self.patch_size, padding="VALID"))

    def tokens(self, y):
        """The patch embed's map y [B, C, g, g] -> tokens [B, g*g + 1, C]:
        CLS first, then the position embedding (also the hybrid's,
        resnetv2.py:146-156)."""
        B = y.shape[0]
        y = y.flatten(2).transpose(1, 2)                     # [B, g*g, C]
        cls = self.cls_token.to(y.dtype).expand(B, 1, self.embed_dim)
        return torch.cat([cls, y], dim=1) + self.pos_embed.to(y.dtype)

    def forward_tokens(self, tokens):
        """The blocks and the final norm on tokens [B, N, C] (vit.py:
        80-88)."""
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)

    def forward_head(self, tokens):
        return self.head(tokens[:, 0, :])

    def forward(self, x, with_embedding=False, seeds=None):
        """x [B, H, W, 3] NHWC -> logits [B, num_classes]; with_embedding
        -> (logits, the post-norm CLS the head reads [B, C]). seeds: the
        model has no dropout, so there is nothing to seed (None only)."""
        if seeds:
            raise ValueError("the VisionTransformer has no dropout to seed")
        tokens = self.forward_tokens(self.embed(x))
        logits = self.forward_head(tokens)
        return (logits, tokens[:, 0, :]) if with_embedding else logits
