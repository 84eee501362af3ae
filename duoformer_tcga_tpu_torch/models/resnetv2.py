"""The ResNetV2 hybrid trunk and the hybrid ViT (counterpart of
duoformer_tcga_tpu/models/resnetv2.py: ResNetV2Trunk, HybridViT).

The stems of timm's R50/R26-ViT hybrids that ViTBase16 wraps
("ViTPretrained"/"R50ViTPretrained": vit_base_r50_s16_224, "R50ViT":
vit_small_r26_s32_224): weight-standardised convolutions (StdConv2dSame,
eps 1e-8) with TF "SAME" padding, GroupNorm(32) + ReLU, post-activation
bottlenecks (stride on conv2), stage widths 256 * 2^i:

  * R50-s16: layers (3, 4, 9)    -> 14x14 x 1024 at 224^2
  * R26-s32: layers (2, 2, 2, 2) ->  7x7  x 2048

The trunk runs NCHW through ops/nn.conv2d (cuDNN, as the JAX package
leaves it to XLA) and GroupNorm in float32 statistics; neither has a
Pallas kernel. Module names follow the JAX tree (stem/{conv, norm},
stages/[s]/blocks/[b]/{conv1..3, norm1..3, downsample/{conv, norm}}), so
utils/convert.py maps one onto the other by name. The hybrid's tokens go
through the VisionTransformer's blocks (models/vit.py), whose fused
kernels run at the ViT's width (384 for R26-S/32, 768 for R50-S/16).

Parameters are drawn from a torch.Generator with the JAX package's schemes:
the trunk's convs kaiming normal fan_out, GroupNorm ones and zeros, the
1x1 patch embed torch's Conv2d default, the ViT as models/vit.py.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn as ops
from .vit import VisionTransformer

GN_GROUPS = 32
STAGE_WIDTHS = (256, 512, 1024, 2048)


def _conv(kh, kw, cin, cout, generator):
    return ops.StdConv2d(kh, kw, cin, cout, generator=generator)


class Downsample(nn.Module):
    def __init__(self, cin, cout, generator):
        super().__init__()
        self.conv = _conv(1, 1, cin, cout, generator)
        self.norm = ops.GroupNorm(cout, GN_GROUPS)


class BottleneckV2(nn.Module):
    """timm resnetv2.Bottleneck with preact=False (resnetv2.py:38-66):
    conv-GN-ReLU twice, conv-GN, the shortcut's conv-GN, ReLU after the
    add; the stride on conv2 and on the shortcut's 1x1 conv."""

    def __init__(self, cin, mid, cout, stride, generator):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(1, 1, cin, mid, generator)
        self.norm1 = ops.GroupNorm(mid, GN_GROUPS)
        self.conv2 = _conv(3, 3, mid, mid, generator)
        self.norm2 = ops.GroupNorm(mid, GN_GROUPS)
        self.conv3 = _conv(1, 1, mid, cout, generator)
        self.norm3 = ops.GroupNorm(cout, GN_GROUPS)
        self.downsample = (Downsample(cin, cout, generator)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample.norm(
                self.downsample.conv(x, self.stride, "SAME"))
        y = ops.relu(self.norm1(self.conv1(x, 1, "SAME")))
        y = ops.relu(self.norm2(self.conv2(y, self.stride, "SAME")))
        y = self.norm3(self.conv3(y, 1, "SAME"))
        return ops.relu(y + shortcut)


class Stem(nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.conv = _conv(7, 7, 3, 64, generator)
        self.norm = ops.GroupNorm(64, GN_GROUPS)


class Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class ResNetV2Trunk(nn.Module):
    """BiT-style trunk returning its last feature map (resnetv2.py:69-112):
    x [B, 3, H, W] NCHW -> [B, out_channels, H / s, W / s], s = 4 * 2^(
    len(layers) - 1)."""

    def __init__(self, layers=(3, 4, 9), generator=None):
        super().__init__()
        self.layers = tuple(layers)
        self.stem = Stem(generator)
        stages, cin = [], 64
        for si, (n, cout) in enumerate(zip(self.layers, STAGE_WIDTHS)):
            blocks = []
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(BottleneckV2(cin, cout // 4, cout, stride,
                                           generator))
                cin = cout
            stages.append(Stage(blocks))
        self.stages = nn.ModuleList(stages)
        self.out_channels = cin

    def forward(self, x):
        y = ops.relu(self.stem.norm(self.stem.conv(x, 2, "SAME")))
        y = ops.maxpool2d(y, 3, 2, "SAME")
        for stage in self.stages:
            for blk in stage.blocks:
                y = blk(y)
        return y


class HybridViT(nn.Module):
    """ResNetV2 trunk -> 1x1 patch embed -> CLS + position embedding ->
    the ViT's blocks, final norm and head (resnetv2.py:115-157; timm's
    HybridEmbed). The ViT is built on the trunk's grid with a 1x1 patch
    embed from its channels, so its parameters sit where the JAX tree has
    them: {"backbone": trunk, "vit": {patch_embed, cls_token, pos_embed,
    blocks, norm, head}}."""

    def __init__(self, layers=(3, 4, 9), embed_dim=768, depth=12,
                 num_heads=12, num_classes=100, img_size=224, fused_ln=False,
                 generator=None):
        super().__init__()
        g = generator
        self.backbone = ResNetV2Trunk(layers, g)
        self.grid = img_size // (4 * 2 ** (len(layers) - 1))
        self.vit = VisionTransformer(
            img_size=self.grid, patch_size=1,
            in_chans=self.backbone.out_channels, embed_dim=embed_dim,
            depth=depth, num_heads=num_heads, num_classes=num_classes,
            fused_ln=fused_ln, generator=g)

    def embed(self, x):
        """x [B, H, W, 3] NHWC -> tokens [B, grid^2 + 1, C]."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return self.vit.tokens(self.vit.patch_embed(feats, 1, "VALID"))

    def forward(self, x, with_embedding=False, seeds=None):
        """x [B, H, W, 3] NHWC -> logits [B, num_classes]; with_embedding
        -> (logits, the post-norm CLS the head reads [B, C])."""
        if seeds:
            raise ValueError("the hybrid ViT has no dropout to seed")
        tokens = self.vit.forward_tokens(self.embed(x))
        logits = self.vit.forward_head(tokens)
        return (logits, tokens[:, 0, :]) if with_embedding else logits
