"""The paper's baselines (counterpart of duoformer_tcga_tpu/models/
baselines.py): ViTBase16 in its four model types, the plain ViT-B/16
("ViT", the `vit-baseline` preset, config.py:189) and the ResNetV2
hybrids ("ViTPretrained" / "R50ViTPretrained": R50-S/16 + ViT-B, 197
tokens; "R50ViT": R26-S/32 + ViT-S, 384 wide, 6 heads, 50 tokens), built
from scratch (timm-layout weights load through utils/timm_convert.py).

HybridModel, with its r18 trunk, is not ported yet.
"""

from __future__ import annotations

from torch import nn

from .resnetv2 import HybridViT
from .vit import VisionTransformer

# model type -> the hybrid's (trunk layers, embed_dim, num_heads)
HYBRID_TYPES = {"ViTPretrained": ((3, 4, 9), 768, 12),
                "R50ViTPretrained": ((3, 4, 9), 768, 12),
                "R50ViT": ((2, 2, 2, 2), 384, 6)}


class ViTBase16(nn.Module):
    """The ViT baseline wrapper (baselines.py:77-117; reference model.py:
    415-446): model_type "ViT" is ViT-B/16 from scratch at 224^2 (768
    wide, 12 heads of 64, depth 12, 197 tokens); the hybrid types are a
    HybridViT of depth 12 at 224^2. Its parameters sit under `model`, the
    JAX tree's {"model": ...}. fused_ln: the final norm through the
    LayerNorm kernel."""

    def __init__(self, n_classes=100, model_type="ViT", fused_ln=False,
                 generator=None):
        super().__init__()
        self.model_type = model_type
        if model_type in HYBRID_TYPES:
            layers, dim, heads = HYBRID_TYPES[model_type]
            self.model = HybridViT(layers=layers, embed_dim=dim, depth=12,
                                   num_heads=heads, num_classes=n_classes,
                                   fused_ln=fused_ln, generator=generator)
        elif model_type == "ViT":
            self.model = VisionTransformer(
                patch_size=16, depth=12, embed_dim=768, num_heads=12,
                num_classes=n_classes, fused_ln=fused_ln,
                generator=generator)
        else:
            raise ValueError(f"unknown ViTBase16 model_type: {model_type}")

    def forward(self, x, with_embedding=False, seeds=None):
        """x [B, 224, 224, 3] NHWC -> logits [B, n_classes] (with_embedding:
        and the post-norm CLS)."""
        return self.model(x, with_embedding, seeds)
