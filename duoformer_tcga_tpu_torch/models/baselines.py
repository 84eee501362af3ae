"""The paper's baselines (counterpart of duoformer_tcga_tpu/models/
baselines.py): so far ViTBase16's plain ViT-B/16 ("ViT"), the
`vit-baseline` preset (config.py:189, ViTBase16(n_classes=100)).

ViTBase16's other model types, the ResNetV2 hybrids ("ViTPretrained",
"R50ViTPretrained", "R50ViT"), and HybridModel need models/resnetv2.py
and the r18 trunk, which are not ported yet.
"""

from __future__ import annotations

from torch import nn

from .vit import VisionTransformer

_HYBRID_TYPES = ("ViTPretrained", "R50ViTPretrained", "R50ViT")


class ViTBase16(nn.Module):
    """The ViT baseline wrapper (baselines.py:77-117; reference model.py:
    415-446): model_type "ViT" is ViT-B/16 from scratch at 224^2 (768
    wide, 12 heads of 64, depth 12, 197 tokens). Its parameters sit under
    `model`, the JAX tree's {"model": ...}. fused_ln: the final norm
    through the LayerNorm kernel."""

    def __init__(self, n_classes=100, model_type="ViT", fused_ln=False,
                 generator=None):
        super().__init__()
        if model_type in _HYBRID_TYPES:
            raise NotImplementedError(
                f"ViTBase16 model_type {model_type!r} needs the ResNetV2 "
                f"hybrid stem (models/resnetv2.py), which is not ported to "
                f"the PyTorch package yet")
        if model_type != "ViT":
            raise ValueError(f"unknown ViTBase16 model_type: {model_type}")
        self.model = VisionTransformer(patch_size=16, depth=12,
                                       embed_dim=768, num_heads=12,
                                       num_classes=n_classes,
                                       fused_ln=fused_ln, generator=generator)

    def forward(self, x, with_embedding=False, seeds=None):
        """x [B, 224, 224, 3] NHWC -> logits [B, n_classes] (with_embedding:
        and the post-norm CLS)."""
        return self.model(x, with_embedding, seeds)
