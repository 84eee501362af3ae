"""DuoFormer assembly (counterpart of duoformer_tcga_tpu/models/
duoformer.py: DuoFormer, fold_for_inference, count_parameters).

The release variant with the learned ("random") scale token:
  backbone -> {56^2x256, 28^2x512, 14^2x1024, 7^2x2048}
  projection of stages 3, 2 -> {7^2xC, 14^2xC}
  regroup -> [B, 49, 5, C]; + scale token -> [B, 49, 6, C]
  transformer -> logits [B, num_classes]
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import initializers as init
from ..ops.quantize import is_quantized
from . import regroup
from .projection import Projection
from .resnet import ResNetBackbone, fold_bn
from .transformer import MultiscaleFormer


class DuoFormer(nn.Module):
    """Release-variant DuoFormer (MyModel_no_extra_params twin). What the
    slice does not cover raises NotImplementedError: the channel scale
    token, q/k norms (attn_drop_rate > 0, quirk Q9), LayerScale, r18,
    scale counts other than 2, and training with an unfrozen backbone
    (batch-stat BN) or with dropout.

    freeze_backbone (every release preset) is the JAX package's frozen
    pyramid (duoformer.py:83-99): the backbone's parameters do not require
    grad, its BNs stay on running statistics in training mode, and its
    pyramid carries no gradient."""

    def __init__(self, depth=12, embed_dim=768, num_heads=12, num_classes=2,
                 num_layers=2, num_patches=49, mlp_ratio=4.0,
                 attn_drop_rate=0.0, proj_drop_rate=0.0, proj_dim=768,
                 freeze_backbone=True, backbone="r50", scale_token="random",
                 patch_attn=True, init_values=None, apply_fc_norm=False,
                 generator=None):
        super().__init__()
        if scale_token not in ("random", "channel"):
            raise ValueError(f"scale_token must be 'random' or 'channel', "
                             f"got {scale_token}")
        unported = [
            (scale_token == "channel", "the channel scale token"),
            (attn_drop_rate > 0.0, "attn_drop_rate > 0 (q/k norms, Q9)"),
            (init_values is not None, "LayerScale (init_values)"),
            (backbone not in ("r50", "r50_Swav"), f"backbone {backbone!r}"),
            (num_layers != 2, f"num_layers={num_layers} (only 2 scales)"),
        ]
        for hit, what in unported:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported to the PyTorch package yet")
        # the architecture fields a serving artifact's meta["model"]
        # records and from_serving_artifact checks (cli.py:664-672)
        self.config = dict(
            family="duoformer", depth=depth, embed_dim=embed_dim,
            proj_dim=proj_dim, num_heads=num_heads, num_classes=num_classes,
            num_layers=num_layers, num_patches=num_patches,
            mlp_ratio=mlp_ratio, scale_token=scale_token, backbone=backbone,
            patch_attn=patch_attn, init_values=init_values,
            apply_fc_norm=apply_fc_norm)
        self.num_layers = num_layers
        self.proj_dim = proj_dim
        self.freeze_backbone = freeze_backbone
        self.proj_drop_rate = proj_drop_rate
        self.backbone = ResNetBackbone(50, generator)
        if freeze_backbone:
            self.backbone.requires_grad_(False)
        self.projection = Projection(num_layers, proj_dim, backbone, generator)
        self.transformer = MultiscaleFormer(
            depth=depth, scales=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, mlp_ratio=mlp_ratio, qkv_bias=True,
            num_classes=num_classes, num_patches=num_patches,
            patch_attn=patch_attn, apply_fc_norm=apply_fc_norm,
            generator=generator)
        # learned (1,1,1,proj_dim) token, normal std 0.036
        # (model_wo_extra_params.py:77-79)
        self.scale_token = nn.Parameter(
            init.normal((1, 1, 1, proj_dim), 0.036, generator))

    def train(self, mode: bool = True):
        if mode and is_quantized(self):
            raise RuntimeError("an int8-quantized model serves only: the "
                               "int8 kernels have no backward")
        super().train(mode)
        if self.freeze_backbone:
            self.backbone.eval()      # BN on running statistics
        return self

    def features(self, x):
        """x: [B, 224, 224, 3] NHWC -> backbone pyramid {stage: NCHW};
        with a frozen backbone it carries no gradient (stop_gradient)."""
        if self.freeze_backbone:
            with torch.no_grad():
                return self.backbone(x.permute(0, 3, 1, 2))
        return self.backbone(x.permute(0, 3, 1, 2))

    def tokens(self, feats):
        """Pyramid -> [B, 49, S+1, proj_dim] transformer input."""
        stages = regroup.stages_for(self.num_layers)
        proj = self.projection({s: feats[s] for s in self.projection.stages})
        tokens = regroup.regroup(
            {s: f.permute(0, 2, 3, 1) for s, f in proj.items()}, stages)
        B = tokens.shape[0]
        token = self.scale_token.expand(B, 49, 1, self.proj_dim)
        return torch.cat([token.to(tokens.dtype), tokens], dim=2)

    def forward(self, x, with_embedding=False):
        """x: [B, 224, 224, 3] NHWC -> logits [B, num_classes];
        with_embedding=True -> (logits, pre-head CLS [B, embed_dim])."""
        if self.training and (not self.freeze_backbone
                              or self.proj_drop_rate > 0.0):
            raise NotImplementedError(
                "training with an unfrozen backbone (batch-stat BN) or with "
                "dropout is not ported to the PyTorch package yet")
        return self.transformer(self.tokens(self.features(x)),
                                with_embedding=with_embedding)


def fold_for_inference(model: DuoFormer) -> DuoFormer:
    """Fold every backbone BatchNorm into its affine, in place (exact under
    eval-mode BN, the only mode the release configs serve)."""
    fold_bn(model.backbone)
    return model


def count_parameters(model: nn.Module):
    """(trainable_M, total_M): parameters that require grad, and every
    tensor of the state dict (the JAX count of param-tree leaves, BN
    running stats included)."""
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    total = sum(t.numel() for t in model.state_dict().values())
    return trainable / 1e6, total / 1e6
