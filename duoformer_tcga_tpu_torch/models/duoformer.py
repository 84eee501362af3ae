"""DuoFormer assembly (counterpart of duoformer_tcga_tpu/models/
duoformer.py: DuoFormer, DuoFormerLegacy, fold_for_inference,
count_parameters).

Both families (2 scales):
  backbone -> {56^2x256, 28^2x512, 14^2x1024, 7^2x2048}
  projection of stages 3, 2 -> {7^2xC, 14^2xC}
  regroup -> [B, 49, 5, C]; + scale token -> [B, 49, 6, C]
  transformer -> logits [B, num_classes]
The release DuoFormer's scale token is learned ("random") or derived from
the pyramid ("channel", ChannelProjectors) and its core the
MultiscaleFormer; the legacy DuoFormerLegacy always derives it and runs
the MultiscaleTransformer core.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import initializers as init
from ..ops.quantize import is_quantized
from . import regroup
from .projection import ChannelProjectors, Projection
from .resnet import ResNetBackbone, fold_bn
from .transformer import MultiscaleFormer, MultiscaleTransformer


class _PyramidModel(nn.Module):
    """What both families share: the frozen ResNet-50 pyramid, the scale
    token (channel_proj, when the model has one), the regroup, and the
    dropout seeds of a training forward.

    freeze_backbone (every preset) is the JAX package's frozen pyramid
    (duoformer.py:83-99, 185-195): the backbone's parameters do not
    require grad, its BNs stay on running statistics in training mode, and
    its pyramid carries no gradient. Training with an unfrozen backbone
    (batch-stat BN in the backbone) raises NotImplementedError."""

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
        if hasattr(self, "channel_proj"):
            token = self.channel_proj(feats)                # [B, 49, 1, C]
        else:
            token = self.scale_token.expand(B, 49, 1, self.proj_dim)
        return torch.cat([token.to(tokens.dtype), tokens], dim=2)

    def forward(self, x, with_embedding=False, seeds=None):
        """x: [B, 224, 224, 3] NHWC -> logits; with_embedding=True ->
        (logits, the embedding the head reads [B, embed_dim]). seeds: the
        int32 dropout seeds of a training forward, in the order of
        models/transformer.py's docstring (transformer.num_seeds() of
        them; train.make_train_step draws them); without them a training
        forward runs without dropout, as the JAX package's without an
        rng."""
        if self.training and not self.freeze_backbone:
            raise NotImplementedError(
                "training with an unfrozen backbone (batch-stat BN) is not "
                "ported to the PyTorch package yet")
        return self.transformer(self.tokens(self.features(x)),
                                with_embedding=with_embedding,
                                seeds=seeds if self.training else None)


def draw_seeds(n, generator=None) -> list:
    """n int32 dropout seeds, drawn on the CPU (the JAX package's
    randint(key, (), -2**31, 2**31 - 1, int32), transformer.py:291)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=generator,
                         dtype=torch.int64).tolist()


class DuoFormer(_PyramidModel):
    """Release-variant DuoFormer (MyModel_no_extra_params twin). What the
    slice does not cover raises NotImplementedError: q/k norms applied in
    the patch blocks (attn_drop_rate > 0, quirk Q9), r18, scale counts
    other than 2, and training with an unfrozen backbone (batch-stat BN).
    proj_drop_rate and init_values train through the reg kernels."""

    def __init__(self, depth=12, embed_dim=768, num_heads=12, num_classes=2,
                 num_layers=2, num_patches=49, mlp_ratio=4.0,
                 attn_drop_rate=0.0, proj_drop_rate=0.0, proj_dim=768,
                 freeze_backbone=True, backbone="r50", scale_token="random",
                 patch_attn=True, init_values=None, apply_fc_norm=False,
                 fused_ln=False, generator=None):
        super().__init__()
        if scale_token not in ("random", "channel"):
            raise ValueError(f"scale_token must be 'random' or 'channel', "
                             f"got {scale_token}")
        unported = [
            (attn_drop_rate > 0.0, "attn_drop_rate > 0 (q/k norms applied "
                                   "by the patch blocks, Q9)"),
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
        self.backbone = ResNetBackbone(50, generator)
        if freeze_backbone:
            self.backbone.requires_grad_(False)
        self.projection = Projection(num_layers, proj_dim, backbone, generator)
        if scale_token == "channel":
            self.channel_proj = ChannelProjectors(backbone, proj_dim,
                                                  generator)
        self.transformer = MultiscaleFormer(
            depth=depth, scales=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, mlp_ratio=mlp_ratio, qkv_bias=True,
            num_classes=num_classes, num_patches=num_patches,
            patch_attn=patch_attn, apply_fc_norm=apply_fc_norm,
            proj_drop_rate=proj_drop_rate, init_values=init_values,
            fused_ln=fused_ln, generator=generator)
        if scale_token == "random":
            # learned (1,1,1,proj_dim) token, normal std 0.036
            # (model_wo_extra_params.py:77-79)
            self.scale_token = nn.Parameter(
                init.normal((1, 1, 1, proj_dim), 0.036, generator))


class DuoFormerLegacy(_PyramidModel):
    """The legacy DuoFormer (MyModel twin, duoformer.py:144-208): the
    channel scale token and the MultiscaleTransformer core, LayerScale
    init_values, attention dropout attn_drop_rate and dropout drop_rate
    (the reference's 1e-5, 0.1, 0.1). Only num_layers=2 runs in the
    reference (Q5), and only it is accepted, as in the JAX package.
    pretrained_backbone is accepted and ignored, as there: weights come
    from a loaded tree. freeze: the frozen backbone. fused_ln: the final
    norm through the LayerNorm kernel."""

    def __init__(self, depth=12, embed_dim=768, num_heads=12, num_classes=2,
                 num_layers=2, num_patches=49, proj_dim=768,
                 init_values=1e-5, freeze=True, attn_drop_rate=0.1,
                 drop_rate=0.1, pretrained_backbone=True, fused_ln=False,
                 generator=None):
        super().__init__()
        if num_layers != 2:
            raise ValueError(
                "DuoFormerLegacy supports num_layers=2 only (reference Q5: "
                "MyModel projects stages {2,3} but 3/4-scale branches index "
                "missing projections, model.py:291,311-321)")
        self.config = dict(
            family="duoformer_legacy", depth=depth, embed_dim=embed_dim,
            proj_dim=proj_dim, num_heads=num_heads, num_classes=num_classes,
            num_layers=num_layers, num_patches=num_patches,
            init_values=init_values, attn_drop_rate=attn_drop_rate,
            drop_rate=drop_rate)
        self.num_layers = num_layers
        self.proj_dim = proj_dim
        self.freeze_backbone = freeze
        self.backbone = ResNetBackbone(50, generator)
        if freeze:
            self.backbone.requires_grad_(False)
        self.projection = Projection(num_layers, proj_dim, "r50", generator)
        self.channel_proj = ChannelProjectors("r50", proj_dim, generator)
        self.transformer = MultiscaleTransformer(
            depth=depth, scales=num_layers, num_heads=num_heads,
            embed_dim=embed_dim, qkv_bias=True, drop_rate=drop_rate,
            attn_drop_rate=attn_drop_rate, init_values=init_values,
            num_classes=num_classes, num_patches=num_patches,
            fused_ln=fused_ln, generator=generator)


def fold_for_inference(model: nn.Module) -> nn.Module:
    """Fold every backbone and channel-fuser BatchNorm into its affine, in
    place (exact under eval-mode BN, the only mode the presets serve)."""
    fold_bn(model.backbone)
    if hasattr(model, "channel_proj"):
        fold_bn(model.channel_proj)
    return model


def count_parameters(model: nn.Module):
    """(trainable_M, total_M): parameters that require grad, and every
    tensor of the state dict (the JAX count of param-tree leaves, BN
    running stats included)."""
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    total = sum(t.numel() for t in model.state_dict().values())
    return trainable / 1e6, total / 1e6
