"""Projection heads and the channel scale token (counterpart of
duoformer_tcga_tpu/models/projection.py: Projection, ChannelProjectors).

  * Projection: per-stage 1x1 convs to proj_dim; kaiming-normal weights,
    bias normal(1e-6), as the reference's projection head.
  * ChannelProjectors: every pyramid stage down to 7x7, the channels
    concatenated (r50: 256+512+1024+2048 = 3840) and fused by 4
    conv-BN-ReLU layers to proj_dim: one derived "channel" scale token per
    region (projection.py:65-132).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn as ops

STAGE_CHANNELS = {"r50": {"0": 256, "1": 512, "2": 1024, "3": 2048}}
# stages projected per num_layers (projection_head.py:14-110), r50 only
PROJ_STAGES = {"r50": {1: ["3"], 2: ["3", "2"], 3: ["3", "2", "1"],
                       4: ["3", "2", "1", "0"]}}


class Projection(nn.ModuleDict):
    """ModuleDict {stage: 1x1 Conv2d}; forward({stage: NCHW}) ->
    {stage: [B, proj_dim, H, W]} for the projected stages."""

    def __init__(self, num_layers=2, proj_dim=768, backbone="r50",
                 generator=None):
        base = "r50" if backbone == "r50_Swav" else backbone
        if base not in PROJ_STAGES:
            raise NotImplementedError(
                f"backbone {backbone!r}: only r50 is ported")
        stages = PROJ_STAGES[base][num_layers]
        chans = STAGE_CHANNELS[base]
        super().__init__({
            s: ops.Conv2d(1, 1, chans[s], proj_dim, bias=True,
                          scheme="kaiming", generator=generator)
            for s in stages})
        self.stages = stages

    def forward(self, features: dict) -> dict:
        return {s: conv(features[s], 1, "VALID") for s, conv in self.items()}


class FuseLayer(nn.Module):
    """One ConvBatchNorm of the channel fuser: 3x3 conv (torch default
    init), BN, then ReLU in the caller."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.conv = ops.Conv2d(3, 3, cin, cout, bias=True, scheme="torch",
                               generator=generator)
        self.bn = ops.BatchNorm(cout)


class ChannelProjectors(nn.Module):
    """forward({stage: NCHW}) -> the channel token [B, 49, 1, proj_dim]:
    stage 0 through two stride-2 3x3 convs and a 2x2 max-pool (56 -> 7),
    stage 1 through one and a max-pool (28 -> 7), stage 2 through a
    max-pool (14 -> 7), stage 3 as it is; concatenated over channels in
    stage order and fused. In training mode the fusers' BNs use batch
    statistics (DuoFormer.apply, projection.py:121-123)."""

    def __init__(self, backbone="r50", proj_dim=768, generator=None):
        super().__init__()
        base = "r50" if backbone == "r50_Swav" else backbone
        if base not in STAGE_CHANNELS:
            raise NotImplementedError(
                f"backbone {backbone!r}: only r50 is ported")
        ch = STAGE_CHANNELS[base]
        self.proj_dim = proj_dim
        g = generator
        self.l1_conv1 = ops.Conv2d(3, 3, ch["0"], ch["0"], True, "kaiming", g)
        self.l1_conv2 = ops.Conv2d(3, 3, ch["0"], ch["0"], True, "kaiming", g)
        self.l2_conv1 = ops.Conv2d(3, 3, ch["1"], ch["1"], True, "kaiming", g)
        widths = [sum(ch.values())] + [proj_dim] * 4
        self.fuse = nn.ModuleList(FuseLayer(widths[i], widths[i + 1], g)
                                  for i in range(4))

    def forward(self, features: dict):
        x0 = self.l1_conv2(self.l1_conv1(features["0"], 2, 1), 2, 1)
        x1 = self.l2_conv1(features["1"], 2, 1)
        x = torch.cat([ops.maxpool2d(x0), ops.maxpool2d(x1),
                       ops.maxpool2d(features["2"]), features["3"]], dim=1)
        for layer in self.fuse:
            x = ops.relu(layer.bn(layer.conv(x, 1, 1)))
        B = x.shape[0]
        # NHWC [B, 7, 7, C] flattened row-major to 49 tokens
        return x.permute(0, 2, 3, 1).reshape(B, 49, 1, self.proj_dim)
