"""Per-stage 1x1 projections to proj_dim (counterpart of
duoformer_tcga_tpu/models/projection.py: Projection). Kaiming-normal
weights, bias normal(1e-6), as the reference's projection head."""

from __future__ import annotations

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
