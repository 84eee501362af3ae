"""Pyramid -> region regrouping (counterpart of
duoformer_tcga_tpu/models/regroup.py).

Each of the 49 coarse 7x7 regions collects its spatially aligned finer
tokens, coarsest stage first. Quirk Q8 is kept: the 14x14 stage's 2x2
blocks are enumerated column-major ((j, i): tl, bl, tr, br,
model.py:114-121), the 28x28 and 56x56 blocks row-major. The learned
per-slot pos_embed_for_scale makes the order observable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

STAGE_GRID = {"0": 56, "1": 28, "2": 14, "3": 7}
STAGE_TOKENS = {"0": 64, "1": 16, "2": 4, "3": 1}


@functools.lru_cache(maxsize=None)
def region_index(stage: str) -> np.ndarray:
    """[49, tokens_per_region] row-major flat positions into the stage's
    HxW grid, per the reference's formulas."""
    if stage not in STAGE_GRID:
        raise ValueError(f"unknown stage {stage}")
    n = STAGE_GRID[stage] // 7
    idx = np.empty((49, n * n), dtype=np.int64)
    for r in range(7):
        for c in range(7):
            if stage == "2":     # Q8: column-major 2x2 enumeration
                cells = [(i, j) for j in range(n) for i in range(n)]
            else:
                cells = [(i, j) for i in range(n) for j in range(n)]
            idx[r * 7 + c] = [(n * r + i) * STAGE_GRID[stage] + n * c + j
                              for i, j in cells]
    idx.flags.writeable = False
    return idx


def _regroup_stage(f: torch.Tensor, stage: str) -> torch.Tensor:
    """One stage's blocked space-to-depth as a view + permute."""
    B, H, W, C = f.shape
    n = H // 7
    x = f.reshape(B, 7, n, 7, n, C)             # [B, r, i, c, j, C]
    if stage == "2":
        x = x.permute(0, 1, 3, 4, 2, 5)         # Q8: (j, i)
    else:
        x = x.permute(0, 1, 3, 2, 4, 5)         # (i, j)
    return x.reshape(B, 49, n * n, C)


def _check(f, s):
    B, H, W, C = f.shape
    if not (H == W == STAGE_GRID[s]):
        raise ValueError(f"stage {s} must be {STAGE_GRID[s]}x"
                         f"{STAGE_GRID[s]}, got {tuple(f.shape)}")


def regroup(features: dict, stages) -> torch.Tensor:
    """features: {stage: [B, H, W, C]} (NHWC, common C) -> [B, 49, S, C]
    with S the tokens per region summed over `stages` (coarsest first)."""
    parts = []
    for s in stages:
        _check(features[s], s)
        parts.append(_regroup_stage(features[s], s))
    return torch.cat(parts, dim=2)


def regroup_gather(features: dict, stages) -> torch.Tensor:
    """The reference formulation: explicit index tables and a gather."""
    parts = []
    for s in stages:
        f = features[s]
        _check(f, s)
        B, H, W, C = f.shape
        idx = torch.from_numpy(region_index(s).copy()).to(f.device)
        parts.append(f.reshape(B, H * W, C)[:, idx])
    return torch.cat(parts, dim=2)


def stages_for(num_layers: int):
    """Coarsest-first stage list for a scale count."""
    return ["3", "2", "1", "0"][:num_layers]
