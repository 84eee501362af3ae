"""Tile preprocessing on the device (counterpart of
duoformer_tcga_tpu/data/pipeline.py: normalize, preprocess_tiles).

224x224 tiles only: resizing is a later slice and other sizes raise.
"""

from __future__ import annotations

import numpy as np
import torch

# torchvision ImageNet normalisation (the r50 backbones' standard)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x, mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.bfloat16):
    """uint8 [..., H, W, 3] -> normalised `dtype`, as one float32 affine
    x * a + b with the JAX package's constants."""
    a = (1.0 / (255.0 * np.asarray(std))).astype(np.float32)
    b = (-np.asarray(mean) / np.asarray(std)).astype(np.float32)
    a = torch.from_numpy(a).to(x.device)
    b = torch.from_numpy(b).to(x.device)
    return (x.float() * a + b).to(dtype)


def preprocess_tiles(raw_uint8, size: int = 224, dtype=torch.bfloat16,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 tiles [B, size, size, 3] -> normalised batch in `dtype`."""
    if tuple(raw_uint8.shape[-3:-1]) != (size, size):
        raise NotImplementedError(
            f"tiles of {tuple(raw_uint8.shape[-3:-1])} need a resize to "
            f"{size}x{size}, which is not ported to the PyTorch package yet")
    return normalize(raw_uint8, mean, std, dtype)
