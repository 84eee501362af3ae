"""Load a JAX DuoFormer param tree into the port (counterpart of
duoformer_tcga_tpu/utils/torch_convert.py, in the other direction).

The tree is the JAX package's nested dict/list of arrays, handed over as
numpy arrays. The port's module and parameter names are the tree's keys,
so the walk is by name; what changes is layout:
  * depth-stacked `scale_blocks` / `patch_blocks` leaves [depth, ...] are
    split over the ModuleList's blocks;
  * conv weights HWIO become OIHW;
  * linear weights stay (in, out), the layout the port keeps;
  * BN comes either unfolded (scale/bias/mean/var) or folded (scale/bias,
    fold_for_inference): a folded tree folds the port's BNs first.
Every tensor of the model must be loaded, and every leaf of the tree must
land somewhere: anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.nn import BatchNorm, Conv2d
from ..models.resnet import fold_bn


def _is_folded(tree) -> bool:
    return "mean" not in tree["backbone"]["bn1"]


def _copy(mod, name, arr, path, loaded):
    target = getattr(mod, name, None)
    if not isinstance(target, torch.Tensor):
        raise KeyError(f"{path}: the model has no tensor there")
    arr = np.asarray(arr)
    if isinstance(mod, Conv2d) and name == "w":
        arr = arr.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{path}: tree shape {arr.shape} vs model "
                         f"{tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(np.array(arr)))
    loaded.add(path)


def _load(mod, node, prefix, loaded):
    for key, val in node.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            child = mod[key] if isinstance(mod, nn.ModuleDict) \
                else getattr(mod, key, None)
            if child is None:
                raise KeyError(f"{path}: the model has no module there")
            if isinstance(child, nn.ModuleList):     # depth-stacked leaves
                for i, blk in enumerate(child):
                    _load(blk, _index(val, i, len(child), path),
                          f"{path}.{i}.", loaded)
            else:
                _load(child, val, f"{path}.", loaded)
        elif isinstance(val, (list, tuple)):
            child = getattr(mod, key)
            if len(child) != len(val):
                raise ValueError(f"{path}: {len(val)} blocks in the tree, "
                                 f"{len(child)} in the model")
            for i, (blk, sub) in enumerate(zip(child, val)):
                _load(blk, sub, f"{path}.{i}.", loaded)
        else:
            _copy(mod, key, val, path, loaded)


def _index(tree, i, depth, path):
    """Block i of a depth-stacked subtree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _index(v, i, depth, f"{path}.{k}")
        else:
            if np.shape(v)[0] != depth:
                raise ValueError(f"{path}.{k}: leading axis {np.shape(v)[0]}"
                                 f" is not the depth {depth}")
            out[k] = np.asarray(v)[i]
    return out


def load_jax_params(model, tree):
    """Copy a JAX DuoFormer param tree (numpy leaves) into `model` in
    place and return it."""
    if _is_folded(tree):
        fold_bn(model.backbone)
    elif any(m.folded for m in model.modules() if isinstance(m, BatchNorm)):
        raise ValueError("the tree has unfolded BN but the model is folded")
    loaded: set = set()
    _load(model, tree, "", loaded)
    missing = set(model.state_dict()) - loaded
    if missing:
        raise KeyError(f"tensors the tree did not provide: "
                       f"{sorted(missing)[:8]}")
    return model
