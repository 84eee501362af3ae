"""Load a JAX DuoFormer param tree into the port, and export the port's
parameters in that tree's layout (counterpart of
duoformer_tcga_tpu/utils/torch_convert.py).

The tree is the JAX package's nested dict/list of arrays, handed over as
numpy arrays. The port's module and parameter names are the tree's keys,
so the walk is by name; what changes is layout:
  * depth-stacked `scale_blocks` / `patch_blocks` (the release family) and
    `blocks` (the legacy family, the ViTs) leaves [depth, ...] are split
    over the ModuleList's blocks; lists (the channel fuser's `fuse`, the
    ResNetV2 trunk's `stages` and each stage's `blocks`, whose blocks
    differ in shape) stay lists;
  * conv weights HWIO become OIHW;
  * linear weights stay (in, out), the layout the port keeps;
  * int8 weights w_q of a quantized tree (ops/quantize.py) become
    QuantLinear's (out, in) and stay int8; a quantized tree quantizes the
    model's structure first;
  * BN comes either unfolded (scale/bias/mean/var) or folded (scale/bias,
    fold_for_inference): a folded tree folds the port's BNs first (the
    backbone's and the channel fuser's).
LayerScale (`ls1`, `ls2` {gamma}) and the legacy blocks' carried q/k norms
(`attn2.q_norm`, `attn2.k_norm`) load and export by name like the rest.
Every tensor of the model must be loaded, and every leaf of the tree must
land somewhere: anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.nn import BatchNorm, Conv2d
from ..ops.quantize import QuantLinear, is_quantized, quantize_model_
from ..models.duoformer import fold_for_inference


def _is_folded(tree) -> bool:
    """A ResNet-50 backbone's BN without running statistics (a hybrid's
    trunk has GroupNorm, nothing to fold)."""
    bn1 = tree.get("backbone", {}).get("bn1")
    return bn1 is not None and "mean" not in bn1


def _is_quantized(tree) -> bool:
    blocks = tree.get("transformer", tree).get("scale_blocks", {})
    return "w_q" in blocks.get("attn", {}).get("qkv", {})


def _copy(mod, name, arr, path, loaded):
    target = getattr(mod, name, None)
    if not isinstance(target, torch.Tensor):
        raise KeyError(f"{path}: the model has no tensor there")
    arr = np.asarray(arr)
    if isinstance(mod, Conv2d) and name == "w":
        arr = arr.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
    if isinstance(mod, QuantLinear) and name == "w_q":
        if arr.dtype != np.int8:
            raise TypeError(f"{path}: int8 codes expected, got {arr.dtype}")
        arr = arr.T                                     # (in, out) -> (out, in)
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
    place and return it; a transformer core's tree loads into the core."""
    if _is_folded(tree):
        fold_for_inference(model)
    elif any(m.folded for m in model.modules() if isinstance(m, BatchNorm)):
        raise ValueError("the tree has unfolded BN but the model is folded")
    if _is_quantized(tree):
        quantize_model_(model)
    elif is_quantized(model):
        raise ValueError("the tree has float weights but the model is "
                         "quantized")
    loaded: set = set()
    _load(model, tree, "", loaded)
    missing = set(model.state_dict()) - loaded
    if missing:
        raise KeyError(f"tensors the tree did not provide: "
                       f"{sorted(missing)[:8]}")
    return model


# depth-stacked in the JAX tree
STACKED = ("scale_blocks", "patch_blocks", "blocks")


def _stacked(name):
    """Whether the ModuleList `name` is depth-stacked in the JAX tree: a
    STACKED name that is not itself inside a list (the trunk's
    stages.{s}.blocks are lists)."""
    parts = name.split(".")
    return parts[-1] in STACKED and not (len(parts) > 1
                                         and parts[-2].isdigit())


def _jax_layout(node, lists, prefix=""):
    """The ModuleLists named in `lists` -> a list, or one depth-stacked
    subtree under the STACKED names."""
    if not isinstance(node, dict):
        return node
    node = {k: _jax_layout(v, lists, f"{prefix}{k}.")
            for k, v in node.items()}
    if prefix[:-1] in lists:
        items = [node[str(i)] for i in range(len(node))]
        return _stack(items) if _stacked(prefix[:-1]) else items
    return node


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def export_jax_params(model, grads=False):
    """The model's tensors (every tensor of the state dict) as a JAX-layout
    tree of numpy arrays: conv weights HWIO, int8 w_q (in, out) and int8,
    every other tensor float32, the block stacks stacked over depth, BN
    with its running statistics (folded BN without them).
    grads=True exports the parameters' .grad instead (parameters without
    one are left out)."""
    if grads:
        tensors = {n: p.grad for n, p in model.named_parameters()
                   if p.grad is not None}
    else:
        tensors = model.state_dict()
    tree: dict = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        arr = np.array(t if t.dtype == torch.int8 else t.float())   # a copy
        *path, leaf = name.split(".")
        if leaf == "w" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
        if leaf == "w_q":
            arr = np.ascontiguousarray(arr.T)               # -> (in, out)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    lists = {n for n, m in model.named_modules()
             if isinstance(m, nn.ModuleList)}
    return _jax_layout(tree, lists)
