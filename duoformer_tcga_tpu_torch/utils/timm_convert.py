"""Load a timm-layout state_dict into the port's ViTBase16 (counterpart of
duoformer_tcga_tpu/utils/torch_convert.py: convert_vit, convert_resnetv2,
convert_timm_hybrid).

timm's keys: a plain ViT has patch_embed.proj, cls_token, pos_embed,
blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm
and head; a hybrid (vit_base_r50_s16_224, vit_small_r26_s32_224) has its
ResNetV2 trunk under patch_embed.backbone (stem.conv, stem.norm,
stages.{s}.blocks.{b}.{conv1..3, norm1..3, downsample.conv,
downsample.norm}) and its 1x1 embed conv as patch_embed.proj. The keys map
onto the JAX package's tree (linear weights transposed to (in, out), conv
weights to HWIO, LayerNorm and GroupNorm weight/bias to scale/bias, the
blocks stacked over depth), which utils/convert.load_jax_params copies
into the model. The trunk's kernels convert raw: they are standardised at
the forward.
"""

from __future__ import annotations

import numpy as np

from ..models.baselines import ViTBase16
from ..models.resnetv2 import HybridViT
from .convert import _stack, load_jax_params


def _t(x):
    """A tensor or array -> a numpy copy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.array(x)


def _linear(sd, pre):
    p = {"w": _t(sd[f"{pre}.weight"]).T}
    if f"{pre}.bias" in sd:
        p["b"] = _t(sd[f"{pre}.bias"])
    return p


def _conv(sd, pre):
    p = {"w": _t(sd[f"{pre}.weight"]).transpose(2, 3, 1, 0)}
    if f"{pre}.bias" in sd:
        p["b"] = _t(sd[f"{pre}.bias"])
    return p


def _norm(sd, pre):
    return {"scale": _t(sd[f"{pre}.weight"]), "bias": _t(sd[f"{pre}.bias"])}


def _block(sd, pre):
    return {"norm1": _norm(sd, f"{pre}.norm1"),
            "attn": {"qkv": _linear(sd, f"{pre}.attn.qkv"),
                     "proj": _linear(sd, f"{pre}.attn.proj")},
            "norm2": _norm(sd, f"{pre}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{pre}.mlp.fc1"),
                    "fc2": _linear(sd, f"{pre}.mlp.fc2")}}


def vit_tree(sd, depth):
    """The ViT's tree (torch_convert.convert_vit), its patch embed from
    patch_embed.proj (a hybrid's 1x1 conv, as convert_timm_hybrid takes
    it)."""
    return {"patch_embed": _conv(sd, "patch_embed.proj"),
            "cls_token": _t(sd["cls_token"]), "pos_embed": _t(sd["pos_embed"]),
            "blocks": _stack([_block(sd, f"blocks.{i}")
                              for i in range(depth)]),
            "norm": _norm(sd, "norm"), "head": _linear(sd, "head")}


def resnetv2_tree(sd, layers, prefix="patch_embed.backbone."):
    """The ResNetV2 trunk's tree (torch_convert.convert_resnetv2)."""
    stages = []
    for si, n in enumerate(layers):
        blocks = []
        for bi in range(n):
            pre = f"{prefix}stages.{si}.blocks.{bi}"
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = _conv(sd, f"{pre}.conv{ci}")
                blk[f"norm{ci}"] = _norm(sd, f"{pre}.norm{ci}")
            if f"{pre}.downsample.conv.weight" in sd:
                blk["downsample"] = {
                    "conv": _conv(sd, f"{pre}.downsample.conv"),
                    "norm": _norm(sd, f"{pre}.downsample.norm")}
            blocks.append(blk)
        stages.append({"blocks": blocks})
    return {"stem": {"conv": _conv(sd, f"{prefix}stem.conv"),
                     "norm": _norm(sd, f"{prefix}stem.norm")},
            "stages": stages}


def timm_tree(sd, model):
    """A timm state_dict -> the JAX tree of the port's `model`: a
    ViTBase16 ({"model": ...}), a HybridViT ({"backbone", "vit"};
    torch_convert.convert_timm_hybrid) or a VisionTransformer
    (torch_convert.convert_vit)."""
    if isinstance(model, ViTBase16):
        return {"model": timm_tree(sd, model.model)}
    if isinstance(model, HybridViT):
        return {"backbone": resnetv2_tree(sd, model.backbone.layers),
                "vit": vit_tree(sd, len(model.vit.blocks))}
    return vit_tree(sd, len(model.blocks))


def load_timm_vit(model, sd):
    """Copy a timm-layout state_dict (torch tensors or arrays) into the
    port's `model` (ViTBase16, HybridViT or VisionTransformer) in place
    and return it; every tensor of the model must be provided and every
    converted leaf must land."""
    return load_jax_params(model, timm_tree(sd, model))
