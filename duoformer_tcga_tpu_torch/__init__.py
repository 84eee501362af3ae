"""duoformer_tcga_tpu_torch — DuoFormer serving and training in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of duoformer_tcga_tpu (JAX/Pallas), which stays the reference the
port is tested against. This package imports neither JAX nor anything of
duoformer_tcga_tpu. What it covers so far: the release 2-scale DuoFormer
forward (ResNet-50 pyramid -> projections -> regroup -> 12 ScaleBlocks ->
12 PatchBlocks -> head) served by `inference.Predictor` in bf16 or int8
(`quantize=True`, a8w8 transformer GEMMs), the serving artifact the JAX
package exports and loads (`export_serving_artifact`,
`load_serving_artifact`, `from_serving_artifact`), and its training step
with a frozen backbone (`train.py`); the legacy DuoFormer (`build_model`:
channel token, LayerScale, dropout) served and trained the same way, and
the release family's channel token, LayerScale and dropout; with the
fused transformer kernels, their int8 and reg (dropout + LayerScale)
forms, their backward kernels and the dropout mask passes in csrc/; and
the memory-lean training routes (`make_train_step(mlp_save_hidden=False,
attn_bwd_dw=True)`, `fused_ln=True`) with their kernels, and the
block-diagonal attention op `ops.fused_attention.block_diag_attention`.

Entry points run on the card unless the caller passes device="cpu";
without a CUDA device and without that request they raise.
"""

__version__ = "0.1.0"

import torch

from ._device import resolve_device
from .models.duoformer import (DuoFormer, DuoFormerLegacy,  # noqa: F401
                               count_parameters, fold_for_inference)
from .inference import (Predictor, export_serving_artifact,  # noqa: F401
                        from_serving_artifact, load_serving_artifact)
from .ops.quantize import quantize_model_  # noqa: F401


def build_model_no_extra_params(
    depth=12, embed_dim=768, num_heads=12, num_classes=2, num_layers=2,
    num_patches=49, proj_dim=768, mlp_ratio=4.0, attn_drop_rate=0.0,
    proj_drop_rate=0.0, freeze_backbone=True, backbone="r50",
    scale_token="random", patch_attn=True, remat=False,
    apply_fc_norm=False, fused_ln=False, dtype=torch.float32, device=None,
    seed=0,
):
    """Release-variant DuoFormer (reference build_model_no_extra_params),
    initialised from torch.Generator(seed) on the CPU, in eval mode, moved
    to `device` (None -> the card) and cast to `dtype`. fused_ln: fc_norm
    through the LayerNorm kernel (DUOFORMER_FUSED_LN=1). Options of the JAX
    factory that this slice does not cover raise NotImplementedError."""
    if remat:
        raise NotImplementedError(
            "remat (activation rematerialization) is not ported to the "
            "PyTorch package yet")
    device = resolve_device(device)
    model = DuoFormer(
        depth=depth, embed_dim=embed_dim, num_heads=num_heads,
        num_classes=num_classes, num_layers=num_layers,
        num_patches=num_patches, mlp_ratio=mlp_ratio,
        attn_drop_rate=attn_drop_rate, proj_drop_rate=proj_drop_rate,
        proj_dim=proj_dim, freeze_backbone=freeze_backbone,
        backbone=backbone, scale_token=scale_token, patch_attn=patch_attn,
        apply_fc_norm=apply_fc_norm, fused_ln=fused_ln,
        generator=torch.Generator().manual_seed(seed))
    return model.eval().to(device=device, dtype=dtype)


def build_model(
    depth=12, embed_dim=768, num_heads=12, init_values=1e-5, num_classes=2,
    num_layers=2, proj_dim=768, pretrained=True, freeze=True, remat=False,
    fused_ln=False, dtype=torch.float32, device=None, seed=0,
):
    """The legacy DuoFormer (reference build_model -> MyModel; the JAX
    package's build_model, duoformer_tcga_tpu/__init__.py:72-86):
    channel token, MultiscaleTransformer core, LayerScale init_values,
    attention dropout and dropout 0.1. Initialised from
    torch.Generator(seed) on the CPU, in eval mode, moved to `device`
    (None -> the card) and cast to `dtype`. fused_ln: the final norm
    through the LayerNorm kernel. remat raises NotImplementedError."""
    if remat:
        raise NotImplementedError(
            "remat (activation rematerialization) is not ported to the "
            "PyTorch package yet")
    device = resolve_device(device)
    model = DuoFormerLegacy(
        depth=depth, embed_dim=embed_dim, num_heads=num_heads,
        num_classes=num_classes, num_layers=num_layers, proj_dim=proj_dim,
        init_values=init_values, freeze=freeze,
        pretrained_backbone=pretrained, fused_ln=fused_ln,
        generator=torch.Generator().manual_seed(seed))
    return model.eval().to(device=device, dtype=dtype)
