"""int8 weights for the serving path (counterpart of
duoformer_tcga_tpu/ops/quantize.py).

Weights: symmetric per-output-channel int8, w ~= w_q * w_scale, taken from
the float32 weights (after BN folding, before any cast to the serving
dtype: codes taken from bf16-rounded weights differ from the JAX
package's). Activations: symmetric per-row dynamic int8, inside the
kernels (ops/fused_int8.py).

Layout: a QuantLinear keeps w_q as [out, in], K contiguous, the operand
layout of the int8 tensor-core product on sm_90a (its B operand is
K-major and ldmatrix has no transposing form for 8-bit elements). The
JAX tree's [in, out] is transposed at load and export
(utils/convert.py), as conv weights are.
"""

from __future__ import annotations

import torch
from torch import nn

from . import nn as ops


def quantize_weight(w):
    """Symmetric per-output-channel int8 of a float weight w [in, out] (the
    JAX layout) -> (w_q int8 [in, out], scale float32 [out]), w ~= w_q *
    scale. Rounds half to even (torch.round, as jnp.round), clips to
    +-127."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w / scale), -127, 127)
    return w_q.to(torch.int8), scale


class QuantLinear(nn.Module):
    """A serving-only int8 linear: buffers w_q int8 [out, in], w_scale
    float32 [out] and b float32 [out] (or None). It has no forward of its
    own: the fused int8 kernels read its buffers, and have no backward
    (nor has the JAX package's), so a quantized DuoFormer refuses
    training mode."""

    def __init__(self, w_q, w_scale, b=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)

    @classmethod
    def from_linear(cls, linear: ops.Linear) -> "QuantLinear":
        w_q, scale = quantize_weight(linear.w.detach())
        b = None if linear.b is None else linear.b.detach().float().clone()
        return cls(w_q.t().contiguous(), scale, b)


def _check_quantizable(model):
    """int8 serving covers the release DuoFormer family (MultiscaleFormer
    core, no LayerScale): refuse anything else here, not mid-forward
    (quantize.py:51-69)."""
    tf = getattr(model, "transformer", None)
    if tf is None or not hasattr(tf, "scale_blocks"):
        raise ValueError(
            "int8 quantization supports the release DuoFormer family "
            "(transformer.scale_blocks); this model has none")
    for stack in ("scale_blocks", "patch_blocks"):
        if any(hasattr(b, "ls1") for b in getattr(tf, stack, ())):
            raise ValueError(
                f"int8 quantization does not support LayerScale blocks "
                f"({stack}.ls1 present): the int8 kernels have no gamma "
                f"epilogue; serve this model in bf16 (quantize=False)")


def is_quantized(model) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


@torch.no_grad()
def quantize_model_(model):
    """In place: qkv and proj of every ScaleBlock and PatchBlock, and fc1
    and fc2 of every ScaleBlock, become QuantLinears (what JAX's
    quantize_attention_weights(quantize_mlp_weights(p)) covers). Call it
    on float32 weights. Returns `model`; a quantized model is left as it
    is."""
    _check_quantizable(model)
    if is_quantized(model):
        return model
    tf = model.transformer
    if tf.scale_blocks[0].attn.qkv.w.dtype != torch.float32:
        raise ValueError(
            f"quantize float32 weights (before any cast to the serving "
            f"dtype): this model's are {tf.scale_blocks[0].attn.qkv.w.dtype}"
            f", whose codes differ from the JAX package's")
    for blk in list(tf.scale_blocks) + list(tf.patch_blocks):
        blk.attn.qkv = QuantLinear.from_linear(blk.attn.qkv)
        blk.attn.proj = QuantLinear.from_linear(blk.attn.proj)
    for blk in tf.scale_blocks:
        blk.mlp.fc1 = QuantLinear.from_linear(blk.mlp.fc1)
        blk.mlp.fc2 = QuantLinear.from_linear(blk.mlp.fc2)
    return model.eval()
