"""The PyTorch port's ResNetV2 hybrid ViTs (models/resnetv2.py, ViTBase16's
"R50ViT", "ViTPretrained" and "R50ViTPretrained"), their trunk's ops, the
timm-layout loader and the 384-wide kernel forms they run, against the JAX
package, on the CPU in float32.

The port's wrappers run their plain versions here (CPU tensors). The JAX
side runs its Pallas kernels in interpret mode for the kernel cases (the
module fixture of tests/test_torch_port_lean.py pins that and both sides'
float32 matmul precision), and its plain XLA reference for the models (on
a CPU the JAX package takes no kernel unless a switch asks for one).
Inputs come from numpy with a seed, or from the port's seeded initialiser
exported in the JAX layout, and go to both sides unchanged. The models:
depth 1, C = 128, 2 heads, 3 classes, on 64^2 inputs, with each layout's
whole trunk: R26-S/32 (2, 2, 2, 2) gives a 2 x 2 grid, R50-S/16 (3, 4, 9)
a 4 x 4 one. At 64^2 the trunk pads asymmetrically where it does at 224^2:
(2, 3) for the stem, (0, 1) for the pool and the stride-2 3x3 convs.
Bars, each its counterpart's elsewhere:
  * single ops: 1e-5 (tests/test_torch_port_kernels.py);
  * the kernels' plain versions at C = 384: atol = rtol = 3e-5 in units
    of each output's RMS (tests/test_torch_port_vit.py);
  * the trunk maps in units of their RMS, the CLS, the logits and the
    training steps: 1e-4 (tests/test_parity.py:19-29,
    tests/test_torch_port_vit.py's _check_run), but for the two
    measured exceptions at TRUNK_INIT_TOL and STD_GRAD_TOL below;
  * the param trees: bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu import train as jtrain
from duoformer_tcga_tpu.models.baselines import ViTBase16 as JaxViTBase16
from duoformer_tcga_tpu.models.resnetv2 import HybridViT as JaxHybridViT
from duoformer_tcga_tpu.ops import nn as jnn
from duoformer_tcga_tpu.ops import pallas_attention as pa
from duoformer_tcga_tpu.ops import pallas_norm as pn
from duoformer_tcga_tpu.utils import torch_convert as tc

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.models.baselines import HYBRID_TYPES
from duoformer_tcga_tpu_torch.models.resnetv2 import HybridViT
from duoformer_tcga_tpu_torch.models.transformer import ScaleBlock
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import initializers as init
from duoformer_tcga_tpu_torch.ops import nn as tnn
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)
from duoformer_tcga_tpu_torch.utils.timm_convert import load_timm_vit

from test_torch_port_lean import pinned_numerics  # noqa: F401
from test_torch_port_reg import (_arr, _attention_args, _close_in_rms_units,
                                 _flat, _rms)
from test_torch_port_scales_train import BWD_DW_NAMES, BWD_NAMES, _j
from torch_oracle import OracleScaleBlock, OracleTimmHybridViT

TOL = dict(atol=3e-5, rtol=3e-5)
OP_TOL = dict(atol=1e-5, rtol=1e-5)
PARITY = dict(atol=1e-4, rtol=1e-4)
# Two bars are 1e-3, as 1e-4 would ask more than float32 gives here on
# either side. Measured against a float64 run of the port on these inputs:
# the R50-S/16 trunk's map as initialised sits up to 2.4e-4 of its RMS
# away (float32 JAX and port alike); the trunk's kernel gradients up to
# 3.4e-4 (port) and 3.1e-4 (JAX), where the weight standardisation's
# backward subtracts each output channel's mean gradient, large against
# the rest with the positive ReLU outputs as inputs.
TRUNK_INIT_TOL = dict(atol=1e-3, rtol=1e-3)
STD_GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
# the share of elements whose Adam update may depend on that rounding
# (1e-4 in tests/test_torch_port_vit.py): 10 times that, as the kernel
# gradients' bar is 10 times its (1.3e-4 measured on R26-S/32)
MASKED_MAX = 1e-3
WEIGHT_DECAY = 1e-4
IMG = 64
SMALL = dict(embed_dim=128, depth=1, num_heads=2, num_classes=3,
             img_size=IMG)
LAYOUTS = {"r26_s32": (2, 2, 2, 2), "r50_s16": (3, 4, 9)}
STEPS = 3
# the kernel cases: ViT-S's width and heads at R26-S/32's 50 tokens
C384, H384, S50 = 384, 6, 50


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def fast_init(monkeypatch):
    """Zeros for the port's truncated-normal draws (most of a full-width
    build's time on the CPU) in a test that needs no such values."""
    monkeypatch.setattr(init, "trunc_normal",
                        lambda shape, std=0.02, generator=None:
                        torch.zeros(shape))


# ---------------------------------------------------------------------------
# The trunk's ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,hw", [(64, 16), (256, 7)])
def test_groupnorm_matches_jax(C, hw):
    rng = np.random.default_rng(C)
    x = _arr(rng, 2, hw, hw, C, std=3.0, mean=0.5)
    scale, bias = _arr(rng, C, std=0.1, mean=1.0), _arr(rng, C, std=0.1)
    ref = jnn.groupnorm({"scale": scale, "bias": bias}, jnp.asarray(x), 32)
    got = tnn.groupnorm(*_t(x.transpose(0, 3, 1, 2), scale, bias), 32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), **OP_TOL)


@pytest.mark.parametrize("k,stride,size,pads", [
    (7, 2, 224, (2, 3)),    # the stem at 224^2
    (7, 2, IMG, (2, 3)),    # the stem at 64^2
    (3, 2, 16, (0, 1)),     # a stage's first conv2
    (3, 1, 8, (1, 1)),
    (1, 2, 16, (0, 0)),     # a stage's downsample
])
def test_stdconv2d_matches_jax(k, stride, size, pads):
    """The weight-standardised SAME convolution against nn.stdconv2d, the
    XLA pads as the trunk meets them."""
    rng = np.random.default_rng(k * size + stride)
    cin, cout = (3, 8) if k == 7 else (16, 32)
    x = _arr(rng, 2, size, size, cin)
    w = _arr(rng, k, k, cin, cout, std=0.3, mean=0.05)      # HWIO
    assert tnn._same_padding(size, k, stride) == pads
    ref = jnn.stdconv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride,
                        "SAME")
    got = tnn.stdconv2d(*_t(x.transpose(0, 3, 1, 2), w.transpose(3, 2, 0, 1)),
                        stride, "SAME")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), **OP_TOL)
    conv = tnn.StdConv2d(k, k, cin, cout)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    torch.testing.assert_close(conv(_t(x.transpose(0, 3, 1, 2))[0], stride),
                               got, atol=0, rtol=0)
    conv.standardize_()
    torch.testing.assert_close(conv(_t(x.transpose(0, 3, 1, 2))[0], stride),
                               got, atol=0, rtol=0)


@pytest.mark.parametrize("size", [IMG // 2, 112])
def test_maxpool_same_matches_jax(size):
    """The trunk's 3x3 stride-2 SAME pool pads (0, 1) with -inf: values
    below zero show a zero pad."""
    rng = np.random.default_rng(size)
    x = _arr(rng, 2, size, size, 4, mean=-3.0)
    ref = jnn.maxpool2d(jnp.asarray(x), 3, 2, "SAME")
    got = tnn.maxpool2d(*_t(x.transpose(0, 3, 1, 2)), 3, 2, "SAME")
    assert got.shape[-1] == size // 2
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(ref))


# ---------------------------------------------------------------------------
# The 384-wide kernel forms (ViT-S: 6 heads, 50 tokens)
# ---------------------------------------------------------------------------

def test_attention_384_matches_pallas():
    """fused_attention_residual, full form, against _fused_block_impl."""
    rng = np.random.default_rng(1)
    arrays = _attention_args(rng, 2, S50, C384)[:7]
    ref = pa._fused_block_impl(*_j(arrays), H384, S50, 0.125, 1e-6, True,
                               True)
    fa.reset_launch_counts()
    got = fa.fused_attention_residual(*_t(*arrays), H384, S50, 0.125)
    _close_in_rms_units(got, ref, TOL, "y")
    assert sum(fa.launch_counts.values()) == 0


@pytest.mark.parametrize("dw", [False, True], ids=["dw_false", "dw"])
def test_attention_bwd_384_matches_pallas(dw):
    """fused_attention_residual_bwd against _fused_block_bwd_impl, both
    forms; the Pallas row tensors carry padded rows past n_seg * S."""
    rng = np.random.default_rng(2)
    x, lns, lnb, wqkv, bqkv, wproj, _, _ = _attention_args(rng, 2, S50,
                                                           C384)
    g = _arr(rng, 2, S50, C384)
    arrays = (x, g, lns, lnb, wqkv, bqkv, wproj)
    ref = pa._fused_block_bwd_impl(*_j(arrays), H384, S50, 0.125, 1e-6,
                                   True, True, dw=dw)
    fa.reset_launch_counts()
    got = fa.fused_attention_residual_bwd(*_t(*arrays), H384, S50, 0.125,
                                          dw=dw)
    names = BWD_DW_NAMES if dw else BWD_NAMES
    assert len(got) == len(ref) == len(names)
    for name, t, r in zip(names, got, ref):
        r = np.asarray(r)
        if name in ("ln", "attn", "dqkv"):
            r = r[:2 * S50]
        _close_in_rms_units(t, r, TOL, name)
    assert sum(fa.launch_counts.values()) == 0


def _mlp_args(rng, rows, C=C384):
    H = 4 * C
    return (_arr(rng, rows, C), _arr(rng, C, std=0.1, mean=1.0),
            _arr(rng, C, std=0.1), _arr(rng, C, H, std=C ** -0.5),
            _arr(rng, H, std=0.1), _arr(rng, H, C, std=H ** -0.5),
            _arr(rng, C, std=0.1))


@pytest.mark.parametrize("form", ["z", "dz", "bwd", "layernorm"])
def test_mlp_forms_384_match_pallas(form):
    """The MLP kernels' plain versions at C = 384, hidden 1536, over 150
    rows (3 segments of 50; ragged against the TPU kernels' row tiles):
    the z form (_fused_mlp_impl), mlp_dz (_mlp_dz_impl), the
    recompute-from-x backward (_fused_mlp_bwd_impl) and the LayerNorm
    (pallas_norm.fused_layernorm)."""
    rng = np.random.default_rng(3)
    rows = 3 * S50
    x, lns, lnb, w1, b1, w2, b2 = args = _mlp_args(rng, rows)
    fa.reset_launch_counts()
    if form == "z":
        ref = pa._fused_mlp_impl(*_j(args), 1e-6, return_hidden=True)
        got = fa.fused_mlp_residual(*_t(*args), 1e-6, return_hidden=True)
        names = ("y", "z")
    elif form == "dz":
        g2, z = _arr(rng, rows, C384), _arr(rng, rows, 4 * C384)
        ref = pa._mlp_dz_impl(*_j((g2, z, w2)), emit_h=False)[:2]
        got = fa.mlp_dz(*_t(g2, z, w2))
        names = ("dz", "db1")
    elif form == "bwd":
        g = _arr(rng, rows, C384)
        ref = pa._fused_mlp_bwd_impl(*_j((x, g, lns, lnb, w1, b1, w2)),
                                     1e-6)
        got = fa.fused_mlp_bwd(*_t(x, g, lns, lnb, w1, b1, w2), 1e-6)
        names = ("dx", "ln", "h", "dz", "dlns", "dlnb")
    else:
        ref = (pn.fused_layernorm(*_j((x, lns, lnb)), 1e-6),)
        got = (tnn.fused_layernorm(*_t(x, lns, lnb), 1e-6),)
        names = ("y",)
    for name, t, r in zip(names, got, ref):
        r = np.asarray(r)
        _close_in_rms_units(t, r[:rows] if r.ndim == 2 else r, TOL, name)
    assert sum(fa.launch_counts.values()) == 0


@pytest.mark.parametrize("C,seg_len,admitted", [
    (384, S50, True),       # the seg_len <= 64 kernels, instantiated
    (384, 86, False),       # the 65..86-token kernels are not
    (384, 197, False),      # nor the long-segment chain
    (640, S50, False),      # nor any kernel at 640
    (768, 197, True),
])
def test_attention_width_gates(C, seg_len, admitted):
    """The widths the card's attention wrappers admit (attention_widths,
    checked before any launch); the MLP wrappers take SHORT_C, the int8
    and 65..197-token ones SUPPORTED_C."""
    x = torch.zeros(1, seg_len, C)
    check = lambda: fa._check_attention_x(  # noqa: E731
        x, seg_len, C // 64, "w", fa.ATTN_LONG_MAX_SEG_LEN,
        fa.attention_widths(seg_len))
    if admitted:
        assert check() == (1, seg_len, C)
    else:
        with pytest.raises(ValueError, match=f"instantiated for C in .*"
                                             f"got {C}"):
            check()
    assert (384 in fa.SHORT_C and 640 not in fa.SHORT_C
            and 384 not in fa.SUPPORTED_C)


# ---------------------------------------------------------------------------
# Weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_timm_loader_matches_oracle_and_jax(layout):
    """load_timm_vit on a timm-layout hybrid state_dict (the oracle of
    tests/torch_oracle.py): the logits against the oracle at 1e-4, and
    every tensor equal to the JAX converter's tree (convert_timm_hybrid)
    loaded by load_jax_params."""
    layers = LAYOUTS[layout]
    torch.manual_seed(21)
    oracle = OracleTimmHybridViT(layers=layers, **SMALL).eval()
    sd = oracle.state_dict()
    model = load_timm_vit(HybridViT(layers, **SMALL), sd)
    x = torch.from_numpy(_arr(np.random.default_rng(4), 2, IMG, IMG, 3))
    with torch.no_grad():
        ref = oracle(x.permute(0, 3, 1, 2))
        got = model(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **PARITY)

    class _Shim:                  # convert_timm_hybrid reads model.hybrid
        hybrid = JaxHybridViT(layers=layers, **SMALL)
    via_jax = load_jax_params(HybridViT(layers, **SMALL),
                              tc.convert_timm_hybrid(sd, _Shim)["model"])
    a, b = model.state_dict(), via_jax.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_timm_loader_plain_vit_matches_oracle_and_jax():
    """load_timm_vit on a plain timm ViT state_dict (patch_embed.proj, the
    blocks of tests/torch_oracle.py): the logits against the oracle at
    1e-4, every tensor equal to JAX convert_vit's tree loaded by
    load_jax_params."""
    torch.manual_seed(12)
    C, P, depth = 128, 16, 1
    pe = torch.nn.Module()
    pe.proj = torch.nn.Conv2d(3, C, P, stride=P)
    oracle = torch.nn.Module()
    oracle.patch_embed = pe
    oracle.cls_token = torch.nn.Parameter(torch.randn(1, 1, C) * 0.02)
    oracle.pos_embed = torch.nn.Parameter(
        torch.randn(1, (IMG // P) ** 2 + 1, C) * 0.02)
    oracle.blocks = torch.nn.Sequential(
        *[OracleScaleBlock(C, 2) for _ in range(depth)])
    oracle.norm = torch.nn.LayerNorm(C, eps=1e-6)
    oracle.head = torch.nn.Linear(C, 3)
    sd = oracle.eval().state_dict()
    kw = dict(img_size=IMG, patch_size=P, embed_dim=C, depth=depth,
              num_heads=2, num_classes=3)
    model = load_timm_vit(port.VisionTransformer(**kw), sd)
    x = torch.from_numpy(_arr(np.random.default_rng(5), 2, IMG, IMG, 3))
    with torch.no_grad():
        t = oracle.patch_embed.proj(x.permute(0, 3, 1, 2))
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([oracle.cls_token.expand(2, -1, -1), t], 1)
        t = oracle.blocks(t + oracle.pos_embed)
        ref = oracle.head(oracle.norm(t)[:, 0])
        got = model(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **PARITY)
    via_jax = load_jax_params(port.VisionTransformer(**kw),
                              tc.convert_vit(sd, depth))
    for (k, a), b in zip(model.state_dict().items(),
                         via_jax.state_dict().values()):
        assert torch.equal(a, b), k


_FULL = {}


@pytest.mark.parametrize("model_type",
                         ["R50ViT", "ViTPretrained", "R50ViTPretrained"])
def test_full_width_hybrid_trees_round_trip(monkeypatch, model_type):
    """A JAX ViTBase16 tree of each hybrid type at full width (random
    values in the structure JAX's init gives) goes to the port and back
    bit for bit: the trunk's lists, the stacked blocks, HWIO convs; the
    alias R50ViTPretrained has ViTPretrained's tree and architecture."""
    shapes = jax.eval_shape(JaxViTBase16(n_classes=100,
                                         model_type=model_type).init,
                            jax.random.PRNGKey(0))
    if model_type == "R50ViTPretrained":     # ViTPretrained's alias
        assert shapes == jax.eval_shape(JaxViTBase16(
            n_classes=100, model_type="ViTPretrained").init,
            jax.random.PRNGKey(0))
        assert HYBRID_TYPES[model_type] == HYBRID_TYPES["ViTPretrained"]
        return
    rng = np.random.default_rng(8)
    tree = jax.tree.map(lambda s: rng.random(s.shape, np.float32), shapes)
    dim = tree["model"]["vit"]["pos_embed"].shape[-1]
    if dim not in _FULL:
        fast_init(monkeypatch)
        _FULL[dim] = port.ViTBase16(n_classes=100, model_type=model_type)
    back = _flat(export_jax_params(load_jax_params(_FULL[dim], tree)))
    ref = _flat(tree)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_predictor_refuses_int8_for_the_hybrids(monkeypatch):
    """int8 serving covers the release family only, as in the JAX package:
    a hybrid is refused before the Predictor changes it."""
    fast_init(monkeypatch)
    model = port.ViTBase16(n_classes=3, model_type="R50ViT")
    with pytest.raises(ValueError, match="release DuoFormer"):
        port.Predictor(model, device="cpu", quantize=True)
    assert not any(m.standardized for m in model.modules()
                   if isinstance(m, tnn.StdConv2d))


def test_build_vit_base16_hybrid_on_the_cpu(monkeypatch):
    """build_vit_base16(model_type="R50ViT"), on the CPU on request: in
    eval mode, its weights those of ViTBase16 from the same seed (the
    truncated-normal draws zeros here, the trunk's normal ones compared)."""
    fast_init(monkeypatch)
    a = port.build_vit_base16(n_classes=4, model_type="R50ViT",
                              device="cpu", seed=3)
    assert not a.training and a.model.vit.head.w.shape == (384, 4)
    ref = port.ViTBase16(n_classes=4, model_type="R50ViT",
                         generator=torch.Generator().manual_seed(3))
    for (n, t), (_, u) in zip(a.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(t, u), n
    assert a.model.backbone.stem.conv.w.std() > 0


# ---------------------------------------------------------------------------
# The models against the JAX package
# ---------------------------------------------------------------------------

def _seeded_tree(layers, seed=0, kinks=True):
    """The port's seeded small hybrid in the JAX layout (numpy), its qkv
    biases drawn from N(0, 0.02^2) instead of zeros (the key bias's Adam
    update from zero would be the sign of rounding noise, as
    tests/test_torch_port_vit.py explains). kinks=False moves every
    trunk pre-activation 6-8 of its units from the ReLU's kink: the
    GroupNorm biases before a ReLU are drawn +-U(6, 8), those of norm3 and
    of the shortcut's norm +U(6, 8) (their sum with the shortcut feeds the
    block's last ReLU). At init (biases 0) some of the ~9e5 pre-activations
    of a 64^2 pair sit within float32 rounding of 0 (about 2e-5 of their
    RMS after 8 blocks) and their gradient switches on or off between any
    two float32 runs: one such element moved the port's trunk gradients by
    up to 0.9 of a leaf's RMS against a float64 run, where JAX's stayed at
    8e-5. Away from the kinks the gradient is smooth in the rounding and
    both ReLU branches still run (half the norm1 and norm2 channels
    pass, half are cut)."""
    tree = export_jax_params(HybridViT(
        layers, **SMALL, generator=torch.Generator().manual_seed(seed)))
    qkv = tree["vit"]["blocks"]["attn"]["qkv"]
    qkv["b"] = (np.random.default_rng(6).standard_normal(qkv["b"].shape)
                * 0.02).astype(np.float32)
    if not kinks:
        rng = np.random.default_rng(7)
        trunk = tree["backbone"]

        def shift(norm, signed):
            b = rng.uniform(6.0, 8.0, norm["bias"].shape)
            if signed:
                b *= rng.choice([-1.0, 1.0], b.shape)
            norm["bias"] = b.astype(np.float32)

        shift(trunk["stem"]["norm"], True)
        for stage in trunk["stages"]:
            for blk in stage["blocks"]:
                shift(blk["norm1"], True)
                shift(blk["norm2"], True)
                shift(blk["norm3"], False)
                if "downsample" in blk:
                    shift(blk["downsample"]["norm"], False)
    return tree


def _port(layers, tree, **kw):
    return load_jax_params(HybridViT(layers, **SMALL, **kw), tree)


def _batch():
    rng = np.random.default_rng(9)
    return _arr(rng, 2, IMG, IMG, 3), np.array([0, 2], np.int32)


def _trees(layers):
    """{"init": the seeded tree as initialised, "smooth": with the kinks
    moved}."""
    return {"init": _seeded_tree(layers),
            "smooth": _seeded_tree(layers, kinks=False)}


def _jax_side(layers, trees):
    """JAX on the batch: from the seeded tree as initialised ("init") and
    with the kinks moved ("smooth"), the trunk map, CLS and logits (one
    jit); from the smooth tree, 3 steps of make_train_step (Adam, L2 1e-4
    on every leaf, OneCycle at 1e-3 over 10 steps, nothing frozen: cli.py's
    "vit"), its first gradients read off its Adam state after step 1: mu =
    (1 - b1) (g + 1e-4 p0)."""
    x, labels = _batch()
    jm = JaxHybridViT(layers=layers, **SMALL)

    @jax.jit
    def forward(p, x):
        feats = jm.trunk.apply(p["backbone"], x)
        y = jnn.conv2d(p["vit"]["patch_embed"], feats, 1, "VALID")
        tokens = jnp.concatenate([jnp.broadcast_to(
            p["vit"]["cls_token"], (2, 1, SMALL["embed_dim"])),
            y.reshape(2, -1, SMALL["embed_dim"])], axis=1)
        tokens = jm.vit.forward_tokens(p["vit"],
                                       tokens + p["vit"]["pos_embed"])
        return feats, tokens[:, 0], jm.vit.forward_head(p["vit"], tokens)

    out = {}
    for name, tree in trees.items():
        feats, cls, logits = forward(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(x))
        out[name] = dict(j_feats=np.asarray(feats), j_cls=np.asarray(cls),
                         j_logits=np.asarray(logits))
    p0 = trees["smooth"]
    params = jax.tree.map(jnp.asarray, p0)
    opt = jtrain.make_optimizer(jtrain.onecycle_schedule(1e-3, 10),
                                WEIGHT_DECAY)
    state = {"params": params, "opt_state": jax.jit(opt.init)(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jtrain.make_train_step(jm, opt, donate=False)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    losses, after, grads = [], [], None
    for i in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
        after.append(_flat(state["params"]))
        if i == 0:
            mu = next(s.mu for s in state["opt_state"] if hasattr(s, "mu"))
            grads = {k: v / (1 - 0.9) - WEIGHT_DECAY * _flat(p0)[k]
                     for k, v in _flat(mu).items()}
    return dict(out, j_grads=grads, j_losses=losses, j_params=after)


@pytest.fixture(scope="module")
def jax_sides():
    """Both layouts' seeded trees and JAX sides, run together in two
    threads (XLA compiles one while the other traces)."""
    trees = {k: _trees(v) for k, v in LAYOUTS.items()}
    with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
        jobs = {k: pool.submit(_jax_side, LAYOUTS[k], trees[k])
                for k in LAYOUTS}
        return {k: (trees[k], job.result()) for k, job in jobs.items()}


@pytest.fixture(scope="module", params=list(LAYOUTS), ids=list(LAYOUTS))
def hybrid_run(request, jax_sides):
    """Both sides from the seeded trees: the JAX side (_jax_side), and the
    port on the same batch, the forward from both trees through
    Predictor(device="cpu") and 3 steps of make_train_step from the smooth
    tree."""
    layers = LAYOUTS[request.param]
    trees, j = jax_sides[request.param]
    x, labels = _batch()
    out = dict(layers=layers, x=x, labels=labels)
    for name, tree in trees.items():
        pred = port.Predictor(_port(layers, tree), device="cpu",
                              dtype=torch.float32, preprocess=False)
        logits, cls = pred.embed(x)
        feats = pred.model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        out[name] = dict(
            tree=tree, pred=pred, t_cls=cls, t_logits=logits,
            t_feats=feats.detach().numpy().transpose(0, 2, 3, 1))
    p0 = out["smooth"]["tree"]
    model = _port(layers, p0)
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                WEIGHT_DECAY)
    state = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, dtype=torch.float32)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    losses, after, grads = [], [], None
    for i in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _flat(export_jax_params(model, grads=True))
        after.append(_flat(export_jax_params(model)))
    for name in ("init", "smooth"):
        out[name].update(j.pop(name))
    return dict(out, **j, p0=_flat(p0), t_grads=grads, t_losses=losses,
                t_params=after)


def _grad_tol(key):
    """The first gradients' bar: PARITY, and STD_GRAD_TOL for the trunk's
    kernels."""
    trunk_w = key.startswith("['backbone']") and key.endswith("['w']")
    return STD_GRAD_TOL if trunk_w else PARITY


def _allclose(out, ref, tol, msg):
    """np.testing.assert_allclose's test, in fewer passes over millions of
    elements."""
    bad = np.abs(out - ref) > tol["atol"] + tol["rtol"] * np.abs(ref)
    assert not bad.any(), (f"{msg}: {bad.sum()} of {bad.size} elements "
                           f"off, max |diff| {np.abs(out - ref).max()}")


def _check_steps(r):
    """tests/test_torch_port_vit.py's _check_run with the trunk's kernel
    gradients at STD_GRAD_TOL: the losses, the first gradients (in units
    of their RMS) and the params after each step at 1e-4, each leaf's
    update since the start at 1e-2 in units of its RMS, leaving out the
    elements whose Adam input g + 1e-4 p differs between the sides by more
    than 1e-2 of its size: at most MASKED_MAX of them."""
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], **PARITY)
    assert set(r["t_grads"]) == set(r["j_grads"]) == set(r["p0"])
    for k, g in r["t_grads"].items():
        unit = _rms(r["j_grads"][k])
        _allclose(g / unit, r["j_grads"][k] / unit, _grad_tol(k), k)
    keep, n = {}, 0
    for k, p in r["p0"].items():
        gj = r["j_grads"][k] + WEIGHT_DECAY * p
        gt = r["t_grads"][k] + WEIGHT_DECAY * p
        keep[k] = np.abs(gt - gj) <= 1e-2 * np.abs(gj)
        n += keep[k].size
    assert sum((~m).sum() for m in keep.values()) <= MASKED_MAX * n
    for t, j in zip(r["t_params"], r["j_params"]):
        assert set(t) == set(j)
        for k in j:
            _allclose(t[k], j[k], PARITY, k)
            ref = (j[k] - r["p0"][k])[keep[k]]
            unit = _rms(ref)
            _allclose((t[k] - r["p0"][k])[keep[k]] / unit, ref / unit,
                      dict(atol=1e-2, rtol=1e-2), k)


@pytest.mark.parametrize("tree", ["init", "smooth"])
def test_trunk_matches_jax(hybrid_run, tree):
    """The whole trunk's map against ResNetV2Trunk, in units of its RMS:
    at 1e-4 from the smooth tree, at TRUNK_INIT_TOL from the tree as
    initialised."""
    r, f = hybrid_run, hybrid_run[tree]
    grid = IMG // (4 * 2 ** (len(r["layers"]) - 1))
    assert f["t_feats"].shape == f["j_feats"].shape == (
        2, grid, grid, 256 * 2 ** (len(r["layers"]) - 1))
    _close_in_rms_units(f["t_feats"], f["j_feats"],
                        PARITY if tree == "smooth" else TRUNK_INIT_TOL,
                        "trunk")


@pytest.mark.parametrize("tree", ["init", "smooth"])
def test_hybrid_forward_matches_jax(hybrid_run, tree):
    """Predictor(device="cpu").embed: the post-norm CLS and the logits
    against JAX at 1e-4 (in units of their RMS), __call__ gives the same
    logits, and the Predictor standardised the trunk's kernels once."""
    r, f = hybrid_run, hybrid_run[tree]
    _close_in_rms_units(f["t_cls"], f["j_cls"], PARITY, "cls")
    _close_in_rms_units(f["t_logits"], f["j_logits"], PARITY, "logits")
    assert torch.equal(f["pred"](r["x"]), f["t_logits"])
    assert all(m.standardized for m in f["pred"].model.modules()
               if isinstance(m, tnn.StdConv2d))


def test_hybrid_train_steps_match_jax(hybrid_run):
    """make_train_step over 3 steps against JAX's: the losses, the first
    gradients, the params after each step and each leaf's update (the
    trunk's included: every parameter trains)."""
    r = hybrid_run
    _check_steps(r)
    assert not any(np.array_equal(r["t_params"][-1][k], v)
                   for k, v in r["p0"].items())


def test_hybrid_lean_step_matches_jax(hybrid_run):
    """One step of the memory-lean routes (fused_ln, the recompute-from-x
    MLP backward, the attention backward's dw form) against JAX's first
    step: in float32 the routes compute the same step."""
    r = hybrid_run
    model = _port(r["layers"], r["smooth"]["tree"], fused_ln=True)
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                WEIGHT_DECAY)
    state = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, dtype=torch.float32,
                                  mlp_save_hidden=False, attn_bwd_dw=True)
    state, m = step(state, {"image": torch.from_numpy(r["x"]),
                            "label": torch.from_numpy(r["labels"])})
    blocks = [b for b in model.modules() if isinstance(b, ScaleBlock)]
    assert blocks and all(b.attn_bwd_dw and not b.mlp_save_hidden
                          for b in blocks)
    _check_steps(dict(r, t_losses=[float(m["loss"])],
                      t_grads=_flat(export_jax_params(model, grads=True)),
                      t_params=[_flat(export_jax_params(model))],
                      j_losses=r["j_losses"][:1],
                      j_params=r["j_params"][:1]))


def test_trunk_is_not_frozen_by_the_backbone_labels(monkeypatch):
    """backbone_frozen_labels freezes a top-level `backbone` only, as the
    JAX package's _label_tree does (train.py:138-153): the hybrid's trunk
    sits under model.backbone and trains."""
    fast_init(monkeypatch)
    model = port.ViTBase16(n_classes=3, model_type="R50ViT")
    labels = ttrain.backbone_frozen_labels(model)
    assert any(n.startswith("model.backbone.") for n in labels)
    assert set(labels.values()) == {"train"}
    tree = export_jax_params(model)
    assert set(jax.tree.leaves(jtrain.backbone_frozen_labels(tree))) == {
        "train"}
