"""The PyTorch port's release DuoFormer at 3 and 4 scales (S = 22 and 86
tokens a region) against the JAX package, on the CPU.

The port's entries run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode under
DUOFORMER_FUSED_ATTN=1 and DUOFORMER_MEGAFUSE=1, as the other
tests/test_torch_port_*.py do. Inputs come from numpy (or from the port's
seeded initialiser, exported in the JAX layout) and go to both sides
unchanged. Bars, each the one its 2-scale counterpart holds:
  * regroup: bit for bit;
  * the attention branch's plain version (fused_attention_residual at
    S = 86 and 22) against the bf16 Pallas kernel: 3e-5, the bar of
    tests/test_torch_port_kernels.py; the int8 one: a branch relative L2
    error of 1e-3, as tests/test_torch_port_int8.py;
  * the 86-token form's two plain twins composed: exactly the plain
    function;
  * the model in float32: the CLS and the logits less the head bias at
    1e-4 in units of their RMS (tests/test_torch_port_model.py);
  * int8 end to end: tests/test_torch_port_int8.py's bars and reasoning
    (5e-2 where two pyramids meet int8; 1e-3 for the JAX int8 stack on the
    port's own tokens; 1e-2 where one side reads the other's artifact in
    float32).
The regularised forms at 86 tokens (LayerScale, dropout) and the 3- and
4-scale models with them are in tests/test_torch_port_reg_scales.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu.inference import Predictor as JaxPredictor
from duoformer_tcga_tpu.inference import (
    export_serving_artifact as jax_export_artifact,
    from_serving_artifact as jax_from_artifact)
from duoformer_tcga_tpu.models import regroup as jregroup
from duoformer_tcga_tpu.models.duoformer import (
    DuoFormer as JaxDuoFormer, fold_for_inference as jax_fold)
from duoformer_tcga_tpu.ops import pallas_attention as pa
from duoformer_tcga_tpu.ops import quantize as jq

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch.models import regroup as tregroup
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import fused_int8 as fi
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

KERNEL_TOL = dict(atol=3e-5, rtol=3e-5)
KERNEL_REL_TOL = 1e-3
MODEL_TOL = 1e-4
STACK_TOL = 1e-3
E2E_REL_TOL = 1e-2
INT8_E2E_REL_TOL = 5e-2
CFG = dict(depth=1, embed_dim=128, num_heads=2, proj_dim=128,
           num_classes=3)


def _randn(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def _assert_close_in_rms_units(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    rms = float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out / rms, ref / rms, atol=tol, rtol=tol)


class _JaxKernels:
    """The JAX package's fused-kernel flags, set for the block."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("DUOFORMER_FUSED_ATTN", "1")
        self.mp.setenv("DUOFORMER_MEGAFUSE", "1")

    def __exit__(self, *exc):
        self.mp.undo()


# ---------------------------------------------------------------------------
# 1. Regroup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [3, 4])
def test_regroup_matches_jax_bit_for_bit(layers):
    rng = np.random.default_rng(layers)
    feats = {s: _randn(rng, 2, g, g, 8)
             for s, g in jregroup.STAGE_GRID.items()}
    stages = tregroup.stages_for(layers)
    assert stages == jregroup.stages_for(layers)
    ref = np.asarray(jregroup.regroup(
        {s: jnp.asarray(f) for s, f in feats.items()}, stages))
    assert ref.shape == (2, 49, 21 if layers == 3 else 85, 8)
    t = {s: torch.from_numpy(f) for s, f in feats.items()}
    np.testing.assert_array_equal(tregroup.regroup(t, stages).numpy(), ref)
    np.testing.assert_array_equal(
        tregroup.regroup_gather(t, stages).numpy(), ref)


# ---------------------------------------------------------------------------
# 2. The attention branch at S = 86 and 22, bf16 and int8 forms
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    (5, 86, True),      # the 4-scale ScaleBlock form
    (3, 86, False),     # bare
    (7, 22, True),      # the 3-scale ScaleBlock form
    (4, 22, False),
]


def _attention_arrays(rng, n_seg, S, C, use_ln, int8=False):
    x = _randn(rng, n_seg, S, C)
    if use_ln:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    else:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    std = 1.5 * C ** -0.5 if int8 else 0.02
    return (x, lns, lnb, _randn(rng, C, 3 * C, std=std),
            _randn(rng, 3 * C, std=0.01),
            _randn(rng, C, C, std=C ** -0.5 if int8 else 0.02),
            _randn(rng, C, std=0.01))


@pytest.mark.parametrize("n_seg,S,use_ln", ATTN_SHAPES)
def test_fused_attention_residual_matches_pallas(n_seg, S, use_ln):
    C, H = 128, 2
    arrays = _attention_arrays(np.random.default_rng(S + n_seg), n_seg, S, C,
                               use_ln)
    scale = (C // H) ** -0.5
    ref = pa.fused_attention_residual(*map(jnp.asarray, arrays), H, S, scale,
                                      1e-6, use_ln, use_ln)
    out = fa.fused_attention_residual(*map(torch.from_numpy, arrays), H, S,
                                      scale, 1e-6, use_ln, use_ln)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


def _port_w(jw_q):
    """JAX int8 [in, out] -> the port's [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(jw_q).T))


def _int8_arrays(n_seg, S, use_ln):
    """(JAX arguments, the port's) of the int8 attention branch, C = 128,
    2 heads."""
    x, lns, lnb, wqkv, bqkv, wproj, bproj = _attention_arrays(
        np.random.default_rng(2 * S + n_seg), n_seg, S, 128, use_ln, True)
    jwq, jsq = jq.quantize_weight(jnp.asarray(wqkv))
    jwp, jsp = jq.quantize_weight(jnp.asarray(wproj))
    t = torch.from_numpy
    jax_args = (jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb), jwq, jsq,
                jnp.asarray(bqkv), jwp, jsp, jnp.asarray(bproj))
    port_args = (t(x), t(lns), t(lnb), _port_w(jwq), t(np.array(jsq)),
                 t(bqkv), _port_w(jwp), t(np.array(jsp)), t(bproj))
    return jax_args, port_args


@pytest.mark.parametrize("n_seg,S,use_ln", ATTN_SHAPES)
def test_fused_attention_residual_int8_matches_pallas(n_seg, S, use_ln):
    H = 2
    scale = (128 // H) ** -0.5
    jax_args, port_args = _int8_arrays(n_seg, S, use_ln)
    ref = np.asarray(pa.fused_attention_residual_int8(
        *jax_args, H, S, scale, 1e-6, use_ln, use_ln), np.float64)
    out = fi.fused_attention_residual_int8(*port_args, H, S, scale, 1e-6,
                                           use_ln, use_ln)
    assert out.shape == (n_seg, S, 128)
    branch = ref - (port_args[0].numpy() if use_ln else 0.0)
    err = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(branch)
    assert err <= KERNEL_REL_TOL, err


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_s86_twins_compose_to_the_plain_function(use_ln, dtype):
    """The two launches' plain twins, core then proj, give the plain
    function's bits, bf16 and int8."""
    S, H = 86, 2
    scale = (128 // H) ** -0.5
    x, lns, lnb, wqkv, bqkv, wproj, bproj = (
        torch.from_numpy(a) for a in _attention_arrays(
            np.random.default_rng(7), 3, S, 128, use_ln))
    x, wqkv, wproj = x.to(dtype), wqkv.to(dtype), wproj.to(dtype)
    o = fa.attention_core_s86(x, lns, lnb, wqkv, bqkv, H, S, scale,
                              use_ln=use_ln)
    assert o.shape == x.shape and o.dtype == dtype
    assert torch.equal(
        fa.attention_proj(o, x, wproj, bproj, use_residual=use_ln),
        fa.fused_attention_residual_plain(x, lns, lnb, wqkv, bqkv, wproj,
                                          bproj, H, S, scale,
                                          use_ln=use_ln,
                                          use_residual=use_ln))
    _, (x8, lns8, lnb8, wq, sq, bq, wp, sp, bp) = _int8_arrays(3, S, use_ln)
    x8 = x8.to(dtype)
    o8 = fi.attention_core_int8_s86(x8, lns8, lnb8, wq, sq, bq, H, S, scale,
                                    use_ln=use_ln)
    assert torch.equal(
        fi.attention_proj_int8(o8, x8, wp, sp, bp, use_residual=use_ln),
        fi.fused_attention_residual_int8_plain(
            x8, lns8, lnb8, wq, sq, bq, wp, sp, bp, H, S, scale,
            use_ln=use_ln, use_residual=use_ln))


# ---------------------------------------------------------------------------
# 3. The model at 3 and 4 scales, float32
# ---------------------------------------------------------------------------

def _seeded_tree(layers):
    """Seeded weights made by the port (JAX's eager init of the ResNet-50
    takes 20 s here), in the JAX layout."""
    return jax.tree.map(jnp.asarray, export_jax_params(port.DuoFormer(
        **CFG, num_layers=layers,
        generator=torch.Generator().manual_seed(layers))))


def _tiles(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 224, 224, 3),
                                                dtype=np.uint8)


def _port_model(layers, tree):
    model = port.DuoFormer(**CFG, num_layers=layers).eval()
    return load_jax_params(model, _np_tree(tree))


def _assert_embed_close_in_rms_units(out, ref, bias, tol):
    (logits, cls), (j_logits, j_cls) = out, ref
    _assert_close_in_rms_units(cls.numpy(), j_cls, tol)
    _assert_close_in_rms_units(logits.numpy() - bias,
                               np.asarray(j_logits) - bias, tol)


@pytest.mark.parametrize("layers", [3, 4])
def test_model_matches_jax_in_float32(layers):
    raw = _seeded_tree(layers)
    tiles = _tiles(layers)
    with _JaxKernels():
        jmodel = JaxDuoFormer(**CFG, num_layers=layers)
        ref = JaxPredictor(jmodel, raw, dtype=jnp.float32).embed(tiles)
    model = _port_model(layers, jax_fold(raw))
    assert model.transformer.fea_dim == (22 if layers == 3 else 86)
    assert sorted(model.projection.stages) == sorted(
        jregroup.stages_for(layers))
    out = port.Predictor(model, device="cpu", dtype=torch.float32,
                         fold=False).embed(tiles)
    _assert_embed_close_in_rms_units(
        out, ref, np.asarray(raw["transformer"]["head"]["b"]), MODEL_TOL)


# ---------------------------------------------------------------------------
# 4. int8 serving and the serving artifact at 4 scales
# ---------------------------------------------------------------------------

META_MODEL = dict(family="duoformer", depth=1, embed_dim=128, proj_dim=128,
                  num_heads=2, num_classes=3, num_layers=4, num_patches=49,
                  mlp_ratio=4.0, scale_token="random", backbone="r50",
                  patch_attn=True, init_values=None, apply_fc_norm=False)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The JAX side at 4 scales: its int8 Predictor's embed(), its int8
    stack on the port's own tokens, its artifact (int8), and its reading
    of the port's int8 artifact."""
    tmp = tmp_path_factory.mktemp("scales")
    raw = _seeded_tree(4)
    folded = jax_fold(raw)
    tiles = _tiles(44)
    model = _port_model(4, folded)
    pred = port.Predictor(model, device="cpu", dtype=torch.float32,
                          fold=False)
    with torch.no_grad():
        tokens = model.tokens(model.features(pred.prepare(tiles))).numpy()
    port_path = str(tmp / "port_int8.npz")
    meta = port.export_serving_artifact(port_path, _port_model(4, folded),
                                        {"step": 3}, quantize=True)
    jax_path = str(tmp / "jax_int8.npz")
    with _JaxKernels():
        jmodel = JaxDuoFormer(**CFG, num_layers=4)
        qtree = jq.quantize_attention_weights(jq.quantize_mlp_weights(folded))
        _, stack_cls = jax.jit(lambda p, t: jmodel.transformer.apply(
            p, t, with_embedding=True))(qtree["transformer"],
                                        jnp.asarray(tokens))
        int8 = JaxPredictor(jmodel, raw, dtype=jnp.float32,
                            quantize=True).embed(tiles)
        jax_export_artifact(jax_path, raw, {"model": META_MODEL},
                            quantize=True)
        jax_reads_port = jax_from_artifact(jmodel, port_path,
                                           dtype=jnp.float32).embed(tiles)
    return dict(folded=folded, tiles=tiles, meta=meta, stack_cls=stack_cls,
                int8=int8, jax_path=jax_path, jax_reads_port=jax_reads_port,
                bias=np.asarray(raw["transformer"]["head"]["b"]))


def _assert_embed_close(out, ref, bias, tol):
    (logits, cls), (j_logits, j_cls) = out, ref
    e_cls = _rel_l2(cls, j_cls)
    e_logits = _rel_l2(np.asarray(logits) - bias, np.asarray(j_logits) - bias)
    assert e_cls <= tol and e_logits <= tol, (e_cls, e_logits)


def _assert_port_int8_serves_like_jax(side, out):
    """Against the JAX int8 Predictor (two pyramids, int8 after them) and
    against the JAX int8 stack on the port's own tokens (one pyramid)."""
    _assert_embed_close(out, side["int8"], side["bias"], INT8_E2E_REL_TOL)
    _assert_close_in_rms_units(np.asarray(out[1]), side["stack_cls"],
                               STACK_TOL)


def test_predictor_int8_matches_jax_predictor(four):
    pred = port.Predictor(_port_model(4, four["folded"]), device="cpu",
                          dtype=torch.float32, quantize=True)
    assert pred.quantized
    _assert_port_int8_serves_like_jax(four, pred.embed(four["tiles"]))


def test_jax_artifact_serves_from_port(four):
    pred = port.from_serving_artifact(
        port.DuoFormer(**CFG, num_layers=4).eval(), four["jax_path"],
        device="cpu", dtype=torch.float32)
    assert pred.quantized
    _assert_port_int8_serves_like_jax(four, pred.embed(four["tiles"]))


def test_port_artifact_serves_from_jax(four):
    """The JAX package reads the port's 4-scale int8 artifact and serves it
    as its own int8 Predictor does (one pyramid, the same codes)."""
    assert four["meta"]["model"] == META_MODEL
    assert four["meta"]["quantized"]
    _assert_embed_close(four["jax_reads_port"], four["int8"], four["bias"],
                        E2E_REL_TOL)


def test_artifact_num_layers_mismatch_raises(four):
    with pytest.raises(ValueError, match="num_layers"):
        port.from_serving_artifact(
            port.DuoFormer(**CFG, num_layers=3).eval(), four["jax_path"],
            device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# 5. What is not ported yet raises
# ---------------------------------------------------------------------------

def _s86_attention_args(S=86):
    C = 256
    x, v = torch.randn(2, S, C), torch.zeros(C)
    return (x, v, v, torch.zeros(C, 3 * C), torch.zeros(3 * C),
            torch.zeros(C, C), v, 4, S, 0.125)


@pytest.mark.parametrize("flags", [
    dict(gamma=torch.ones(256)), dict(attn_drop=0.1, seed=1),
    dict(proj_drop=0.1, seed=1)])
def test_reg_flags_refused_past_86_tokens(flags):
    """The reg flags run up to 86 tokens a segment (held to JAX in
    tests/test_torch_port_reg_scales.py) and raise beyond."""
    with pytest.raises(NotImplementedError, match="seg_len 87"):
        fa.fused_attention_residual(*_s86_attention_args(87), **flags)
    fa.fused_attention_residual(*_s86_attention_args(86), **flags)


@pytest.mark.parametrize("dw", [False, True])
def test_backward_refused_past_197_tokens(dw):
    """The backward, both forms, takes up to 197 tokens a segment (held to
    JAX in tests/test_torch_port_scales_train.py and
    tests/test_torch_port_vit.py) and refuses more, in the wrapper and
    through the autograd entry (whose forward refuses first)."""
    x, *rest = _s86_attention_args(198)
    lns, lnb, wqkv, bqkv, wproj = rest[:5]
    with pytest.raises(NotImplementedError, match="seg_len 198"):
        fa.fused_attention_residual_bwd(x, x, lns, lnb, wqkv, bqkv, wproj,
                                        4, 198, 0.125, dw=dw)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="seg_len 198"):
        fa.attention_residual(xg, lns, lnb, wqkv, bqkv, wproj, rest[5], 4,
                              198, 0.125, bwd_dw=dw)
    y = fa.attention_residual(xg[:, :197], lns, lnb, wqkv, bqkv, wproj,
                              rest[5], 4, 197, 0.125, bwd_dw=dw)
    y.sum().backward()
    assert xg.grad.shape == x.shape


def test_forward_refused_past_197_tokens():
    """The forward takes up to 197 tokens a segment and refuses more, on
    either device (here the CPU's plain version)."""
    with pytest.raises(NotImplementedError, match="seg_len 198"):
        fa.fused_attention_residual(*_s86_attention_args(198))
    assert fa.fused_attention_residual(
        *_s86_attention_args(197)).shape == (2, 197, 256)


def test_block_diag_attention_refused_past_197_tokens():
    qkv = torch.randn(2, 198, 3 * 256)
    with pytest.raises(NotImplementedError, match="seg_len 198"):
        fa.block_diag_attention(qkv, 4, 198, 0.125)
    assert fa.block_diag_attention(qkv[:, :197], 4, 197, 0.125).shape == (
        2, 197, 256)


@pytest.mark.parametrize("kwargs", [
    dict(num_layers=1), dict(num_layers=5)])
def test_unported_scale_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        port.DuoFormer(**{**CFG, **kwargs})


def test_legacy_family_keeps_2_scales():
    with pytest.raises(ValueError, match="num_layers=2"):
        port.DuoFormerLegacy(**CFG, num_layers=4)
