"""The PyTorch port's 2-scale DuoFormer against the JAX package, end to
end on the CPU in float32.

One JAX DuoFormer (depth 2, C=128, 2 heads) is initialised from
PRNGKey(0), folded, and loaded into the port with load_jax_params. The
JAX side runs its Pallas kernels (interpret mode) with
DUOFORMER_FUSED_ATTN=1 and DUOFORMER_MEGAFUSE=1; the port runs the plain
versions of its kernels. More than the logits is compared: at random init
the residual-free patch chain attenuates its input, so the logits alone
say little. Bar: atol = rtol = 1e-4, the repo's parity bar
(tests/test_parity.py:19-29).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu.data import pipeline as jpipeline
from duoformer_tcga_tpu.inference import Predictor as JaxPredictor
from duoformer_tcga_tpu.models import regroup as jregroup
from duoformer_tcga_tpu.models.duoformer import (
    DuoFormer as JaxDuoFormer, count_parameters as jax_count_parameters,
    fold_for_inference as jax_fold)
from duoformer_tcga_tpu.models.transformer import scale_block_apply

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch.inference import Predictor
from duoformer_tcga_tpu_torch.utils.convert import load_jax_params

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(depth=2, embed_dim=128, num_heads=2, proj_dim=128,
           num_classes=3, num_layers=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_scale_stack(jmodel, params, x):
    """The JAX transformer input and scale stack, block by block."""
    feats = jmodel.features(params, x)
    B = x.shape[0]
    token = jnp.broadcast_to(params["scale_token"], (B, 49, 1, 128))
    proj = jmodel.projection.apply(
        params["projection"], {s: feats[s] for s in jmodel.projection.stages})
    tokens = jnp.concatenate(
        [token, jregroup.regroup(proj, jregroup.stages_for(2))], axis=2)
    tp = params["transformer"]
    h = tokens + tp["pos_embed_for_scale"]
    for i in range(CFG["depth"]):
        blk = jax.tree.map(lambda a: a[i], tp["scale_blocks"])
        h = scale_block_apply(blk, h, CFG["num_heads"], apply_qk_norm=False)
    return feats, tokens, h


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setenv("DUOFORMER_FUSED_ATTN", "1")
    mp.setenv("DUOFORMER_MEGAFUSE", "1")
    try:
        jmodel = JaxDuoFormer(**CFG)
        raw = jmodel.init(jax.random.PRNGKey(0))
        folded = jax_fold(raw)
        tiles = np.random.default_rng(0).integers(
            0, 256, (2, 224, 224, 3), dtype=np.uint8)
        x = jpipeline.preprocess_tiles(jnp.asarray(tiles), dtype=jnp.float32)
        j_feats, j_tokens, j_scale = _jax_scale_stack(jmodel, folded, x)
        j_logits, j_cls = JaxPredictor(jmodel, raw,
                                       dtype=jnp.float32).embed(tiles)
    finally:
        mp.undo()

    tmodel = port.DuoFormer(**CFG).eval()
    load_jax_params(tmodel, _np_tree(folded))
    tx = torch.from_numpy(np.array(x))
    with torch.no_grad():
        t_feats = tmodel.features(tx)
        t_scale = tmodel.transformer.scale_stack(tmodel.tokens(t_feats))
        t_scale_same_in = tmodel.transformer.scale_stack(
            torch.from_numpy(np.array(j_tokens)))
    pred = Predictor(tmodel, device="cpu", dtype=torch.float32)
    t_logits, t_cls = pred.embed(tiles)
    return dict(j_feats=j_feats, j_scale=j_scale, j_logits=j_logits,
                j_cls=j_cls, t_feats=t_feats, t_scale=t_scale,
                t_scale_same_in=t_scale_same_in,
                t_logits=t_logits, t_cls=t_cls, pred=pred, tiles=tiles,
                raw=raw, tmodel=tmodel)


def _assert_close_in_rms_units(out, ref):
    rms = float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out / rms, ref / rms, **TOL)


@pytest.mark.parametrize("stage", ["0", "1", "2", "3"])
def test_backbone_pyramid_matches_jax(pair, stage):
    """At random init the un-normalised ResNet stages grow to O(10-100),
    where float32 sums taken in another order differ by more than 1e-4
    absolute; each stage is compared in units of its own RMS."""
    _assert_close_in_rms_units(
        pair["t_feats"][stage].permute(0, 2, 3, 1).numpy(),
        np.asarray(pair["j_feats"][stage]))


def test_scale_stack_matches_jax(pair):
    """On the JAX stack's own input, at the bar; end to end (carrying the
    pyramid's float32 differences), in units of the output's RMS."""
    ref = np.asarray(pair["j_scale"])
    np.testing.assert_allclose(pair["t_scale_same_in"].numpy(), ref, **TOL)
    _assert_close_in_rms_units(pair["t_scale"].numpy(), ref)


def test_cls_embedding_matches_jax(pair):
    """At random init the patch chain shrinks the CLS to an RMS of about
    1e-4, the size of the bar itself, so it is compared in units of its
    RMS."""
    _assert_close_in_rms_units(pair["t_cls"].numpy(), np.asarray(pair["j_cls"]))


def test_cls_comparison_sees_a_patch_stack_fault(pair):
    """A 10% error in one patch block's proj, which an absolute 1e-4 bar
    cannot see at this CLS size, fails the comparison in RMS units."""
    faulty = copy.deepcopy(pair["tmodel"])
    with torch.no_grad():
        faulty.transformer.patch_blocks[0].attn.proj.w.mul_(1.1)
        _, cls = faulty(pair["pred"].prepare(pair["tiles"]),
                        with_embedding=True)
    ref = np.asarray(pair["j_cls"])
    np.testing.assert_allclose(cls.numpy(), ref, **TOL)
    with pytest.raises(AssertionError):
        _assert_close_in_rms_units(cls.numpy(), ref)


def test_predictor_logits_match_jax_predictor(pair):
    """The logits are mostly the head's bias at random init: they are held
    at the bar, and what the model adds to the bias in units of its RMS."""
    logits = pair["pred"](pair["tiles"])
    ref = np.asarray(pair["j_logits"])
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)
    bias = np.asarray(pair["raw"]["transformer"]["head"]["b"])
    _assert_close_in_rms_units(logits.numpy() - bias, ref - bias)
    np.testing.assert_allclose(pair["t_logits"].numpy(), logits.numpy(),
                               atol=0, rtol=0)


def test_predict_proba_is_softmax_of_logits(pair):
    probs = pair["pred"].predict_proba(pair["tiles"])
    ref = jax.nn.softmax(jnp.asarray(pair["j_logits"]), axis=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(NotImplementedError):
        pair["pred"].predict_proba(pair["tiles"], tta=True)


def test_parameter_count_matches_jax(pair):
    _, jax_total = jax_count_parameters(pair["raw"])
    _, total = port.count_parameters(port.DuoFormer(**CFG))
    assert total == pytest.approx(jax_total, abs=1e-9)


@pytest.mark.parametrize("kwargs", [
    dict(num_layers=1), dict(backbone="r18"), dict(remat=True),
])
def test_unported_options_raise(kwargs):
    """(The channel scale token, 3 and 4 scales and attn_drop_rate > 0,
    once refused here, are held to the JAX package in
    tests/test_torch_port_reg.py, tests/test_torch_port_scales.py and
    tests/test_torch_port_reg_scales.py.)"""
    with pytest.raises(NotImplementedError):
        port.build_model_no_extra_params(
            **{**CFG, **kwargs, "device": "cpu"})


def test_load_rejects_unfolded_tree_into_folded_model(pair):
    with pytest.raises(ValueError):
        load_jax_params(pair["tmodel"], _np_tree(pair["raw"]))
