"""The port's float32 forms (the JAX package's dtype float32) on the CPU:
what the other port tests do not already hold.

Already held elsewhere, and not repeated here:
  * the float32 plain twins against the Pallas kernels in interpret mode
    at 3e-5: tests/test_torch_port_kernels.py,
    test_fused_attention_residual_matches_pallas (#1, S=6 and bare S=50),
    test_fused_mlp_residual_matches_pallas (#2),
    test_attention_bwd_plain_matches_pallas (#4, dw=False, S=6 and bare
    S=50) and test_mlp_dz_and_z_plain_match_pallas (#6 and #3's z);
  * the whole slice against JAX in float32: the Predictor
    (tests/test_torch_port_model.py, the module fixture's float32
    Predictor.embed against JAX's, and tests/test_torch_port_scales.py,
    test_model_matches_jax_in_float32 at 3 and 4 scales) and the training
    step (tests/test_torch_port_train.py, make_train_step(dtype=float32)
    against JAX's step over 3 steps).

Here: (a) #1 and #4 at S=22 (the 3-scale release model's segments), full
form, at a segment count ragged against the JAX kernels' float32 row
tiles (_f32_shrink: 2 segments a tile forward, 4 backward), at 3e-5 as
the kernels file holds them; (b) the float32 entry points' TF32 scope;
(c) the refusal helper ops/_build.f32_form, which needs no tensor.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from duoformer_tcga_tpu.ops import pallas_attention as pa

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.inference import Predictor
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops._build import f32_form

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=3e-5, rtol=3e-5)
N_SEG, S, C, H = 7, 22, 128, 2


def _randn(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _inputs(seed):
    """x, g and weights that spread the scores ~2 units, as
    tests/test_torch_port_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    return (_randn(rng, N_SEG, S, C), _randn(rng, N_SEG, S, C),
            (_randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1),
             _randn(rng, C, 3 * C, std=1.5 * C ** -0.5),
             _randn(rng, 3 * C, std=0.1), _randn(rng, C, C, std=C ** -0.5),
             _randn(rng, C, std=0.1)))


def test_attention_s22_matches_pallas_float32():
    x, _, w = _inputs(20)
    scale = (C // H) ** -0.5
    ref = pa.fused_attention_residual(*(jnp.asarray(a) for a in (x, *w)),
                                      H, S, scale, 1e-6, True, True)
    out = fa.fused_attention_residual(*(torch.from_numpy(a)
                                        for a in (x, *w)), H, S, scale, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attention_bwd_s22_matches_pallas_float32(monkeypatch):
    """Every output of the dw=False backward; the row tensors of the
    Pallas side carry padded rows past n_seg * S, cut off; the column sums
    in units of their RMS (hundreds of terms summed in another order)."""
    monkeypatch.setenv("DUOFORMER_PALLAS_BWD", "1")
    x, g, w = _inputs(21)
    w = w[:-1]                                 # bproj: no backward input
    scale = (C // H) ** -0.5
    ref = pa._fused_block_bwd_impl(*(jnp.asarray(a) for a in (x, g, *w)),
                                   H, S, scale, 1e-6, True, True)
    out = fa.fused_attention_residual_bwd(
        *(torch.from_numpy(a) for a in (x, g, *w)), H, S, scale, 1e-6)
    rows = N_SEG * S
    names = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj")
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r)
        if name in ("ln", "attn", "dqkv"):
            r = r[:rows]
        unit = (np.sqrt(np.mean(np.square(r))) or 1.0) if r.ndim == 1 else 1.0
        np.testing.assert_allclose(o.numpy() / unit, r / unit, err_msg=name,
                                   **TOL)


@pytest.fixture
def tf32_on():
    """Both TF32 flags True (PyTorch's cuDNN default), put back after."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = True
    yield
    mm.allow_tf32, dnn.allow_tf32 = saved


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_float32_entry_points_scope_tf32(tf32_on):
    """A float32 training step, float32 Predictor calls and a bf16
    Predictor call, each seen from inside by a forward hook: TF32 off
    inside the float32 ones, untouched by the bf16 one, and both flags
    True again after every call."""
    model = port.build_model_no_extra_params(
        depth=1, embed_dim=128, proj_dim=128, num_heads=2, device="cpu")
    seen = []
    model.transformer.register_forward_hook(
        lambda *_: seen.append(_flags()))
    tiles = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                              dtype=np.uint8)
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-4, 10),
                                1e-4, ttrain.backbone_frozen_labels)
    step = ttrain.make_train_step(model, dtype=torch.float32)
    step(ttrain.init_train_state(model, opt),
         {"image": tiles, "label": np.array([0, 1])})
    assert seen == [(False, False)] and _flags() == (True, True)
    pred = Predictor(model, device="cpu", dtype=torch.float32)
    pred(tiles[:1])
    pred.embed(tiles[:1])
    pred.predict_proba(tiles[:1])
    assert seen[1:] == [(False, False)] * 3 and _flags() == (True, True)
    bf16 = Predictor(copy.deepcopy(model), device="cpu",
                     dtype=torch.bfloat16, fold=False)
    bf16(tiles[:1])
    assert seen[4:] == [(True, True)] and _flags() == (True, True)


def test_float32_scope_keeps_the_matmul_precision_readable():
    """A caller that sets the TF32 flags around a float32 entry point
    (as chip_smoke.py does) can still read torch's float32 matmul
    precision afterwards: the scope touches the two flags only (torch
    refuses the read once a process has mixed them with
    set_float32_matmul_precision)."""
    from duoformer_tcga_tpu_torch._device import float32_precision
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        with float32_precision(torch.float32):
            assert not mm.allow_tf32
        assert mm.allow_tf32
        mm.allow_tf32 = False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        mm.allow_tf32 = saved


PORTED = ("fused_attention_residual", "fused_mlp_residual",
          "fused_mlp_residual_z", "fused_attention_residual_bwd", "mlp_dz")


@pytest.mark.parametrize("what", PORTED)
@pytest.mark.parametrize("C_", [256, 512, 768])
def test_f32_form_names_the_ported_forms(what, C_):
    assert f32_form(what, 64, C_) == what + "_f32"
    assert f32_form(what, 6, C_) == what + "_f32"


@pytest.mark.parametrize("what,kwargs", [
    ("fused_attention_residual", dict(seg_len=65)),      # S=86 core, proj
    ("fused_attention_residual", dict(seg_len=86)),
    ("fused_attention_residual", dict(seg_len=197)),     # the ViTs
    ("fused_attention_residual", dict(seg_len=6, reg=True)),  # legacy, R4r
    ("fused_mlp_residual", dict(reg=True)),
    ("fused_mlp_residual_z", dict(reg=True)),
    ("fused_attention_residual_bwd", dict(seg_len=6, reg=True)),
    ("fused_attention_residual_bwd", dict(seg_len=6, dw=True)),  # lean
    ("fused_attention_residual_bwd", dict(seg_len=86)),
    ("fused_attention_residual_bwd", dict(seg_len=197)),
    ("attention_core_s86", dict(seg_len=86)),
    ("attention_core_long", dict(seg_len=197)),
    ("attention_proj", {}),
    ("fused_mlp_bwd", {}),                               # #5, lean
    ("fused_layernorm", {}),                             # #11
    ("block_diag_attention", dict(seg_len=6)),           # #10
    ("fused_attention_residual", dict(seg_len=50, C=384)),   # R50ViT
    ("fused_mlp_residual", dict(C=384)),
    ("mlp_dz", dict(C=384)),
    ("fused_mlp_residual", dict(C=1024)),
    ("fused_attention_residual_bwd", dict(seg_len=6, C=128)),
])
def test_f32_form_refuses_the_rest(what, kwargs):
    with pytest.raises(NotImplementedError, match="B5a"):
        f32_form(what, **kwargs)


def test_float32_wrappers_on_the_cpu_run_the_plain_versions():
    """On the CPU a float32 tensor takes the plain version, whatever
    f32_form would refuse on the card (S=86, the dw form)."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(_randn(rng, 2, 86, C))
    w = [torch.from_numpy(a) for a in _inputs(23)[2][:5]]
    scale = (C // H) ** -0.5
    out = fa.fused_attention_residual_bwd(x, x, *w, H, 86, scale, dw=True)
    ref = fa.fused_attention_residual_bwd_plain(x, x, *w, H, 86, scale,
                                                dw=True)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
