"""The PyTorch port's int8 (a8w8) serving path and serving artifact
against the JAX package, on the CPU.

The port's int8 entries run their plain versions here (CPU tensors); the
JAX side runs its int8 Pallas kernels in interpret mode, as
tests/test_int8.py does. Inputs come from numpy and go to both sides
unchanged. Bars:
  * weight codes and row quantization: bit for bit (scales to 1e-7);
  * the int8 kernel functions: relative L2 error of the branch (output
    less residual) <= 1e-3. A wrong row scale, a per-chunk scale or a
    skipped dequantization factor moves the branch by far more; scattered
    +-1 code flips from float32 summation order stay far below it;
  * the transformer on identical tokens: the CLS at 1e-3 in units of its
    RMS, elementwise;
  * Predictor and artifacts end to end: the RMS of the difference in units
    of the reference's RMS, for the CLS and the logits less the head bias:
    1e-2 where both sides run one pyramid or no int8 (the float32
    artifacts; the JAX package reading the port's int8 artifact).
    Where the port's pyramid meets JAX's int8 stack the two pyramids differ
    by float32 summation order (1.7e-6 relative in the tokens, as
    tests/test_torch_port_model.py found), and int8 turns that into code
    flips that compound: under 1.7e-6 relative noise on its tokens the
    int8 stack's CLS moves by 4e-3 to 1.4e-2 (the logits less the bias by
    up to 2.0e-2), a large part of its 1.4e-2 to 2.0e-2 distance from the
    float32 stack (test_int8_stack_conditioning). No implementation can
    meet 1e-2 there, so those cases hold the end-to-end output at 5e-2,
    which a wrong scale or a skipped dequantization exceeds many times
    over, and the port's CLS against the JAX int8 stack on the port's own
    tokens at the 1e-3 bar: everything after the pyramid agrees.
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
from duoformer_tcga_tpu.models.duoformer import (
    DuoFormer as JaxDuoFormer, fold_for_inference as jax_fold)
from duoformer_tcga_tpu.ops import pallas_attention as pa
from duoformer_tcga_tpu.ops import quantize as jq

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch.ops import _build
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import fused_int8 as fi
from duoformer_tcga_tpu_torch.ops import quantize as tq
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

KERNEL_REL_TOL = 1e-3
STACK_TOL = 1e-3
E2E_REL_TOL = 1e-2
INT8_E2E_REL_TOL = 5e-2
CFG = dict(depth=2, embed_dim=128, num_heads=2, proj_dim=128,
           num_classes=3, num_layers=2)
META_MODEL = dict(family="duoformer", depth=2, embed_dim=128, proj_dim=128,
                  num_heads=2, num_classes=3, num_layers=2, num_patches=49,
                  mlp_ratio=4.0, scale_token="random", backbone="r50",
                  patch_attn=True, init_values=None, apply_fc_norm=False)


def _randn(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _branch_rel_err(out, ref, residual=None):
    ref = np.asarray(ref, np.float64)
    branch = ref if residual is None else ref - residual
    return np.linalg.norm(np.asarray(out, np.float64) - ref) / \
        np.linalg.norm(branch)


def _assert_close_in_rms_units(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    rms = float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out / rms, ref / rms, atol=tol, rtol=tol)


def _ties_weight(rng):
    """[64, 32] weights with an all-zero column (scale 1) and a column of
    exact ties: amax 127/16 makes its scale exactly 1/16, and every other
    entry is (k + 0.5)/16."""
    w = _randn(rng, 64, 32, std=0.05)
    w[:, 3] = 0.0
    w[:, 5] = (rng.integers(-126, 126, 64) + 0.5) / 16
    w[0, 5] = 127 / 16
    return w


# ---------------------------------------------------------------------------
# 1-2. Codes
# ---------------------------------------------------------------------------

def test_quantize_weight_matches_jax():
    w = _ties_weight(np.random.default_rng(0))
    w_q, s = tq.quantize_weight(torch.from_numpy(w))
    jw_q, js = jq.quantize_weight(jnp.asarray(w))
    assert w_q.dtype == torch.int8
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert s[3] == 1.0 and not w_q[:, 3].any()
    # half to even, as jnp.round: 63 of the tie column's codes are ties
    ties = torch.from_numpy(w[1:, 5] * 16)
    assert torch.equal(w_q[1:, 5].float(), torch.round(ties))
    assert not torch.equal(w_q[1:, 5].float(), fi.round_half_away(ties))


def test_rowquant_matches_jax_bit_for_bit():
    """Values on exact k + 0.5 multiples of the row scale (1/8), of both
    signs, where half-away-from-zero and half-to-even differ, and
    0.49999997 of the scale, where sign(v) * floor(|v| + 0.5) gives 1."""
    rng = np.random.default_rng(1)
    ties = (np.arange(-127, 127) + 0.5) / 8
    row = np.concatenate([ties, [127 / 8, -127 / 8, 0.49999997 / 8,
                                 -0.49999997 / 8]]).astype(np.float32)
    v = np.stack([row, -row[::-1], _randn(rng, row.size, std=3.0),
                  np.zeros_like(row)])
    q, s = fi.rowquant_plain(torch.from_numpy(v))
    jq_, js = pa._rowquant(jnp.asarray(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0] == 1 / 8 and s[3, 0] == 1.0
    assert q[0, 0] == -127 and q[0, -4] == 127 and q[0, -2] == 0
    half_even = torch.round(torch.from_numpy(row) * 8)
    assert int((half_even != q[0].float()).sum()) >= 100


# ---------------------------------------------------------------------------
# 3-4. The int8 kernel functions
# ---------------------------------------------------------------------------

def _port_w(jw_q):
    """JAX int8 [in, out] -> the port's [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(jw_q).T))


@pytest.mark.parametrize("n_seg,S,H,bare", [
    (13, 6, 2, False),     # ScaleBlock form, ragged
    (42, 6, 8, False),     # 8 heads of 16, as tests/test_int8.py
    (4, 50, 2, True),      # PatchBlock bare form
    (3, 50, 8, True),
])
def test_fused_attention_residual_int8_matches_pallas(n_seg, S, H, bare):
    rng = np.random.default_rng(2)
    C = 128
    x = _randn(rng, n_seg, S, C)
    if bare:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    else:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    jwq, jsq = jq.quantize_weight(jnp.asarray(
        _randn(rng, C, 3 * C, std=1.5 * C ** -0.5)))
    jwp, jsp = jq.quantize_weight(jnp.asarray(_randn(rng, C, C,
                                                     std=C ** -0.5)))
    bqkv, bproj = _randn(rng, 3 * C, std=0.01), _randn(rng, C, std=0.01)
    scale = (C // H) ** -0.5
    ref = pa.fused_attention_residual_int8(
        jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb), jwq, jsq,
        jnp.asarray(bqkv), jwp, jsp, jnp.asarray(bproj), H, S, scale, 1e-6,
        not bare, not bare)
    t = torch.from_numpy
    out = fi.fused_attention_residual_int8(
        t(x), t(lns), t(lnb), _port_w(jwq), t(np.array(jsq)), t(bqkv),
        _port_w(jwp), t(np.array(jsp)), t(bproj), H, S, scale, 1e-6,
        not bare, not bare)
    assert out.shape == x.shape
    err = _branch_rel_err(out.numpy(), ref, None if bare else x)
    assert err <= KERNEL_REL_TOL, err


@pytest.mark.parametrize("use_residual", [True, False])
def test_fused_mlp_residual_int8_matches_pallas(use_residual):
    rng = np.random.default_rng(3)
    C, hidden = 128, 512
    x = _randn(rng, 37, 6, C)
    lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    jw1, js1 = jq.quantize_weight(jnp.asarray(_randn(rng, C, hidden,
                                                     std=C ** -0.5)))
    jw2, js2 = jq.quantize_weight(jnp.asarray(
        _randn(rng, hidden, C, std=hidden ** -0.5)))
    b1, b2 = _randn(rng, hidden, std=0.01), _randn(rng, C, std=0.01)
    ref = pa.fused_mlp_residual_int8(
        jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb), jw1, js1,
        jnp.asarray(b1), jw2, js2, jnp.asarray(b2), 1e-6, use_residual)
    t = torch.from_numpy
    out = fi.fused_mlp_residual_int8(
        t(x), t(lns), t(lnb), _port_w(jw1), t(np.array(js1)), t(b1),
        _port_w(jw2), t(np.array(js2)), t(b2), 1e-6, use_residual)
    err = _branch_rel_err(out.numpy(), ref, x if use_residual else None)
    assert err <= KERNEL_REL_TOL, err


def test_int8_plain_product_is_exact():
    """|acc| past 2^24 (127^2 * 3072): the plain product is the exact
    integer sum, rounded once to float32 as the kernels' (float)acc."""
    g = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (4, 3072), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (5, 3072), generator=g).to(torch.int8)
    a[0], w[0] = 127, 127
    w[1] = 127
    w[1, 0] = 126
    exact = a.long() @ w.long().t()
    assert exact[0, 0] == 127 * 127 * 3072 and exact[0, 1] > 2 ** 24
    assert torch.equal(fi.int8_matmul_plain(a, w), exact.float())


# ---------------------------------------------------------------------------
# 5-6. The model, the Predictor and the artifacts
# ---------------------------------------------------------------------------

def _port_tokens(folded, tiles):
    """The port's transformer input for the tiles (its own pyramid, in
    float32, from the folded JAX weights)."""
    model = port.DuoFormer(**CFG).eval()
    load_jax_params(model, _np_tree(folded))
    pred = port.Predictor(model, device="cpu", dtype=torch.float32,
                          fold=False)
    with torch.no_grad():
        return model.tokens(model.features(pred.prepare(tiles))).numpy()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Everything the JAX package computes, under its fused-kernel flags:
    the transformer on seeded tokens from the quantized tree, the int8 and
    float32 Predictors' embed() on two tiles, both artifacts, and its
    reading of the port's artifacts (written by port_side first)."""
    tmp = tmp_path_factory.mktemp("int8")
    mp = pytest.MonkeyPatch()
    mp.setenv("DUOFORMER_FUSED_ATTN", "1")
    mp.setenv("DUOFORMER_MEGAFUSE", "1")
    try:
        jmodel = JaxDuoFormer(**CFG)
        # seeded weights, made by the port (JAX's eager init of the
        # ResNet-50 takes 20 s here) and handed over in the JAX layout
        raw = jax.tree.map(jnp.asarray, export_jax_params(port.DuoFormer(
            **CFG, generator=torch.Generator().manual_seed(0))))
        folded = jax_fold(raw)
        qtree = jq.quantize_attention_weights(jq.quantize_mlp_weights(folded))
        rng = np.random.default_rng(4)
        tokens = _randn(rng, 2, 49, 6, 128)
        tiles = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
        stack = jax.jit(lambda p, t: jmodel.transformer.apply(
            p, t, with_embedding=True))
        _, stack_cls = stack(qtree["transformer"], jnp.asarray(tokens))
        _, port_tokens_cls = stack(qtree["transformer"], jnp.asarray(
            _port_tokens(folded, tiles)))
        int8 = JaxPredictor(jmodel, raw, dtype=jnp.float32,
                            quantize=True).embed(tiles)
        f32 = JaxPredictor(jmodel, raw, dtype=jnp.float32).embed(tiles)
        paths = {q: str(tmp / f"jax_{q}.npz") for q in ("int8", "f32")}
        for q, path in paths.items():
            jax_export_artifact(path, raw, {"model": META_MODEL},
                                quantize=q == "int8")
    finally:
        mp.undo()
    return dict(jmodel=jmodel, raw=raw, folded=folded, qtree=qtree,
                tokens=tokens, tiles=tiles, stack_cls=stack_cls,
                port_tokens_cls=port_tokens_cls, int8=int8,
                f32=f32, paths=paths, tmp=tmp,
                bias=np.asarray(raw["transformer"]["head"]["b"]))


def _jax_reads(side, path):
    """The JAX package's from_serving_artifact of `path`, embed() on the
    tiles, under its fused-kernel flags."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DUOFORMER_FUSED_ATTN", "1")
    mp.setenv("DUOFORMER_MEGAFUSE", "1")
    try:
        return jax_from_artifact(side["jmodel"], path,
                                 dtype=jnp.float32).embed(side["tiles"])
    finally:
        mp.undo()


def _port_model(side, tree="folded"):
    model = port.DuoFormer(**CFG).eval()
    load_jax_params(model, _np_tree(side[tree]))
    return model


def _rel_l2(out, ref):
    """The RMS of out - ref in units of ref's RMS."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / np.linalg.norm(ref)


def _assert_embed_close(out, ref, bias, tol=E2E_REL_TOL):
    (logits, cls), (j_logits, j_cls) = out, ref
    e_cls = _rel_l2(cls, j_cls)
    e_logits = _rel_l2(np.asarray(logits) - bias, np.asarray(j_logits) - bias)
    assert e_cls <= tol and e_logits <= tol, (e_cls, e_logits)


def _assert_port_int8_serves_like_jax(side, out):
    """The port's int8 embed() against the JAX int8 Predictor (two
    pyramids, int8 after them) and against the JAX int8 stack on the
    port's own tokens (one pyramid)."""
    _assert_embed_close(out, side["int8"], side["bias"], INT8_E2E_REL_TOL)
    _assert_close_in_rms_units(np.asarray(out[1]), side["port_tokens_cls"],
                               STACK_TOL)


def test_quantize_model_codes_match_jax(jax_side):
    """The port's quantize_model_ of the float32 folded weights, exported
    in the JAX layout, gives JAX's codes and scales; loading JAX's
    quantized tree lands the same codes, int8 and [out, in]."""
    model = tq.quantize_model_(_port_model(jax_side))
    mine = export_jax_params(model)["transformer"]
    ref = _np_tree(jax_side["qtree"]["transformer"])
    leaves = [(stack, "attn", k) for stack in ("scale_blocks", "patch_blocks")
              for k in ("qkv", "proj")]
    leaves += [("scale_blocks", "mlp", k) for k in ("fc1", "fc2")]
    for stack, part, k in leaves:
        a, b = mine[stack][part][k], ref[stack][part][k]
        assert a["w_q"].dtype == np.int8
        np.testing.assert_array_equal(a["w_q"], b["w_q"])
        np.testing.assert_allclose(a["w_scale"], b["w_scale"], rtol=1e-7,
                                   atol=0)
        np.testing.assert_array_equal(a["b"], b["b"])
    loaded = _port_model(jax_side, "qtree")
    for a, b in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1]), a[0]
    qkv = loaded.transformer.scale_blocks[1].attn.qkv
    assert qkv.w_q.dtype == torch.int8 and qkv.w_q.shape == (384, 128)


def test_transformer_int8_matches_jax_on_same_tokens(jax_side):
    model = _port_model(jax_side, "qtree")
    with torch.no_grad():
        _, cls = model.transformer(torch.from_numpy(jax_side["tokens"]),
                                   with_embedding=True)
    _assert_close_in_rms_units(cls.numpy(), jax_side["stack_cls"], STACK_TOL)


def test_predictor_int8_matches_jax_predictor(jax_side):
    pred = port.Predictor(_port_model(jax_side), device="cpu",
                          dtype=torch.float32, quantize=True)
    out = pred.embed(jax_side["tiles"])
    _assert_port_int8_serves_like_jax(jax_side, out)
    probs = pred.predict_proba(jax_side["tiles"])
    np.testing.assert_allclose(probs.numpy(),
                               torch.softmax(out[0], -1).numpy(), rtol=1e-6)


def test_int8_stack_conditioning(jax_side):
    """Why the end-to-end int8 bar is INT8_E2E_REL_TOL: float32 noise of
    the size that separates the two pyramids (1.7e-6 relative) moves the
    float32 stack's CLS by about as much, but the int8 stack's by 1e-3 to
    INT8_E2E_REL_TOL, a large part of int8's own distance from float32."""
    f32, int8 = _port_model(jax_side), _port_model(jax_side, "qtree")
    tokens = torch.from_numpy(jax_side["tokens"])
    moved = {}
    with torch.no_grad():
        for name, model in (("f32", f32), ("int8", int8)):
            ref = model.transformer(tokens, with_embedding=True)[1]
            moved[name] = [_rel_l2(model.transformer(
                tokens * (1 + 1.7e-6 * torch.randn(
                    tokens.shape, generator=torch.Generator().manual_seed(k))),
                with_embedding=True)[1], ref) for k in range(3)]
        gap = _rel_l2(int8.transformer(tokens, with_embedding=True)[1],
                      f32.transformer(tokens, with_embedding=True)[1])
    assert max(moved["f32"]) < 1e-5, moved
    assert 1e-3 < min(moved["int8"]) and max(moved["int8"]) < \
        INT8_E2E_REL_TOL, moved
    assert max(moved["int8"]) < gap < INT8_E2E_REL_TOL, (moved, gap)


@pytest.mark.parametrize("kind", ["int8", "f32"])
def test_jax_artifact_serves_from_port(jax_side, kind):
    pred = port.from_serving_artifact(port.DuoFormer(**CFG).eval(),
                                      jax_side["paths"][kind], device="cpu",
                                      dtype=torch.float32)
    assert pred.quantized == (kind == "int8")
    out = pred.embed(jax_side["tiles"])
    if kind == "int8":
        _assert_port_int8_serves_like_jax(jax_side, out)
    else:
        _assert_embed_close(out, jax_side[kind], jax_side["bias"])


@pytest.mark.parametrize("kind", ["int8", "f32"])
def test_port_artifact_serves_from_jax(jax_side, kind):
    path = str(jax_side["tmp"] / f"port_{kind}.npz")
    meta = port.export_serving_artifact(path, _port_model(jax_side),
                                        {"step": 7}, quantize=kind == "int8")
    assert meta["model"] == META_MODEL and meta["quantized"] == (
        kind == "int8")
    params, jmeta = port.load_serving_artifact(path)
    assert jmeta["lists"] == meta["lists"] and jmeta["step"] == 7
    _assert_embed_close(_jax_reads(jax_side, path), jax_side[kind],
                        jax_side["bias"])


@pytest.mark.parametrize("field,value", [("num_heads", 4),
                                         ("apply_fc_norm", True)])
def test_artifact_meta_mismatch_raises(jax_side, field, value):
    path = str(jax_side["tmp"] / f"mismatch_{field}.npz")
    port.export_serving_artifact(path, _port_model(jax_side),
                                 {"model": {**META_MODEL, field: value}},
                                 quantize=True)
    with pytest.raises(ValueError, match=field):
        port.from_serving_artifact(port.DuoFormer(**CFG).eval(), path,
                                   device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# 7. Refusals
# ---------------------------------------------------------------------------

def _attention_args(requires_grad=False):
    """Arguments the kernel takes (C=256, 4 heads of 64), x in float32."""
    C = 256
    x = torch.randn(3, 6, C, requires_grad=requires_grad)
    v, w = torch.zeros(C), torch.zeros(C, C, dtype=torch.int8)
    return (x, v, v, torch.zeros(3 * C, C, dtype=torch.int8),
            torch.ones(3 * C), torch.zeros(3 * C), w, torch.ones(C), v, 4, 6,
            0.125)


def _mlp_args(requires_grad=False):
    C, hidden = 256, 512
    x = torch.randn(18, C, requires_grad=requires_grad)
    v = torch.zeros(C)
    return (x, v, v, torch.zeros(hidden, C, dtype=torch.int8),
            torch.ones(hidden), torch.zeros(hidden),
            torch.zeros(C, hidden, dtype=torch.int8), torch.ones(C), v)


def test_int8_wrappers_refuse_autograd():
    with pytest.raises(RuntimeError, match="no backward"):
        fi.fused_attention_residual_int8(*_attention_args(True))
    with pytest.raises(RuntimeError, match="no backward"):
        fi.fused_mlp_residual_int8(*_mlp_args(True))
    with torch.no_grad():
        fi.fused_attention_residual_int8(*_attention_args(True))
        fi.fused_mlp_residual_int8(*_mlp_args(True))


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrappers'
    CUDA branch on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_int8_wrappers_never_fall_back(monkeypatch, tmp_path):
    """A CUDA tensor whose kernel cannot be built raises; the plain
    version never runs in its place, and nothing is counted."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fi, "fused_attention_residual_int8_plain", None)
    monkeypatch.setattr(fi, "fused_mlp_residual_int8_plain", None)

    def on_card(args):
        args = list(args)
        args[0] = args[0].contiguous().to(torch.bfloat16)
        return [a.as_subclass(_OnTheCard) if isinstance(a, torch.Tensor)
                else a for a in args]

    fa.reset_launch_counts()
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        fi.fused_attention_residual_int8(*on_card(_attention_args()))
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        fi.fused_mlp_residual_int8(*on_card(_mlp_args()))
    x = torch.empty(2, 6, 256, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fi.fused_attention_residual_int8(x, *_attention_args()[1:])
    assert sum(fa.launch_counts.values()) == 0


def test_quantized_predictor_refuses_training():
    model = port.DuoFormer(**CFG)
    port.Predictor(model, device="cpu", dtype=torch.float32, quantize=True)
    with pytest.raises(RuntimeError, match="serves only"):
        model.train()
    assert not any(m.training for m in model.modules())


def test_quantize_refuses_what_it_cannot_serve():
    with pytest.raises(ValueError, match="release DuoFormer"):
        tq.quantize_model_(torch.nn.Linear(4, 4))
    model = port.DuoFormer(**CFG)
    model.transformer.scale_blocks[0].ls1 = torch.nn.Identity()
    with pytest.raises(ValueError, match="LayerScale"):
        tq.quantize_model_(model)
    bf16 = port.build_model_no_extra_params(**CFG, device="cpu",
                                            dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        tq.quantize_model_(bf16)
