"""The PyTorch port's kernel-bearing entries and ops against the JAX
package, on the CPU in float32.

The port's fused entries run their plain versions here (CPU tensors);
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_attention.py does. Inputs come from numpy and go to
both sides unchanged. Bars: 3e-5 for the fused entries and the regroup
(the bar of test_pallas_attention.py:90), 1e-5 for single ops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu.models import regroup as jregroup
from duoformer_tcga_tpu.ops import attention as jattn
from duoformer_tcga_tpu.ops import nn as jnn
from duoformer_tcga_tpu.ops import pallas_attention as pa

from duoformer_tcga_tpu_torch.models import regroup as tregroup
from duoformer_tcga_tpu_torch.ops import attention as tattn
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import nn as tnn

TOL = dict(atol=3e-5, rtol=3e-5)


def _randn(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", [
    (98, 6, 128, 2, True, True),       # ScaleBlock form, ragged TPU tiles
    (4, 50, 128, 2, False, False),     # PatchBlock bare form
    (13, 6, 128, 2, True, True),       # odd segment count
])
def test_fused_attention_residual_matches_pallas(n_seg, S, C, H, use_ln,
                                                 use_residual):
    rng = np.random.default_rng(0)
    x = _randn(rng, n_seg, S, C)
    if use_ln:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    else:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    arrays = (x, lns, lnb, _randn(rng, C, 3 * C, std=0.02),
              _randn(rng, 3 * C, std=0.01), _randn(rng, C, C, std=0.02),
              _randn(rng, C, std=0.01))
    scale = (C // H) ** -0.5
    ref = pa.fused_attention_residual(*_j(*arrays), H, S, scale, 1e-6,
                                      use_ln, use_residual)
    out = fa.fused_attention_residual(*_t(*arrays), H, S, scale, 1e-6,
                                      use_ln, use_residual)
    _close(out, ref)


def test_fused_mlp_residual_matches_pallas():
    rng = np.random.default_rng(1)
    C, hidden = 128, 512
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=0.02),
              _randn(rng, hidden, std=0.01), _randn(rng, hidden, C, std=0.02),
              _randn(rng, C, std=0.01))
    ref = pa.fused_mlp_residual(*_j(*arrays), 1e-6)
    out = fa.fused_mlp_residual(*_t(*arrays), 1e-6)
    _close(out, ref)


def test_plain_versions_keep_bf16_rounding_points():
    """In bf16 the plain attention rounds where the TPU kernel does: its
    result matches the JAX XLA twin run in bf16 to bf16 resolution."""
    rng = np.random.default_rng(2)
    n_seg, S, C, H = 10, 6, 128, 2
    arrays = (_randn(rng, n_seg, S, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, 3 * C, std=0.02),
              _randn(rng, 3 * C, std=0.01), _randn(rng, C, C, std=0.02),
              _randn(rng, C, std=0.01))
    jx = [a.astype(jnp.bfloat16) if i in (0, 3, 5) else a
          for i, a in enumerate(_j(*arrays))]
    tx = [a.to(torch.bfloat16) if i in (0, 3, 5) else a
          for i, a in enumerate(_t(*arrays))]
    scale = (C // H) ** -0.5
    ref = pa._fused_block_xla(*jx, H, S, scale, 1e-6)
    out = fa.fused_attention_residual(*tx, H, S, scale, 1e-6)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("stages", [["3", "2"], ["3", "2", "1", "0"]])
def test_regroup_matches_jax(stages):
    rng = np.random.default_rng(3)
    C = 8
    feats = {s: _randn(rng, 2, g, g, C)
             for s, g in jregroup.STAGE_GRID.items()}
    ref = jregroup.regroup({s: jnp.asarray(f) for s, f in feats.items()},
                           stages)
    ref_gather = jregroup.regroup_gather(
        {s: jnp.asarray(f) for s, f in feats.items()}, stages)
    tfeats = {s: torch.from_numpy(f) for s, f in feats.items()}
    _close(tregroup.regroup(tfeats, stages), ref)
    _close(tregroup.regroup(tfeats, stages), ref_gather)
    _close(tregroup.regroup_gather(tfeats, stages), ref_gather)


@pytest.mark.parametrize("stage", ["0", "1", "2", "3"])
def test_region_index_matches_jax(stage):
    np.testing.assert_array_equal(tregroup.region_index(stage),
                                  jregroup.region_index(stage))


def test_layernorm_gelu_and_mlp_match_jax():
    rng = np.random.default_rng(4)
    x, s, b = _randn(rng, 5, 7, 96), _randn(rng, 96), _randn(rng, 96)
    _close(tnn.layernorm(*_t(x, s, b)),
           jnn.layernorm({"scale": s, "bias": b}, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)
    _close(tnn.gelu(torch.from_numpy(x)), jnn.gelu(jnp.asarray(x)),
           atol=1e-6, rtol=1e-6)
    w1, b1 = _randn(rng, 96, 384, std=0.05), _randn(rng, 384, std=0.1)
    w2, b2 = _randn(rng, 384, 96, std=0.05), _randn(rng, 96, std=0.1)
    ref = jnn.mlp({"fc1": {"w": w1, "b": b1}, "fc2": {"w": w2, "b": b2}},
                  jnp.asarray(x))
    _close(tnn.mlp(*_t(x, w1, b1, w2, b2)), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,stride,padding,bias", [
    (7, 2, 3, False),          # the ResNet stem
    (3, 2, 1, False),          # stride-2 3x3 of a v1.5 bottleneck
    (1, 2, "VALID", False),    # downsample
    (1, 1, "VALID", True),     # projection
    (3, 2, "SAME", True),      # XLA SAME, asymmetric pad at stride 2
])
def test_conv2d_matches_jax(k, stride, padding, bias):
    rng = np.random.default_rng(5)
    x = _randn(rng, 2, 15, 15, 4)                          # NHWC
    w = _randn(rng, k, k, 4, 6, std=0.2)                   # HWIO
    b = _randn(rng, 6) if bias else None
    params = {"w": w} if b is None else {"w": w, "b": b}
    ref = jnn.conv2d(params, jnp.asarray(x), stride, padding)
    out = tnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1),
                     None if b is None else torch.from_numpy(b),
                     stride, padding)
    _close(out.permute(0, 2, 3, 1), ref, atol=1e-5, rtol=1e-5)


def test_maxpool_matches_jax():
    rng = np.random.default_rng(6)
    x = _randn(rng, 2, 13, 13, 3)
    ref = jnn.maxpool2d(jnp.asarray(x), window=3, stride=2, padding=1)
    out = tnn.maxpool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    _close(out.permute(0, 2, 3, 1), ref, atol=0, rtol=0)


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(7)
    c = 6
    bn = {"scale": _randn(rng, c), "bias": _randn(rng, c),
          "mean": _randn(rng, c), "var": np.abs(_randn(rng, c)) + 0.1}
    x = _randn(rng, 2, 5, 5, c)
    ref_fold = jnn.fold_batchnorm(bn)
    s, b = tnn.fold_batchnorm(*_t(bn["scale"], bn["bias"], bn["mean"],
                                  bn["var"]))
    _close(s, ref_fold["scale"], atol=1e-6, rtol=1e-6)
    _close(b, ref_fold["bias"], atol=1e-6, rtol=1e-6)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = jnn.batchnorm(bn, jnp.asarray(x))
    _close(tnn.affine(tx, s, b).permute(0, 2, 3, 1), ref,
           atol=1e-5, rtol=1e-5)
    _close(tnn.batchnorm(tx, *_t(bn["scale"], bn["bias"], bn["mean"],
                                 bn["var"])).permute(0, 2, 3, 1), ref,
           atol=1e-5, rtol=1e-5)


def test_multihead_attention_matches_jax_and_unfused():
    """The bare fused form (PatchBlock) against the JAX XLA composition
    and against the port's own unfused composition."""
    rng = np.random.default_rng(8)
    B, S, C, H = 3, 50, 128, 2
    attn = tattn.Attention(C, H)
    params = {"qkv": {"w": _randn(rng, C, 3 * C, std=0.02),
                      "b": _randn(rng, 3 * C, std=0.01)},
              "proj": {"w": _randn(rng, C, C, std=0.02),
                       "b": _randn(rng, C, std=0.01)}}
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(attn, name).w.copy_(torch.from_numpy(params[name]["w"]))
            getattr(attn, name).b.copy_(torch.from_numpy(params[name]["b"]))
    x = _randn(rng, B, S, C)
    ref = jattn.multihead_attention(params, jnp.asarray(x), H, fused=False)
    out = tattn.multihead_attention(attn, torch.from_numpy(x), H)
    _close(out, ref)
    _close(out, tattn.multihead_attention_unfused(
        attn, torch.from_numpy(x), H).detach().numpy())


# ---------------------------------------------------------------------------
# The training slice: backward kernels' plain versions and the autograd
# functions against the JAX package, which runs its Pallas kernels in
# interpret mode on the save-hidden path with the dz kernel on.
# ---------------------------------------------------------------------------

@pytest.fixture
def train_env(monkeypatch):
    monkeypatch.setenv("DUOFORMER_PALLAS_BWD", "1")
    monkeypatch.setenv("DUOFORMER_MLP_SAVE_HIDDEN", "1")
    monkeypatch.setenv("DUOFORMER_MLP_DZ", "1")


def _attention_inputs(rng, n_seg, S, C, use_ln):
    """x, g and weights that spread the scores ~2 units (see
    chip_smoke.py), so the softmax backward is far from uniform."""
    x, g = _randn(rng, n_seg, S, C), _randn(rng, n_seg, S, C)
    if use_ln:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    else:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    return x, g, (lns, lnb, _randn(rng, C, 3 * C, std=1.5 * C ** -0.5),
                  _randn(rng, 3 * C, std=0.1), _randn(rng, C, C,
                                                      std=C ** -0.5),
                  _randn(rng, C, std=0.1))


ATTN_SHAPES = [
    (98, 6, 128, 2, True, True),       # ScaleBlock form, ragged TPU tiles
    (4, 50, 128, 2, False, False),     # PatchBlock bare form
    (13, 6, 128, 2, True, True),       # odd segment count
]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", ATTN_SHAPES)
def test_attention_bwd_plain_matches_pallas(train_env, n_seg, S, C, H,
                                            use_ln, use_residual):
    """Each output of the backward kernel's plain version against
    _fused_block_bwd_impl (dw=False), at 3e-5; the Pallas row tensors carry
    zero-padded rows past n_seg * S, which are cut off. The four column
    sums add hundreds of terms of size ~10 in another order, so they are
    held in units of their RMS."""
    rng = np.random.default_rng(10)
    x, g, (lns, lnb, wqkv, bqkv, wproj, _) = _attention_inputs(
        rng, n_seg, S, C, use_ln)
    scale = (C // H) ** -0.5
    ref = pa._fused_block_bwd_impl(*_j(x, g, lns, lnb, wqkv, bqkv, wproj),
                                   H, S, scale, 1e-6, use_ln, use_residual)
    out = fa.fused_attention_residual_bwd(
        *_t(x, g, lns, lnb, wqkv, bqkv, wproj), H, S, scale, 1e-6, use_ln,
        use_residual)
    rows = n_seg * S
    names = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj")
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r)
        if name in ("ln", "attn", "dqkv"):
            r = r[:rows]
        unit = (np.sqrt(np.mean(np.square(r))) or 1.0) if r.ndim == 1 else 1.0
        np.testing.assert_allclose(o.numpy() / unit, r / unit, err_msg=name,
                                   **TOL)


def test_mlp_dz_and_z_plain_match_pallas(train_env):
    """The dz kernel's plain version against _mlp_dz_impl, and the z of the
    MLP kernel's plain version against _fused_mlp_impl(return_hidden=True),
    at 3e-5 (rows 222 leave the Pallas tiles ragged)."""
    rng = np.random.default_rng(11)
    rows, C, hidden = 222, 128, 512
    g2, z = _randn(rng, rows, C), _randn(rng, rows, hidden)
    w2 = _randn(rng, hidden, C, std=hidden ** -0.5)
    ref_dz, ref_db1, _ = pa._mlp_dz_impl(*_j(g2, z, w2), emit_h=False)
    dz, db1 = fa.mlp_dz(*_t(g2, z, w2))
    _close(dz, ref_dz)
    _close(db1, ref_db1)
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=C ** -0.5),
              _randn(rng, hidden, std=0.1),
              _randn(rng, hidden, C, std=hidden ** -0.5),
              _randn(rng, C, std=0.1))
    ref_out, ref_z = pa._fused_mlp_impl(*_j(*arrays), 1e-6,
                                        return_hidden=True)
    out, zt = fa.fused_mlp_residual(*_t(*arrays), 1e-6, return_hidden=True)
    _close(out, ref_out)
    _close(zt, np.asarray(ref_z)[:37 * 6])


def _close_param_grad(name, out, ref):
    """dx at the bar as it is; a parameter's cotangent, a sum over every
    row, in units of its RMS."""
    ref = np.asarray(ref)
    unit = 1.0 if name == "dx" else float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out.numpy() / unit, ref / unit, err_msg=name,
                               **TOL)


def _port_grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*leaves).backward(torch.from_numpy(g))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", ATTN_SHAPES[:2])
def test_attention_autograd_matches_jax_vjp(train_env, n_seg, S, C, H,
                                            use_ln, use_residual):
    """All 7 input cotangents of attention_residual against jax.vjp of
    pa.fused_attention_residual (its Pallas backward), at 3e-5: dx as it
    is, the parameter cotangents (sums over all rows, of size ~10-40) in
    units of their RMS."""
    rng = np.random.default_rng(12)
    x, g, weights = _attention_inputs(rng, n_seg, S, C, use_ln)
    arrays = (x, *weights)
    scale = (C // H) ** -0.5
    _, vjp = jax.vjp(lambda *a: pa.fused_attention_residual(
        *a, H, S, scale, 1e-6, use_ln, use_residual), *_j(*arrays))
    ref = vjp(jnp.asarray(g))
    got = _port_grads(lambda *a: fa.attention_residual(
        *a, H, S, scale, 1e-6, use_ln, use_residual), arrays, g)
    names = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj",
             "dbproj")
    for name, o, r in zip(names, got, ref):
        _close_param_grad(name, o, r)


def test_mlp_autograd_matches_jax_vjp(train_env):
    """All 7 input cotangents of mlp_residual (z form forward, save-hidden
    backward with the dz kernel) against jax.vjp of pa.fused_mlp_residual,
    at 3e-5."""
    rng = np.random.default_rng(13)
    C, hidden = 128, 512
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=C ** -0.5),
              _randn(rng, hidden, std=0.1),
              _randn(rng, hidden, C, std=hidden ** -0.5),
              _randn(rng, C, std=0.1))
    g = _randn(rng, 37, 6, C)
    _, vjp = jax.vjp(lambda *a: pa.fused_mlp_residual(*a, 1e-6),
                     *_j(*arrays))
    ref = vjp(jnp.asarray(g))
    fa.reset_launch_counts()
    got = _port_grads(lambda *a: fa.mlp_residual(*a, 1e-6), arrays, g)
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for name, o, r in zip(names, got, ref):
        _close_param_grad(name, o, r)


def test_mlp_residual_runs_the_z_form_only_for_a_gradient():
    """Without a gradient to take, mlp_residual is the serving form and
    saves no hidden."""
    C = 128
    x = torch.randn(4, C)
    w1, w2 = torch.randn(C, 256) * 0.05, torch.randn(256, C) * 0.05
    v, h = torch.zeros(C), torch.zeros(256)
    with torch.no_grad():
        y = fa.mlp_residual(x, v + 1, v, w1, h, w2, v)
    assert y.grad_fn is None
    y = fa.mlp_residual(x, v + 1, v, w1.requires_grad_(True), h, w2, v)
    assert type(y.grad_fn).__name__ == "_FusedMLPResidualBackward"
