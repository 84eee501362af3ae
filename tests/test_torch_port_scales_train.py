"""The PyTorch port's 3- and 4-scale training (S = 22 and 86 tokens a
region) against the JAX package, on the CPU in float32.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, with its switches set by
monkeypatch as tests/test_torch_port_train.py (default routes) and
tests/test_torch_port_lean.py (memory-lean routes) set them. Inputs come
from numpy with a seed, or from the port's seeded initialiser exported in
the JAX layout (JAX's eager init of the ResNet-50 takes 20 s here), and go
to both sides unchanged. Bars, each its 2-scale counterpart's:
  * the attention backward's plain version at 65..86 tokens and the
    differentiable entry: atol = rtol = 3e-5 in units of each output's
    RMS (tests/test_torch_port_lean.py);
  * the training steps: atol = rtol = 1e-4 on the losses, on the first
    gradients in units of their RMS and on the params after each step;
    each trainable leaf's update at 1e-2 in units of its RMS
    (tests/test_torch_port_train.py);
  * the param tree's round trip: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu import train as jtrain
from duoformer_tcga_tpu.data import pipeline as jpipeline
from duoformer_tcga_tpu.models.duoformer import DuoFormer as JaxDuoFormer
from duoformer_tcga_tpu.ops import pallas_attention as pa

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.models.transformer import (PatchBlock,
                                                         ScaleBlock)
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

from test_torch_port_lean import LEAN_ENV, pinned_numerics  # noqa: F401
from test_torch_port_reg import (_arr, _attention_args, _close_in_rms_units,
                                 _flat, _rms)

TOL = dict(atol=3e-5, rtol=3e-5)
PARITY = dict(atol=1e-4, rtol=1e-4)
CFG = dict(depth=2, embed_dim=128, num_heads=2, proj_dim=128, num_classes=3)
STEPS = 3
DEFAULT_ENV = {k: "1" for k in ("DUOFORMER_PALLAS_BWD",
                                "DUOFORMER_MLP_SAVE_HIDDEN",
                                "DUOFORMER_MLP_DZ", "DUOFORMER_FUSED_ATTN",
                                "DUOFORMER_MEGAFUSE")}
BWD_NAMES = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj")
BWD_DW_NAMES = ("dx", "dlns", "dlnb", "dbqkv", "dbproj", "dwqkv", "dwA")
ATTN_GRADS = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj")


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# The attention backward at 65..86 tokens a segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ln", [True, False], ids=["full", "bare"])
@pytest.mark.parametrize("dw", [False, True], ids=["dw_false", "dw"])
@pytest.mark.parametrize("n_seg,S", [(5, 86), (3, 65)])
def test_attention_bwd_long_segments_match_pallas(n_seg, S, dw, use_ln):
    """fused_attention_residual_bwd against _fused_block_bwd_impl at 86
    tokens (the 4-scale ScaleBlocks) and 65 (the shortest the 86-token
    kernels take), ragged segment counts: every output of both forms; the
    Pallas row tensors carry zero-padded rows past n_seg * S, cut off."""
    rng = np.random.default_rng(n_seg * S)
    x, lns, lnb, wqkv, bqkv, wproj, _, _ = _attention_args(rng, n_seg, S,
                                                           128)
    if not use_ln:
        lns, lnb = np.zeros_like(lns), np.zeros_like(lnb)
    g = _arr(rng, n_seg, S, 128)
    arrays = (x, g, lns, lnb, wqkv, bqkv, wproj)
    ref = pa._fused_block_bwd_impl(*_j(arrays), 2, S, 0.125, 1e-6, use_ln,
                                   use_ln, dw=dw)
    got = fa.fused_attention_residual_bwd(
        *(torch.from_numpy(a) for a in arrays), 2, S, 0.125, 1e-6, use_ln,
        use_ln, dw=dw)
    names = BWD_DW_NAMES if dw else BWD_NAMES
    assert len(got) == len(ref) == len(names)
    for name, t, r in zip(names, got, ref):
        r = np.asarray(r)
        if name in ("ln", "attn", "dqkv"):
            r = r[:n_seg * S]
        if not use_ln and name in ("dlns", "dlnb"):
            assert not np.any(r) and not t.any()
            continue
        _close_in_rms_units(t, r, TOL, name)


@pytest.mark.parametrize("dw", [False, True], ids=["dw_false", "dw"])
def test_attention_autograd_long_segments_match_jax_vjp(monkeypatch, dw):
    """attention_residual(bwd_dw=...) at 86 tokens: the output and every
    gradient against jax.vjp of pa.fused_attention_residual, its backward
    on the matching route (DUOFORMER_BWD_DW)."""
    monkeypatch.setenv("DUOFORMER_PALLAS_BWD", "1")
    monkeypatch.setenv("DUOFORMER_BWD_DW", "1" if dw else "0")
    rng = np.random.default_rng(11)
    args = _attention_args(rng, 4, 86, 128)[:7]
    g = _arr(rng, 4, 86, 128)
    ref, vjp = jax.vjp(lambda *a: pa.fused_attention_residual(
        *a, 2, 86, 0.125, 1e-6, True, True), *_j(args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fa.attention_residual(*ts, 2, 86, 0.125, 1e-6, True, True,
                                bwd_dw=dw)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, TOL, "y")
    for name, t, r in zip(ATTN_GRADS, ts, vjp(jnp.asarray(g))):
        _close_in_rms_units(t.grad, r, TOL, name)


# ---------------------------------------------------------------------------
# The training step at 3 and 4 scales
# ---------------------------------------------------------------------------

def _seeded_tree(layers):
    """The port's seeded init, unfolded, in the JAX layout (numpy)."""
    return jax.tree.map(np.asarray, export_jax_params(port.DuoFormer(
        **CFG, num_layers=layers,
        generator=torch.Generator().manual_seed(layers))))


def _jax_steps(layers, p0, env, steps):
    """JAX: the first gradients and `steps` steps of make_train_step on 2
    tiles from p0, Adam (L2 1e-4), OneCycle at 1e-3 over 10 steps, frozen
    backbone, under `env`. -> (grads, losses, params after each step, the
    normalised batch, labels)."""
    tiles = np.random.default_rng(layers).integers(0, 256, (2, 224, 224, 3),
                                                   dtype=np.uint8)
    labels = np.array([0, 2], np.int32)
    jm = JaxDuoFormer(**CFG, num_layers=layers)
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        opt = jtrain.make_optimizer(
            jtrain.onecycle_schedule(1e-3, 10), 1e-4,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        params = jax.tree.map(jnp.asarray, p0)
        state = {"params": params, "opt_state": jax.jit(opt.init)(params),
                 "step": jnp.zeros((), jnp.int32)}
        x = jpipeline.preprocess_tiles(jnp.asarray(tiles), dtype=jnp.float32)
        batch = {"image": x, "label": jnp.asarray(labels)}
        rng = jax.random.PRNGKey(1)

        def loss_fn(p):          # the step's loss (train.py:436-482)
            frozen = jtrain.backbone_frozen_labels(p)
            p = jax.tree.map(lambda a, lab: jax.lax.stop_gradient(a)
                             if lab == "frozen" else a, p, frozen)
            return jtrain.cross_entropy(
                jm.apply(p, x, train=True, rng=jax.random.fold_in(rng, 0)),
                batch["label"])

        grads = _flat(jax.jit(jax.grad(loss_fn))(state["params"]))
        step = jtrain.make_train_step(
            jm, opt, donate=False,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        losses, after = [], []
        for _ in range(steps):
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
            after.append(_flat(state["params"]))
    finally:
        mp.undo()
    return grads, losses, after, np.array(x), labels


def _port_steps(model, p0, x, labels, steps, **routes):
    load_jax_params(model, p0)
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                1e-4, ttrain.backbone_frozen_labels)
    state = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, dtype=torch.float32, **routes)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    losses, after, grads = [], [], None
    for i in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _flat(export_jax_params(model, grads=True))
        after.append(_flat(export_jax_params(model)))
    return grads, losses, after


def _runs(layers, env, steps, **routes):
    p0 = _seeded_tree(layers)
    j_grads, j_losses, j_params, x, labels = _jax_steps(layers, p0, env,
                                                        steps)
    model = port.DuoFormer(**CFG, num_layers=layers,
                           fused_ln=bool(routes))
    t_grads, t_losses, t_params = _port_steps(model, p0, x, labels, steps,
                                              **routes)
    return dict(p0=_flat(p0), labels=_flat(jtrain.backbone_frozen_labels(
        p0)), j_grads=j_grads, j_losses=j_losses, j_params=j_params,
        t_grads=t_grads, t_losses=t_losses, t_params=t_params, model=model)


@pytest.fixture(scope="module", params=[3, 4], ids=["3scale", "4scale"])
def scales_run(request):
    """3 steps of the default routes on each side, at 3 or 4 scales."""
    return _runs(request.param, DEFAULT_ENV, STEPS)


@pytest.fixture(scope="module")
def lean_run():
    """1 step of the memory-lean routes on each side at 4 scales: the port
    with fused_ln and the lean step options, JAX under its switches."""
    return _runs(4, LEAN_ENV, 1, mlp_save_hidden=False, attn_bwd_dw=True)


def _check_run(r):
    """Losses, first gradients (in units of their RMS; fc_norm's exactly
    0, quirk Q7), params after each step and each trainable leaf's update
    (tests/test_torch_port_train.py's bars)."""
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], **PARITY)
    train = {k for k, lab in r["labels"].items() if lab == "train"}
    assert set(r["t_grads"]) == train
    for k, g in r["t_grads"].items():
        _close_in_rms_units(g, r["j_grads"][k], PARITY, k)
    for t, j in zip(r["t_params"], r["j_params"]):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **PARITY)
            if k in train:
                ref = j[k] - r["p0"][k]
                unit = _rms(ref)
                np.testing.assert_allclose(
                    (t[k] - r["p0"][k]) / unit, ref / unit, atol=1e-2,
                    rtol=1e-2, err_msg=k)


def test_scales_train_step_matches_jax(scales_run):
    _check_run(scales_run)


def test_scales_lean_step_matches_jax(lean_run):
    _check_run(lean_run)


@pytest.mark.parametrize("layers", [3, 4])
def test_set_backward_routes_reaches_every_block(layers):
    """make_train_step's routes reach every ScaleBlock and PatchBlock at 3
    and 4 scales, and set_backward_routes flips them back."""
    model = port.DuoFormer(**CFG, num_layers=layers, fused_ln=True)
    ttrain.make_train_step(model, dtype=torch.float32,
                           mlp_save_hidden=False, attn_bwd_dw=True)
    scale = [m for m in model.modules() if isinstance(m, ScaleBlock)]
    patch = [m for m in model.modules() if isinstance(m, PatchBlock)]
    assert len(scale) == len(patch) == CFG["depth"]
    assert all(b.attn_bwd_dw and not b.mlp_save_hidden for b in scale)
    assert all(b.attn_bwd_dw for b in patch)
    ttrain.set_backward_routes(model)
    assert not any(b.attn_bwd_dw for b in scale + patch)
    assert all(b.mlp_save_hidden for b in scale)


# ---------------------------------------------------------------------------
# Weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [3, 4])
def test_jax_param_tree_round_trips(layers):
    """A JAX param tree of the 3- or 4-scale release model (random values
    in the structure JAX's init gives) goes to the port and back bit for
    bit, the per-scale projection weights included."""
    shapes = jax.eval_shape(JaxDuoFormer(**CFG, num_layers=layers).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(layers)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype), shapes)
    model = port.DuoFormer(**CFG, num_layers=layers)
    back = _flat(export_jax_params(load_jax_params(model, tree)))
    ref = _flat(tree)
    assert set(back) == set(ref)
    proj = [k for k in ref if "['projection']" in k]
    assert len({k.split("]")[1] for k in proj}) >= layers, proj
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
