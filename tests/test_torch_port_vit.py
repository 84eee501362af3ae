"""The PyTorch port's ViT-B/16 baseline (models/vit.py, models/baselines.py)
and the attention forms at 87..197 tokens a segment it runs, against the
JAX package, on the CPU in float32.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode, with its switches set by
monkeypatch (the default routes as tests/test_torch_port_scales_train.py,
the memory-lean ones as tests/test_torch_port_lean.py; their numerics
pinned by its module fixture). Inputs come from numpy with a seed, or from
the port's seeded initialiser exported in the JAX layout, and go to both
sides unchanged. The model: 224^2 tiles, patch 16 (so 197 tokens, the
path's own length), depth 2, C = 128, 2 heads, 3 classes. Bars, each its
counterpart's elsewhere:
  * the kernels' plain versions and the differentiable entries: atol =
    rtol = 3e-5 in units of each output's RMS
    (tests/test_torch_port_scales_train.py);
  * the model's CLS and logits, and the training steps (losses, first
    gradients in units of their RMS, params after each step, each leaf's
    update at 1e-2 of its RMS): 1e-4 (tests/test_torch_port_train.py);
  * the param tree's round trip: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu import train as jtrain
from duoformer_tcga_tpu.data import pipeline as jpipeline
from duoformer_tcga_tpu.models.baselines import ViTBase16 as JaxViTBase16
from duoformer_tcga_tpu.models.vit import VisionTransformer as JaxViT
from duoformer_tcga_tpu.ops import pallas_attention as pa

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.models.transformer import ScaleBlock
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import initializers as port_init
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

from test_torch_port_lean import LEAN_ENV, pinned_numerics  # noqa: F401
from test_torch_port_reg import (_arr, _attention_args, _close_in_rms_units,
                                 _flat, _rms)
from test_torch_port_scales_train import (ATTN_GRADS, BWD_DW_NAMES,
                                          BWD_NAMES, DEFAULT_ENV, _j)

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=3e-5, rtol=3e-5)
PARITY = dict(atol=1e-4, rtol=1e-4)
WEIGHT_DECAY = 1e-4
VIT = dict(img_size=224, patch_size=16, embed_dim=128, depth=2, num_heads=2,
           num_classes=3)
STEPS = 3
LENGTHS = [(2, 197), (3, 87)]      # the ViT's 197; the shortest long form


def _env(env):
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    return mp


# ---------------------------------------------------------------------------
# The kernels' plain versions at 87..197 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ln", [True, False], ids=["full", "bare"])
@pytest.mark.parametrize("n_seg,S", LENGTHS)
def test_attention_long_matches_pallas(n_seg, S, use_ln):
    """fused_attention_residual against _fused_block_impl at 197 and 87
    tokens; the long form's two plain halves (attention_core_long,
    attention_proj) compose to the plain function exactly."""
    rng = np.random.default_rng(S)
    x, lns, lnb, wqkv, bqkv, wproj, bproj, _ = _attention_args(rng, n_seg, S,
                                                               128)
    arrays = (x, lns, lnb, wqkv, bqkv, wproj, bproj)
    ref = pa._fused_block_impl(*_j(arrays), 2, S, 0.125, 1e-6, use_ln, use_ln)
    ts = [torch.from_numpy(a) for a in arrays]
    got = fa.fused_attention_residual(*ts, 2, S, 0.125, 1e-6, use_ln, use_ln)
    _close_in_rms_units(got, ref, TOL, "y")
    o = fa.attention_core_long(*ts[:5], 2, S, 0.125, 1e-6, use_ln)
    assert torch.equal(fa.attention_proj(o, ts[0], ts[5], ts[6], use_ln),
                       got)


@pytest.mark.parametrize("use_ln", [True, False], ids=["full", "bare"])
@pytest.mark.parametrize("dw", [False, True], ids=["dw_false", "dw"])
@pytest.mark.parametrize("n_seg,S", LENGTHS)
def test_attention_bwd_long_matches_pallas(n_seg, S, dw, use_ln):
    """fused_attention_residual_bwd against _fused_block_bwd_impl at 197
    and 87 tokens, both forms: every output; the Pallas row tensors carry
    zero-padded rows past n_seg * S, cut off."""
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
def test_attention_autograd_long_matches_jax_vjp(monkeypatch, dw):
    """attention_residual(bwd_dw=...) at 197 tokens: the output and every
    gradient against jax.vjp of pa.fused_attention_residual, its backward
    on the matching route (DUOFORMER_BWD_DW)."""
    monkeypatch.setenv("DUOFORMER_PALLAS_BWD", "1")
    monkeypatch.setenv("DUOFORMER_BWD_DW", "1" if dw else "0")
    rng = np.random.default_rng(17)
    args = _attention_args(rng, 2, 197, 128)[:7]
    g = _arr(rng, 2, 197, 128)
    ref, vjp = jax.vjp(lambda *a: pa.fused_attention_residual(
        *a, 2, 197, 0.125, 1e-6, True, True), *_j(args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fa.attention_residual(*ts, 2, 197, 0.125, 1e-6, True, True,
                                bwd_dw=dw)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, TOL, "y")
    for name, t, r in zip(ATTN_GRADS, ts, vjp(jnp.asarray(g))):
        _close_in_rms_units(t.grad, r, TOL, name)


@pytest.mark.parametrize("n_seg,S", [(2, 197), (3, 86)])
def test_block_diag_attention_long_matches_jax(n_seg, S):
    """block_diag_attention and its gradient against the JAX op
    (_block_attention_impl forward) at 197 and 86 tokens."""
    rng = np.random.default_rng(S + 1)
    qkv = _arr(rng, n_seg, S, 3 * 128, std=2.0)
    g = _arr(rng, n_seg, S, 128)
    ref, vjp = jax.vjp(lambda a: pa.block_diag_attention(a, 2, S, 0.125),
                       jnp.asarray(qkv))
    t = torch.tensor(qkv, requires_grad=True)
    out = fa.block_diag_attention(t, 2, S, 0.125)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, TOL, "out")
    _close_in_rms_units(t.grad, vjp(jnp.asarray(g))[0], TOL, "dqkv")


def test_long_entries_count_no_launch_on_the_cpu():
    fa.reset_launch_counts()
    x = torch.randn(2, 197, 128)
    v = torch.zeros(128)
    fa.attention_core_long(x, v, v, torch.zeros(128, 384), torch.zeros(384),
                           2, 197, 0.125)
    fa.block_diag_attention(torch.randn(2, 197, 384), 2, 197, 0.125)
    assert sum(fa.launch_counts.values()) == 0


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _seeded_tree(seed=0):
    """The port's seeded small ViT, in the JAX layout (numpy)."""
    return jax.tree.map(np.asarray, export_jax_params(port.VisionTransformer(
        **VIT, generator=torch.Generator().manual_seed(seed))))


def _tiles(seed, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n, 224, 224, 3),
                                                dtype=np.uint8)


def test_vit_forward_matches_jax(monkeypatch):
    """The Predictor's embed() on 2 uint8 tiles (preprocessed on the
    device) against the JAX ViT on the same normalised batch: the
    post-norm CLS and the logits at 1e-4 in units of their RMS; the head
    bias is zero at init, so the logits are the head's product alone."""
    for k, v in DEFAULT_ENV.items():
        monkeypatch.setenv(k, v)
    p0 = _seeded_tree()
    tiles = _tiles(3)
    jm = JaxViT(**VIT)
    x = jpipeline.preprocess_tiles(jnp.asarray(tiles), dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, p0)
    tokens = jm.forward_tokens(params, jm.embed(params, x))
    j_cls, j_logits = tokens[:, 0], jm.forward_head(params, tokens)
    model = load_jax_params(port.VisionTransformer(**VIT), p0)
    pred = port.Predictor(model, device="cpu", dtype=torch.float32)
    logits, cls = pred.embed(tiles)
    _close_in_rms_units(cls, j_cls, PARITY, "cls")
    _close_in_rms_units(logits, j_logits, PARITY, "logits")
    assert torch.equal(pred(tiles), logits)


def _jax_steps(p0, env, steps):
    """JAX: the first gradients and `steps` steps of make_train_step on 2
    tiles from p0, Adam (L2 1e-4 on every parameter), OneCycle at 1e-3
    over 10 steps, nothing frozen (cli.py's "vit"), under `env`. ->
    (grads, losses, params after each step, the normalised batch,
    labels)."""
    tiles, labels = _tiles(5), np.array([0, 2], np.int32)
    jm = JaxViT(**VIT)
    mp = _env(env)
    try:
        opt = jtrain.make_optimizer(jtrain.onecycle_schedule(1e-3, 10),
                                    WEIGHT_DECAY)
        params = jax.tree.map(jnp.asarray, p0)
        state = {"params": params, "opt_state": jax.jit(opt.init)(params),
                 "step": jnp.zeros((), jnp.int32)}
        x = jpipeline.preprocess_tiles(jnp.asarray(tiles), dtype=jnp.float32)
        batch = {"image": x, "label": jnp.asarray(labels)}
        rng = jax.random.PRNGKey(1)

        def loss_fn(p):          # the step's loss (train.py:436-482)
            return jtrain.cross_entropy(
                jm.apply(p, x, train=True, rng=jax.random.fold_in(rng, 0)),
                batch["label"])

        grads = _flat(jax.jit(jax.grad(loss_fn))(state["params"]))
        step = jtrain.make_train_step(jm, opt, donate=False)
        losses, after = [], []
        for _ in range(steps):
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
            after.append(_flat(state["params"]))
    finally:
        mp.undo()
    return grads, losses, after, np.array(x), labels


def _runs(env, steps, **routes):
    """Both sides' steps from the port's seeded init, its qkv biases drawn
    from N(0, 0.02^2) instead of zeros; every leaf trains. The key bias's
    gradient is zero but for rounding (q . b_k shifts all of a query's
    scores alike, which the softmax does not see): from a zero start
    Adam's first update of it would be the sign of that rounding, another
    on each side; from a nonzero one the L2 decay term sets it."""
    p0 = _seeded_tree()
    qkv = p0["blocks"]["attn"]["qkv"]
    qkv["b"] = (np.random.default_rng(6).standard_normal(qkv["b"].shape)
                * 0.02).astype(np.float32)
    j_grads, j_losses, j_params, x, labels = _jax_steps(p0, env, steps)
    model = load_jax_params(port.VisionTransformer(
        **VIT, fused_ln=bool(routes)), p0)
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                WEIGHT_DECAY)
    state = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, dtype=torch.float32, **routes)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    t_losses, t_params, t_grads = [], [], None
    for i in range(steps):
        state, m = step(state, batch)
        t_losses.append(float(m["loss"]))
        if i == 0:
            t_grads = _flat(export_jax_params(model, grads=True))
        t_params.append(_flat(export_jax_params(model)))
    return dict(p0=_flat(p0), j_grads=j_grads, j_losses=j_losses,
                j_params=j_params, t_grads=t_grads, t_losses=t_losses,
                t_params=t_params, model=model)


def _check_run(r):
    """tests/test_torch_port_scales_train.py's bars with every leaf
    trained: the losses, the first gradients (in units of their RMS) and
    the params after each step at 1e-4, and each leaf's update since the
    start at 1e-2 in units of its RMS. Adam's first update of an element
    is lr g_t / (|g_t| + eps), g_t = its gradient plus the L2 term 1e-4 p:
    where the two nearly cancel, |g_t| comes near eps and the update moves
    with g_t's last digits (at 197 tokens, 4 of 4.1e5 elements of the
    default run, their g_t ~1e-8 from gradients ~1e-6 that agree to 7e-10).
    Elements whose g_t differs between the sides by more than 1e-2 of its
    size are held by the params' bar alone; at most 1e-4 of them."""
    np.testing.assert_allclose(r["t_losses"], r["j_losses"], **PARITY)
    assert set(r["t_grads"]) == set(r["j_grads"]) == set(r["p0"])
    for k, g in r["t_grads"].items():
        _close_in_rms_units(g, r["j_grads"][k], PARITY, k)
    keep, n = {}, 0
    for k, p in r["p0"].items():
        gj = r["j_grads"][k] + WEIGHT_DECAY * p
        gt = r["t_grads"][k] + WEIGHT_DECAY * p
        keep[k] = np.abs(gt - gj) <= 1e-2 * np.abs(gj)
        n += keep[k].size
    assert sum((~m).sum() for m in keep.values()) <= 1e-4 * n
    for t, j in zip(r["t_params"], r["j_params"]):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], err_msg=k, **PARITY)
            ref = (j[k] - r["p0"][k])[keep[k]]
            unit = _rms(ref)
            np.testing.assert_allclose(
                (t[k] - r["p0"][k])[keep[k]] / unit, ref / unit, atol=1e-2,
                rtol=1e-2, err_msg=k)


def test_vit_train_step_matches_jax():
    """make_train_step on the small ViT against the JAX step over 3 steps
    on the default routes: every parameter trains (the patch embed and the
    position embedding included)."""
    _check_run(_runs(DEFAULT_ENV, STEPS))


def test_vit_lean_step_matches_jax():
    """One step on the memory-lean routes: the port with fused_ln and the
    lean step options, JAX under its switches."""
    r = _runs(LEAN_ENV, 1, mlp_save_hidden=False, attn_bwd_dw=True)
    _check_run(r)
    blocks = [m for m in r["model"].modules() if isinstance(m, ScaleBlock)]
    assert len(blocks) == VIT["depth"]
    assert all(b.attn_bwd_dw and not b.mlp_save_hidden for b in blocks)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_predictor_refuses_int8_for_the_vit():
    model = port.VisionTransformer(**VIT)
    with pytest.raises(ValueError, match="release DuoFormer"):
        port.Predictor(model, device="cpu", quantize=True)


@pytest.mark.parametrize("model_type,grid,trunk,dim,heads", [
    ("ViTPretrained", 14, 1024, 768, 12),
    ("R50ViTPretrained", 14, 1024, 768, 12),
    ("R50ViT", 7, 2048, 384, 6)])
def test_hybrid_vit_types_build(monkeypatch, model_type, grid, trunk, dim,
                                heads):
    """The ResNetV2 hybrid types build at full width (the JAX package's
    baselines.py:99-111): the trunk's grid and channels, the 1x1 patch
    embed from them, the ViT's width, heads and positions (the
    truncated-normal draws, most of the build's time, are zeros here)."""
    monkeypatch.setattr(port_init, "trunc_normal",
                        lambda shape, std=0.02, generator=None:
                        torch.zeros(shape))
    m = port.ViTBase16(n_classes=5, model_type=model_type).model
    assert m.grid == grid and m.backbone.out_channels == trunk
    assert m.vit.patch_embed.w.shape == (dim, trunk, 1, 1)
    assert m.vit.pos_embed.shape == (1, grid * grid + 1, dim)
    assert len(m.vit.blocks) == 12
    assert m.vit.blocks[0].num_heads == heads


def test_unknown_vit_type_raises():
    with pytest.raises(ValueError, match="unknown ViTBase16 model_type"):
        port.ViTBase16(model_type="ViT-L")


@pytest.mark.parametrize("kwargs", [dict(init_values=1e-5),
                                    dict(drop_rate=0.1),
                                    dict(attn_drop_rate=0.1)])
def test_vit_layerscale_and_dropout_raise(kwargs):
    with pytest.raises(NotImplementedError):
        port.VisionTransformer(**VIT, **kwargs)


@pytest.mark.parametrize("flags", [
    dict(gamma=torch.ones(128)), dict(attn_drop=0.1, seed=1),
    dict(proj_drop=0.1, seed=1)])
def test_reg_flags_refused_at_197_tokens(flags):
    x = torch.randn(2, 197, 128)
    v = torch.zeros(128)
    args = (x, v, v, torch.zeros(128, 384), torch.zeros(384),
            torch.zeros(128, 128), v, 2, 197, 0.125)
    with pytest.raises(NotImplementedError, match="seg_len 197"):
        fa.fused_attention_residual(*args, **flags)
    with pytest.raises(NotImplementedError, match="seg_len 197"):
        fa.fused_attention_residual_bwd(x, x, *args[1:6], *args[7:],
                                        **flags)


# ---------------------------------------------------------------------------
# Weights carried across
# ---------------------------------------------------------------------------

def test_vit_base16_tree_round_trips():
    """A JAX ViTBase16 tree at full width (random values in the structure
    JAX's init gives: 768 wide, depth 12, 197 positions, 100 classes) goes
    to the port and back bit for bit, the conv weight HWIO both ways."""
    shapes = jax.eval_shape(JaxViTBase16(n_classes=100).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype), shapes)
    assert tree["model"]["patch_embed"]["w"].shape == (16, 16, 3, 768)
    assert tree["model"]["pos_embed"].shape == (1, 197, 768)
    model = port.ViTBase16(n_classes=100)
    back = _flat(export_jax_params(load_jax_params(model, tree)))
    ref = _flat(tree)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_build_vit_base16_on_the_cpu():
    """build_vit_base16, on the CPU on request: ViT-B/16 in eval mode,
    its weights those of ViTBase16 from the same seed."""
    a = port.build_vit_base16(n_classes=4, device="cpu", seed=3)
    assert not a.training and a.model.head.w.shape == (768, 4)
    assert len(a.model.blocks) == 12 and a.model.pos_embed.shape == (1, 197,
                                                                     768)
    ref = port.VisionTransformer(
        num_classes=4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.model.pos_embed, ref.pos_embed)
