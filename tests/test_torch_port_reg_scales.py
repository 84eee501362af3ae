"""The PyTorch port's regularised release DuoFormer at 3 and 4 scales
(LayerScale, dropout and the Q9 q/k norms: R4r, R3r) against the JAX
package, on the CPU in float32.

The port's wrappers run their plain versions here (CPU tensors); the JAX
side runs its Pallas kernels in interpret mode under
DUOFORMER_FUSED_ATTN=1 and DUOFORMER_MEGAFUSE=1 (and DUOFORMER_PALLAS_BWD
with DUOFORMER_BWD_DW for the backward routes), as the other
tests/test_torch_port_*.py do, with the numerics pinned as
tests/test_torch_port_lean.py pins them. Inputs come from numpy with a
seed, or from the port's seeded initialiser exported in the JAX layout,
and go to both sides unchanged; both sides take the same int32 dropout
seeds, so every mask of the kernels is the same bit for bit. Bars:
  * the 86-token reg forward's and backward's plain versions, and the Q9
    patch block: atol = rtol = 3e-5 in units of each output's RMS (the
    bar of tests/test_torch_port_scales.py and
    tests/test_torch_port_scales_train.py);
  * the 86-token form's two plain twins composed with the flags: exactly
    the plain function;
  * the models in float32: the CLS and the logits less the head bias at
    1e-4 in units of their RMS (tests/test_torch_port_scales.py);
  * the scale stack in training with the seeds JAX derives: 1e-4 in units
    of each tensor's RMS (tests/test_torch_port_reg.py's model bar);
  * the patch block's dropout: the mask is ops/dropout.py's attention site
    at the block's seed, bit for bit, and its dropped share within 5
    binomial standard deviations of the rate (JAX draws this mask with
    jax.random, so the two sides agree in rate only);
  * the JAX param tree's round trip: bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu.inference import Predictor as JaxPredictor
from duoformer_tcga_tpu.models import transformer as jtfm
from duoformer_tcga_tpu.models.duoformer import (
    DuoFormer as JaxDuoFormer, fold_for_inference as jax_fold)
from duoformer_tcga_tpu.ops import pallas_attention as pa

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.models import transformer as ttfm
from duoformer_tcga_tpu_torch.ops import attention as tattn
from duoformer_tcga_tpu_torch.ops import dropout as dr
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import fused_reg as fr
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

from test_torch_port_lean import pinned_numerics  # noqa: F401
from test_torch_port_reg import (_arr, _attention_args, _close_in_rms_units,
                                 _flat, _scale_seeds)
from test_torch_port_scales import (_assert_embed_close_in_rms_units,
                                    _JaxKernels, _np_tree, _tiles)

TOL = dict(atol=3e-5, rtol=3e-5)
MODEL_TOL = 1e-4
STACK_TOL = dict(atol=1e-4, rtol=1e-4)
SEED = 12345
RATE = 0.1
CFG = dict(depth=1, embed_dim=128, num_heads=2, proj_dim=128, num_classes=3)
# R4r / R3r: the release family with the legacy preset's regularisation
# (config.py:185-187); LayerScale at 0.5 here so that the branches count
REG = dict(init_values=0.5, attn_drop_rate=RATE, proj_drop_rate=RATE)
JAX_ENV = {"DUOFORMER_FUSED_ATTN": "1", "DUOFORMER_MEGAFUSE": "1",
           "DUOFORMER_PALLAS_BWD": "1", "DUOFORMER_MLP_SAVE_HIDDEN": "1"}
ATTN_GRADS = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj",
              "dgamma")
FLAGS = {"gamma": (0.0, 0.0), "attn_drop+gamma": (RATE, 0.0),
         "all three": (RATE, RATE)}


@pytest.fixture
def jax_env(monkeypatch):
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)


def _jax_reg(arrays, attn_drop, proj_drop, use_ln, S=86, H=2):
    """pa.fused_attention_residual_reg on x, ln_scale, ln_bias, wqkv, bqkv,
    wproj, bproj, gamma, at SEED."""
    return pa.fused_attention_residual_reg(
        *arrays, jnp.int32(SEED), H, S, 0.125, 1e-6, use_ln, use_ln,
        attn_drop, proj_drop)


# ---------------------------------------------------------------------------
# The 86-token reg forms' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ln", [True, False], ids=["full", "bare"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_reg_forward_at_86_tokens_matches_pallas(jax_env, flags, use_ln):
    """fused_attention_residual with the reg flags at S=86 (the two
    launches' plain twins) against pa.fused_attention_residual_reg."""
    attn_drop, proj_drop = FLAGS[flags]
    arrays = _attention_args(np.random.default_rng(3), 2, 86, 128)
    ref = _jax_reg([jnp.asarray(a) for a in arrays], attn_drop, proj_drop,
                   use_ln)
    t = [torch.from_numpy(a) for a in arrays]
    out = fa.fused_attention_residual(
        *t[:7], 2, 86, 0.125, 1e-6, use_ln, use_ln, gamma=t[7], seed=SEED,
        attn_drop=attn_drop, proj_drop=proj_drop)
    _close_in_rms_units(out, ref, TOL, "y")


@pytest.mark.parametrize("dw", [False, True], ids=["dw_false", "dw"])
@pytest.mark.parametrize("flags", ["attn_drop+gamma", "all three"])
def test_reg_backward_at_86_tokens_matches_jax_vjp(monkeypatch, flags, dw):
    """attention_residual_reg(bwd_dw=...) at S=86: the output and every
    cotangent, dgamma included, against jax.vjp of
    pa.fused_attention_residual_reg on the matching route."""
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DUOFORMER_BWD_DW", "1" if dw else "0")
    attn_drop, proj_drop = FLAGS[flags]
    rng = np.random.default_rng(4)
    arrays = _attention_args(rng, 2, 86, 128)
    g = _arr(rng, 2, 86, 128)
    ref, vjp = jax.vjp(lambda *a: _jax_reg(a, attn_drop, proj_drop, True),
                       *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fr.attention_residual_reg(*ts, SEED, 2, 86, 0.125, 1e-6, True,
                                    True, attn_drop, proj_drop, bwd_dw=dw)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, TOL, "y")
    for name, t, r in zip(ATTN_GRADS, ts, vjp(jnp.asarray(g))):
        _close_in_rms_units(t.grad, r, TOL, name)


@pytest.mark.parametrize("use_ln", [True, False], ids=["full", "bare"])
def test_s86_twins_with_the_flags_compose_to_the_plain_function(use_ln):
    """attention_core_s86 (attention dropout) then attention_proj (gamma,
    proj dropout) give the plain function's bits."""
    t = [torch.from_numpy(a) for a in _attention_args(
        np.random.default_rng(5), 3, 86, 128)]
    o = fa.attention_core_s86(*t[:5], 2, 86, 0.125, use_ln=use_ln,
                              seed=SEED, attn_drop=RATE)
    y = fa.attention_proj(o, t[0], t[5], t[6], use_residual=use_ln,
                          gamma=t[7], seed=SEED, proj_drop=RATE)
    assert torch.equal(y, fa.fused_attention_residual_plain(
        *t[:7], 2, 86, 0.125, use_ln=use_ln, use_residual=use_ln, gamma=t[7],
        seed=SEED, attn_drop=RATE, proj_drop=RATE))
    assert not torch.equal(o, fa.attention_core_s86(*t[:5], 2, 86, 0.125,
                                                    use_ln=use_ln))


# ---------------------------------------------------------------------------
# The models, eval, float32
# ---------------------------------------------------------------------------

def _seeded_tree(layers):
    """The port's seeded R4r / R3r in the JAX layout, its q/k norms drawn
    away from ones and zeros so that applying them (or not) shows."""
    tree = export_jax_params(port.DuoFormer(
        **CFG, **REG, num_layers=layers,
        generator=torch.Generator().manual_seed(layers)))
    rng = np.random.default_rng(layers)
    for stack in ("scale_blocks", "patch_blocks"):
        for norm in ("q_norm", "k_norm"):
            p = tree["transformer"][stack]["attn"][norm]
            p["scale"] = (0.5 + rng.uniform(size=p["scale"].shape)).astype(
                np.float32)
            p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(
                np.float32)
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("layers", [3, 4], ids=["R3r", "R4r"])
def test_reg_model_matches_jax_in_float32(layers):
    """embed() of the regularised model in eval: the scale blocks carry
    their q/k norms unapplied and run LayerScale, the patch blocks apply
    theirs (the XLA route on both sides)."""
    raw = _seeded_tree(layers)
    tiles = _tiles(layers + 10)
    with _JaxKernels():
        jmodel = JaxDuoFormer(**CFG, **REG, num_layers=layers)
        ref = JaxPredictor(jmodel, raw, dtype=jnp.float32).embed(tiles)
    model = port.DuoFormer(**CFG, **REG, num_layers=layers).eval()
    load_jax_params(model, _np_tree(jax_fold(raw)))
    assert model.transformer.qk_norm
    out = port.Predictor(model, device="cpu", dtype=torch.float32,
                         fold=False).embed(tiles)
    _assert_embed_close_in_rms_units(
        out, ref, np.asarray(raw["transformer"]["head"]["b"]), MODEL_TOL)


# ---------------------------------------------------------------------------
# The scale stack in training, with the seeds JAX derives
# ---------------------------------------------------------------------------

def test_scale_stack_trains_like_jax_with_its_seeds(jax_env):
    """R4r's ScaleBlock stack (depth 2, S=86) in training: the output and
    the gradients of its parameters and of its input against JAX's fused
    reg stack (_scan_blocks of scale_block_apply at the Q9 rates), its
    seeds the ones JAX draws from its key (transformer.py:406, 209)."""
    depth = 2
    t_core = ttfm.MultiscaleFormer(
        depth=depth, scales=4, num_heads=2, embed_dim=128, num_classes=3,
        generator=torch.Generator().manual_seed(6), **REG)
    tree = export_jax_params(t_core)
    rng = np.random.default_rng(6)
    for ls in ("ls1", "ls2"):
        tree["scale_blocks"][ls]["gamma"] = rng.uniform(
            0.5, 1.5, (depth, 128)).astype(np.float32)
    load_jax_params(t_core, tree).train()
    tokens = _arr(rng, 1, 49, 86, 128)
    g = _arr(rng, 1, 49, 86, 128)
    r_scale = jax.random.PRNGKey(7)
    apply = functools.partial(
        jtfm.scale_block_apply, num_heads=2, scale=None, ln_eps=1e-6,
        attn_drop=RATE, proj_drop=0.0, mlp_drop=RATE, apply_qk_norm=False,
        train=True)

    def loss(blocks, x):         # <stack(blocks, x), g>, and the stack
        x = x + jnp.asarray(tree["pos_embed_for_scale"])
        y = jtfm._scan_blocks(apply, blocks, x, r_scale, True, depth)
        return jnp.sum(y * jnp.asarray(g)), y

    blocks = jax.tree.map(jnp.asarray, tree["scale_blocks"])
    (_, ref), (j_dblocks, j_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(blocks, jnp.asarray(tokens))
    x = torch.tensor(tokens, requires_grad=True)
    out = t_core.scale_stack(x, _scale_seeds(r_scale, depth))
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, STACK_TOL, "out")
    _close_in_rms_units(x.grad, j_dx, STACK_TOL, "dx")
    j_flat = _flat(j_dblocks)
    names = 0
    for name, p in t_core.scale_blocks.named_parameters():
        i, *rest = name.split(".")
        key = "".join(f"['{k}']" for k in rest)
        if p.grad is None:       # the carried q/k norms, unapplied
            assert "norm']" in key and "_norm" in key, name
            assert not np.any(j_flat[key][int(i)]), name
            continue
        _close_in_rms_units(p.grad, j_flat[key][int(i)], STACK_TOL, name)
        names += 1
    assert names == depth * 14


# ---------------------------------------------------------------------------
# The Q9 patch block: q/k norms applied, off the kernels
# ---------------------------------------------------------------------------

def _patch_block():
    """A release PatchBlock with q/k norms (the port's seeded init, the
    norms drawn away from ones and zeros), its tree in the JAX layout
    (patch_block_init's), and x, g [2, 50, 128]."""
    rng = np.random.default_rng(8)
    block = ttfm.PatchBlock(128, 2, qk_norm=True, attn_drop=RATE,
                            generator=torch.Generator().manual_seed(8))
    jp = export_jax_params(block)
    for norm in ("q_norm", "k_norm"):
        jp["attn"][norm]["scale"] = rng.uniform(0.5, 1.5, 64).astype(
            np.float32)
        jp["attn"][norm]["bias"] = _arr(rng, 64, std=0.1)
    return (jp, load_jax_params(block, jp), _arr(rng, 2, 50, 128),
            _arr(rng, 2, 50, 128))


def test_q9_patch_block_matches_jax():
    """The release PatchBlock with q/k norms, in eval (dropout off) and its
    gradients in training at rate 0, against patch_block_apply's XLA route
    (attention.py:235-245) under jax.vjp (k_norm's bias, whose gradient is
    0 analytically, under 1e-4 of k_norm.scale's on both sides); no kernel
    runs."""
    jp, block, x, g = _patch_block()
    fa.reset_launch_counts()
    params = jax.tree.map(jnp.asarray, jp)

    def loss(q, xx):             # training at rate 0: <block(xx), g>
        y = jtfm.patch_block_apply(q, xx, 2, attn_drop=0.0,
                                   rng=jax.random.PRNGKey(0), train=True)
        return jnp.sum(y * jnp.asarray(g)), y

    ref_eval = jax.jit(lambda q, xx: jtfm.patch_block_apply(
        q, xx, 2, attn_drop=RATE, train=False))(params, jnp.asarray(x))
    (_, ref), (j_dp, j_dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    with torch.no_grad():
        out = block.eval()(torch.from_numpy(x))
    _close_in_rms_units(out, ref_eval, TOL, "eval")
    block.attn_drop = 0.0
    xt = torch.tensor(x, requires_grad=True)
    out = block.train()(xt, seed=SEED)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, TOL, "train")
    _close_in_rms_units(xt.grad, j_dx, TOL, "dx")
    j_flat = _flat(j_dp)
    for name, p in block.named_parameters():
        key = "".join(f"['{k}']" for k in name.split("."))
        if name == "attn.k_norm.bias":
            # every key shifted alike adds one score to a query's row,
            # which the softmax cancels: 0 analytically, rounding on both
            # sides, held under 1e-4 of k_norm.scale's gradient's RMS
            unit = float(np.sqrt(np.mean(np.square(
                j_flat["['attn']['k_norm']['scale']"]))))
            assert np.abs(p.grad.numpy()).max() < 1e-4 * unit
            assert np.abs(j_flat[key]).max() < 1e-4 * unit
            continue
        _close_in_rms_units(p.grad, j_flat[key], TOL, name)
    assert sum(fa.launch_counts.values()) == 0


def test_q9_patch_block_dropout(monkeypatch):
    """In training the block drops its probabilities with ops/dropout.py's
    attention site at its seed (each sample a segment of 50 tokens, head h
    salted 4h), at the rate within 5 binomial standard deviations; in eval
    it drops nothing."""
    _, block, x, _ = _patch_block()
    seen, plain_drop = [], dr.drop

    def drop(v, mask, rate):
        seen.append((mask, rate))
        return plain_drop(v, mask, rate)

    monkeypatch.setattr(tattn.dr, "drop", drop)
    with torch.no_grad():
        train = block.train()(torch.from_numpy(x), seed=SEED)
        again = block(torch.from_numpy(x), seed=SEED)
        other = block(torch.from_numpy(x), seed=SEED + 1)
        assert len(seen) == 3
        evaled = block.eval()(torch.from_numpy(x))
    assert len(seen) == 3
    mask, rate = seen[0]
    assert rate == RATE
    assert torch.equal(mask, dr.attn_keep_masks(2, 50, 2, SEED, RATE))
    n = mask.numel()
    dropped = int((~mask).sum())
    assert abs(dropped - RATE * n) <= 5 * (n * RATE * (1 - RATE)) ** 0.5, (
        dropped, n)
    assert torch.equal(train, again) and not torch.equal(train, other)
    assert not torch.equal(train, evaled)


# ---------------------------------------------------------------------------
# Training steps, refusals, trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lean", [False, True], ids=["default", "lean"])
def test_reg_model_train_steps(lean):
    """Three make_train_step steps of R4r on each route: finite losses,
    every trainable tensor the loss reaches moved (all but the scale
    blocks' carried q/k norms and, on the default route, fc_norm: Q9, Q7),
    every backbone tensor unchanged."""
    model = port.DuoFormer(**CFG, **REG, num_layers=4, fused_ln=lean,
                           apply_fc_norm=lean,
                           generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                1e-4, ttrain.backbone_frozen_labels)
    state = ttrain.init_train_state(model, opt)
    step = ttrain.make_train_step(model, dtype=torch.float32,
                                  mlp_save_hidden=not lean,
                                  attn_bwd_dw=lean)
    tiles = np.random.default_rng(9).integers(0, 256, (1, 224, 224, 3),
                                              dtype=np.uint8)
    batch = {"image": tiles, "label": np.array([2])}
    assert model.transformer.num_seeds() == 3 * CFG["depth"]
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert np.all(np.isfinite(losses)), losses
    unreached = {n for n, p in model.named_parameters()
                 if p.requires_grad and not p.grad.any()}
    assert unreached == {
        n for n, _ in model.named_parameters()
        if (".scale_blocks." in n and "_norm." in n)
        or (not lean and n.startswith("transformer.fc_norm."))}, unreached
    for name, p in model.named_parameters():
        if p.requires_grad and name not in unreached:
            assert not torch.equal(p, before[name]), name
    for name, t in model.state_dict().items():
        if name.startswith("backbone."):
            assert torch.equal(t, before[name]), name


def _args(S):
    C = 128
    x, v = torch.randn(2, S, C), torch.zeros(C)
    return (x, v, v, torch.zeros(C, 3 * C), torch.zeros(3 * C),
            torch.zeros(C, C), v, 2, S, 0.125)


@pytest.mark.parametrize("flags", [
    dict(gamma=torch.ones(128)), dict(attn_drop=RATE, seed=1),
    dict(proj_drop=RATE, seed=1)], ids=["gamma", "attn_drop", "proj_drop"])
def test_reg_backward_refused_past_86_tokens(flags):
    """The backward's reg flags, like the forward's, stop at 86 tokens."""
    x, lns, lnb, wqkv, bqkv, wproj = _args(87)[:6]
    for dw in (False, True):
        with pytest.raises(NotImplementedError, match="seg_len 87"):
            fa.fused_attention_residual_bwd(x, x, lns, lnb, wqkv, bqkv, wproj,
                                            2, 87, 0.125, dw=dw, **flags)
    assert fa.fused_attention_residual_bwd(
        x[:, :86].contiguous(), x[:, :86].contiguous(), lns, lnb, wqkv, bqkv,
        wproj, 2, 86, 0.125, **flags)[0].shape == (2, 86, 128)


def test_int8_refuses_the_reg_model():
    """int8 serving refuses R4r's LayerScale blocks, as the JAX package's
    (quantize.py:53-68): the int8 kernels have no gamma epilogue."""
    model = port.DuoFormer(**CFG, **REG, num_layers=4)
    with pytest.raises(ValueError, match="LayerScale"):
        port.Predictor(model, device="cpu", dtype=torch.float32,
                       quantize=True)


def test_reg_param_tree_round_trips():
    """A JAX R4r tree (random values in the structure JAX's init gives:
    ls1, ls2 and q/k norms in every scale block, q/k norms in every patch
    block) goes to the port and back bit for bit."""
    shapes = jax.eval_shape(JaxDuoFormer(**CFG, **REG, num_layers=4).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(10)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype), shapes)
    model = port.DuoFormer(**CFG, **REG, num_layers=4)
    back = _flat(export_jax_params(load_jax_params(model, tree)))
    ref = _flat(tree)
    assert set(back) == set(ref)
    for stack in ("scale_blocks", "patch_blocks"):
        for norm in ("q_norm", "k_norm"):
            assert (f"['transformer']['{stack}']['attn']['{norm}']['scale']"
                    in ref)
    assert "['transformer']['scale_blocks']['ls2']['gamma']" in ref
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
