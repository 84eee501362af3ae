"""The PyTorch port's reg (dropout + LayerScale) forms and the legacy
DuoFormer against the JAX package, on the CPU in float32.

The port's reg wrappers run their plain versions here (CPU tensors); the
JAX side runs its reg Pallas kernels and _drop_ew in interpret mode, with
DUOFORMER_FUSED_ATTN=1 and DUOFORMER_MEGAFUSE=1 set as tests/
test_reg_kernels.py sets them. Both sides take the same inputs (numpy)
and the same int32 dropout seeds: the JAX side derives them from its key
chain, and the helpers below repeat that chain (train.py:532 fold_in;
transformer.py:746, 406, 209, 291, 323, 785; attention.py:162, 219) and
hand the seeds to the port, so a wrong chain fails the parity tests.

Bars:
  * the dropout masks: bit for bit;
  * each reg form and its backward: atol = rtol = 1e-5 in units of the
    output's RMS (float32 on both sides; only summation order differs);
  * drop_ew: atol = rtol = 1e-6 (one elementwise formula; JAX's erf is a
    polynomial within 1.5e-7 of erf);
  * the models: atol = rtol = 1e-4, the repo's parity bar
    (tests/test_parity.py:19-29), in units of a tensor's RMS where it is
    small;
  * the legacy training step: the loss at 1e-4; each gradient at a
    relative L2 error of 1e-4 (read: 2.4e-5 at most; elementwise the
    batch-stat BN backward of the channel fusers, float32 sums over the
    batch in another order, reaches 3.6e-4 of a tensor's RMS), except the
    fusers' conv biases, whose gradient ahead of a batch-stat BN is 0
    analytically: both sides' under 1e-4 of their conv weight gradient's
    RMS (read: 6.3e-6); the params after the step at 1e-4, and each
    trainable leaf's update at a relative L2 error of 1e-2 (read:
    2.8e-3): Adam's first step divides each gradient by its own size, so
    an element whose gradient is near eps turns summation differences
    into update differences of its own size, as
    tests/test_torch_port_train.py found.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu import train as jtrain
from duoformer_tcga_tpu.data import pipeline as jpipeline
from duoformer_tcga_tpu.inference import Predictor as JaxPredictor
from duoformer_tcga_tpu.models import transformer as jtfm
from duoformer_tcga_tpu.models.duoformer import (
    DuoFormer as JaxDuoFormer, DuoFormerLegacy as JaxLegacy,
    fold_for_inference as jax_fold)
from duoformer_tcga_tpu.ops import pallas_attention as pa

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.models import transformer as ttfm
from duoformer_tcga_tpu_torch.ops import dropout as dr
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import fused_reg as fr
from duoformer_tcga_tpu_torch.ops import quantize as tq
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(depth=2, embed_dim=128, num_heads=2, proj_dim=128, num_classes=3)
SEED = 12345
JAX_ENV = ("DUOFORMER_FUSED_ATTN", "DUOFORMER_MEGAFUSE")
TRAIN_ENV = JAX_ENV + ("DUOFORMER_PALLAS_BWD", "DUOFORMER_MLP_SAVE_HIDDEN")


@pytest.fixture
def jax_env(monkeypatch):
    for k in TRAIN_ENV:
        monkeypatch.setenv(k, "1")


def _jax_env():
    mp = pytest.MonkeyPatch()
    for k in TRAIN_ENV:
        mp.setenv(k, "1")
    return mp


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a)))) or 1.0


def _close_in_rms_units(out, ref, tol=TOL, msg=""):
    out, ref = np.asarray(out), np.asarray(ref)
    unit = _rms(ref)
    np.testing.assert_allclose(out / unit, ref / unit, err_msg=msg, **tol)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _randint(key):
    return int(jax.random.randint(key, (), -2 ** 31, 2 ** 31 - 1,
                                  jnp.int32))


def _scale_seeds(r_scale, depth):
    """(attention, MLP) seeds of each block of a scanned ScaleBlock stack
    (transformer.py:406, 209, 291, 323)."""
    out = []
    for k in jax.random.split(r_scale, depth):
        r1, r2, _, _ = jax.random.split(k, 4)
        out += [_randint(r1), _randint(r2)]
    return out


def _mha_seed(key):
    """multihead_attention's seed (attention.py:162, 219)."""
    return _randint(jax.random.split(key)[0])


def legacy_seeds(rng, depth):
    """The seeds MultiscaleTransformer.apply(rng=rng, train=True) draws,
    in the port's order (transformer.py:746, 785)."""
    r_scale, r_region = jax.random.split(rng)
    return (_scale_seeds(r_scale, depth)
            + [_mha_seed(k) for k in jax.random.split(r_region)])


def release_seeds(rng, depth):
    """The seeds MultiscaleFormer.apply(rng=rng, train=True) draws
    (transformer.py:524, 573, 584)."""
    r_scale, r_patch, _, _ = jax.random.split(rng, 4)
    r0, rest = jax.random.split(r_patch)
    return (_scale_seeds(r_scale, depth) + [_mha_seed(r0)]
            + [_mha_seed(k) for k in jax.random.split(rest, depth - 1)])


def _arr(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _gamma(rng, C):
    return (0.5 + rng.uniform(size=C)).astype(np.float32)


def seeded_tree(model_cls, seed, **kwargs):
    """The port's seeded init of model_cls(**CFG, **kwargs) in the JAX
    layout (numpy leaves): the JAX package's eager init of a ResNet-50
    pyramid compiles each of its ops first, 15-20 s on the CPU in the
    first process that does it."""
    return export_jax_params(model_cls(
        **CFG, **kwargs, generator=torch.Generator().manual_seed(seed)))


# ---------------------------------------------------------------------------
# The masks and the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_masks_match_jax_bit_for_bit(rate):
    for seed in (SEED, -7, 2 ** 31 - 1, -2 ** 31):
        for site in (pa._SITE_PROJ, pa._SITE_MLP_HID, pa._SITE_MLP_OUT):
            ref = pa.row_keep_mask(203, 72, jnp.int32(seed), site, rate)
            got = dr.row_keep_mask(203, 72, seed, site, rate)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        ref = pa.attn_keep_masks(13, 6, 4, jnp.int32(seed), rate)
        got = dr.attn_keep_masks(13, 6, 4, seed, rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        rows = jnp.arange(64, dtype=jnp.int32)[:, None] * 977
        cols = jnp.arange(50, dtype=jnp.int32)[None, :]
        ref = pa.keep_mask_from_counters(jnp.int32(seed), rows, cols, rate)
        got = dr.keep_mask_from_counters(seed, torch.from_numpy(
            np.asarray(rows)), torch.from_numpy(np.asarray(cols)), rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert abs(float(got.float().mean()) - (1 - rate)) < 0.05


def _attention_args(rng, n_seg, S, C):
    return [_arr(rng, n_seg, S, C), _arr(rng, C, std=0.1, mean=1.0),
            _arr(rng, C, std=0.1), _arr(rng, C, 3 * C, std=0.1),
            _arr(rng, 3 * C, std=0.1), _arr(rng, C, C, std=0.1),
            _arr(rng, C, std=0.1), _gamma(rng, C)]


@pytest.mark.parametrize("use_ln,attn_drop,proj_drop", [
    (True, 0.1, 0.1),      # the legacy scale blocks in training
    (True, 0.0, 0.0),      # LayerScale alone (eval, and any seed)
    (True, 0.3, 0.0),      # the release scale blocks (Q9 rates)
    (False, 0.1, 0.0),     # the bare region / patch form
])
def test_attention_reg_and_backward_match_jax_vjp(jax_env, use_ln,
                                                  attn_drop, proj_drop):
    """attention_residual_reg forward and every gradient against
    pa.fused_attention_residual_reg under jax.vjp (the reg kernel and its
    _far_reg_bwd)."""
    rng = np.random.default_rng(1)
    n_seg, S, C, H = (13, 6, 128, 2) if use_ln else (3, 50, 128, 2)
    args = _attention_args(rng, n_seg, S, C)
    g = _arr(rng, n_seg, S, C)
    scale = 0.3

    def jf(*a):
        return pa.fused_attention_residual_reg(
            *a, jnp.int32(SEED), H, S, scale, 1e-6, use_ln, use_ln,
            attn_drop, proj_drop)

    ref, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    ref_grads = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fr.attention_residual_reg(*ts, SEED, H, S, scale, 1e-6, use_ln,
                                    use_ln, attn_drop, proj_drop)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, KERNEL_TOL, "y")
    names = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwproj", "dbproj",
             "dgamma")
    for name, t, r in zip(names, ts, ref_grads):
        if not use_ln and name in ("dlns", "dlnb"):
            assert not np.any(np.asarray(r)) and not t.grad.any()
            continue
        _close_in_rms_units(t.grad, r, KERNEL_TOL, name)


@pytest.mark.parametrize("drop", [0.1, 0.0])
def test_mlp_reg_and_backward_match_jax_vjp(jax_env, drop):
    """mlp_residual_reg (z form and its _fmr_reg_bwd: drop_ew with
    dropout, the dz kernel on g * gamma without) against
    pa.fused_mlp_residual_reg under jax.vjp; and the serving form."""
    rng = np.random.default_rng(2)
    rows, C, hidden = 77, 128, 512
    args = [_arr(rng, rows, C), _arr(rng, C, std=0.1, mean=1.0),
            _arr(rng, C, std=0.1), _arr(rng, C, hidden, std=0.1),
            _arr(rng, hidden, std=0.1), _arr(rng, hidden, C, std=0.05),
            _arr(rng, C, std=0.1), _gamma(rng, C)]
    g = _arr(rng, rows, C)

    def jf(*a):
        return pa.fused_mlp_residual_reg(*a, jnp.int32(SEED), 1e-6, True,
                                         drop)

    ref, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    ref_grads = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fr.mlp_residual_reg(*ts, SEED, 1e-6, True, drop)
    out.backward(torch.from_numpy(g))
    _close_in_rms_units(out.detach(), ref, KERNEL_TOL, "y")
    names = ("dx", "dlns", "dlnb", "dw1", "db1", "dw2", "db2", "dgamma")
    for name, t, r in zip(names, ts, ref_grads):
        _close_in_rms_units(t.grad, r, KERNEL_TOL, name)
    with torch.no_grad():
        serving = fr.mlp_residual_reg(*ts, SEED, 1e-6, True, drop)
    _close_in_rms_units(serving, ref, KERNEL_TOL, "serving form")


def test_attention_bwd_reg_plain_matches_pallas(jax_env):
    """The backward kernel's plain twin against _fused_block_bwd_impl's
    reg instantiation: the row-space outputs, the column sums (dbproj:
    the float32 proj-masked g, no gamma) and gm."""
    rng = np.random.default_rng(3)
    n_seg, S, C, H = 13, 6, 128, 2
    x, lns, lnb, wqkv, bqkv, wproj, _, gamma = _attention_args(rng, n_seg,
                                                               S, C)
    g = _arr(rng, n_seg, S, C)
    ref = pa._fused_block_bwd_impl(
        *(jnp.asarray(a) for a in (x, g, lns, lnb, wqkv, bqkv, wproj)), H,
        S, 0.3, 1e-6, True, True, gamma=jnp.asarray(gamma),
        seed=jnp.int32(SEED), attn_drop=0.1, proj_drop=0.1)
    got = fa.fused_attention_residual_bwd(
        *(torch.from_numpy(a) for a in (x, g, lns, lnb, wqkv, bqkv, wproj)),
        H, S, 0.3, gamma=torch.from_numpy(gamma), seed=SEED, attn_drop=0.1,
        proj_drop=0.1)
    rows = n_seg * S
    names = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj",
             "gm")
    assert len(got) == len(ref) == len(names)
    for name, t, r in zip(names, got, ref):
        r = np.asarray(r)
        if r.ndim == 2 and r.shape[0] != rows:
            r = r[:rows]
        _close_in_rms_units(t.reshape(r.shape), r, KERNEL_TOL, name)


@pytest.mark.parametrize("mode", fr.DROP_EW_MODES)
def test_drop_ew_plain_matches_jax(mode):
    rng = np.random.default_rng(4)
    z, dh = _arr(rng, 70, 256), _arr(rng, 70, 256)
    site = pa._SITE_MLP_OUT if mode == "gm" else pa._SITE_MLP_HID
    ref = pa._drop_ew(jnp.asarray(z), jnp.int32(SEED), 0.1, site, mode,
                      dh=jnp.asarray(dh))
    got = fr.drop_ew_plain(torch.from_numpy(z), SEED, 0.1, site, mode,
                           torch.from_numpy(dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    assert fr.drop_ew(torch.from_numpy(z), SEED, 0.1, site, mode,
                      torch.from_numpy(dh)).equal(got)


def test_reg_plain_path_counts_no_launch_and_meta_raises():
    fa.reset_launch_counts()
    C = 128
    x = torch.randn(3, 6, C)
    z = torch.zeros(C)
    fa.fused_attention_residual(x, z, z, torch.zeros(C, 3 * C),
                                torch.zeros(3 * C), torch.zeros(C, C), z,
                                2, 6, 0.125, gamma=torch.ones(C), seed=1,
                                attn_drop=0.1, proj_drop=0.1)
    fr.drop_ew(x.reshape(-1, C), 1, 0.1, 3, "gm")
    assert sum(fa.launch_counts.values()) == 0
    m = torch.empty(18, C, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fr.drop_ew(m, 1, 0.1, 3, "gm")


# ---------------------------------------------------------------------------
# The cores in training mode, with the seeds JAX derives
# ---------------------------------------------------------------------------

def _core_grads(t_core, j_core, j_params, tokens, seeds, rng):
    """Forward and the gradients of sum(logits * w) of a port core and a
    JAX core in training mode on the same tokens and seeds."""
    w = np.random.default_rng(9).standard_normal((2, 3)).astype(np.float32)

    def loss(p):
        return jnp.sum(j_core.apply(p, jnp.asarray(tokens), rng=rng,
                                    train=True) * w)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(j_params)
    t_core.train()
    logits = t_core(torch.from_numpy(tokens), seeds=seeds)
    t_loss = (logits * torch.from_numpy(w)).sum()
    t_loss.backward()
    t_grads = {n: p.grad for n, p in t_core.named_parameters()
               if p.grad is not None}
    return float(t_loss), float(j_loss), t_grads, _flat(j_grads)


def _jax_name(name):
    """A port core's parameter name -> the JAX core tree's keystr."""
    parts = name.split(".")
    if parts[0] in ("blocks", "scale_blocks", "patch_blocks"):
        parts = [parts[0]] + parts[2:]
    return "".join(f"['{p}']" for p in parts)


@pytest.mark.parametrize("family", ["legacy", "release"])
def test_core_trains_like_jax_with_its_seeds(family):
    """MultiscaleTransformer (attention dropout 0.1, dropout 0.1,
    LayerScale 1e-5) and the release MultiscaleFormer with
    proj_drop_rate=0.1 and init_values=1e-5: the loss and every gradient
    (block i of the port against slice i of JAX's stacked gradient)."""
    mp = _jax_env()
    try:
        gen = torch.Generator().manual_seed(0)
        if family == "legacy":
            j_core = jtfm.MultiscaleTransformer(
                depth=2, num_heads=2, embed_dim=128, drop_rate=0.1,
                attn_drop_rate=0.1, init_values=1e-5, num_classes=3)
            t_core = ttfm.MultiscaleTransformer(
                depth=2, num_heads=2, embed_dim=128, drop_rate=0.1,
                attn_drop_rate=0.1, init_values=1e-5, num_classes=3,
                generator=gen)
            seeds_of = legacy_seeds
        else:
            j_core = jtfm.MultiscaleFormer(
                depth=2, num_heads=2, embed_dim=128, proj_drop_rate=0.1,
                init_values=1e-5, num_classes=3)
            t_core = ttfm.MultiscaleFormer(
                depth=2, num_heads=2, embed_dim=128, proj_drop_rate=0.1,
                init_values=1e-5, num_classes=3, generator=gen)
            seeds_of = release_seeds
        tree = export_jax_params(t_core)          # the port's seeded init
        for blk in ("blocks", "scale_blocks"):
            if blk in tree:    # LayerScale away from 1e-5: visible gammas
                for ls in ("ls1", "ls2"):
                    tree[blk][ls]["gamma"] = np.random.default_rng(
                        5).uniform(0.5, 1.5, tree[blk][ls]["gamma"].shape
                                   ).astype(np.float32)
        j_params = jax.tree.map(jnp.asarray, tree)
        load_jax_params(t_core, tree)
        tokens = _arr(np.random.default_rng(6), 2, 49, 6, 128)
        rng = jax.random.PRNGKey(7)
        seeds = seeds_of(rng, 2)
        assert len(seeds) == t_core.num_seeds()
        t_loss, j_loss, t_grads, j_grads = _core_grads(
            t_core, j_core, j_params, tokens, seeds, rng)
    finally:
        mp.undo()
    np.testing.assert_allclose(t_loss, j_loss, **TOL)
    assert len(t_grads) > 20
    for name, g in t_grads.items():
        parts = name.split(".")
        ref = j_grads[_jax_name(name)]
        if parts[0] in ("blocks", "scale_blocks", "patch_blocks"):
            ref = ref[int(parts[1])]
        _close_in_rms_units(g.numpy(), ref, TOL, name)


def test_seed_chain_drives_the_masks():
    """The same core on other seeds gives another output: the seeds the
    test hands in are what the dropout sees. In eval mode seeds are
    ignored, and a training forward without seeds runs no dropout (the
    JAX package's without an rng)."""
    core = ttfm.MultiscaleTransformer(depth=2, num_heads=2, embed_dim=128,
                                      drop_rate=0.1, attn_drop_rate=0.1,
                                      num_classes=3).train()
    x = torch.randn(1, 49, 6, 128)
    with torch.no_grad():
        a = core(x, seeds=list(range(6)))
        b = core(x, seeds=list(range(6)))
        c = core(x, seeds=list(range(1, 7)))
        f = core(x)
        d = core.eval()(x, seeds=list(range(6)))
        e = core(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e) and torch.equal(f, e)


# ---------------------------------------------------------------------------
# The legacy model: serving and one training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy():
    """One JAX DuoFormerLegacy (depth 2, C=128, 2 heads, 3 classes) from
    PRNGKey(0): its Predictor's embed() on 2 tiles, and one train step
    (Adam, L2 1e-4, OneCycle, the frozen partition) with its gradients.
    (Its params stay JAX's own draw: from the port's seeded init the
    channel fusers' batch-stat BN backward reads 2.0e-4 on
    channel_proj.l1_conv1.w, over the 1e-4 bar above.)"""
    tiles = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                              dtype=np.uint8)
    labels = np.array([0, 2], np.int32)
    mp = _jax_env()
    try:
        jm = JaxLegacy(**CFG)
        state_opt = jtrain.make_optimizer(
            jtrain.onecycle_schedule(1e-3, 10), 1e-4,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        state = jtrain.init_train_state(jm, jax.random.PRNGKey(0), state_opt)
        raw = jax.tree.map(np.asarray, state["params"])
        j_logits, j_cls = JaxPredictor(jm, state["params"],
                                       dtype=jnp.float32).embed(tiles)
        x = jpipeline.preprocess_tiles(jnp.asarray(tiles), dtype=jnp.float32)
        batch = {"image": x, "label": jnp.asarray(labels)}
        rng = jax.random.PRNGKey(1)
        step_rng = jax.random.fold_in(rng, 0)       # train.py:532, step 0

        def loss_fn(p):
            frozen = jtrain.backbone_frozen_labels(p)
            p = jax.tree.map(lambda a, lab: jax.lax.stop_gradient(a)
                             if lab == "frozen" else a, p, frozen)
            return jtrain.cross_entropy(
                jm.apply(p, x, rng=step_rng, train=True), batch["label"])

        j_grads = _flat(jax.jit(jax.grad(loss_fn))(state["params"]))
        step = jtrain.make_train_step(
            jm, state_opt, donate=False,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        state, m = step(state, batch, rng)
        j_loss, j_params = float(m["loss"]), _flat(state["params"])
    finally:
        mp.undo()
    labels_j = _flat(jtrain.backbone_frozen_labels(raw))

    model = port.DuoFormerLegacy(**CFG)
    load_jax_params(model, raw)
    t_opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                  1e-4, ttrain.backbone_frozen_labels)
    t_state = ttrain.init_train_state(model, t_opt)
    t_step = ttrain.make_train_step(model, dtype=torch.float32)
    t_state, tm = t_step(t_state, {"image": torch.from_numpy(np.array(x)),
                                   "label": torch.from_numpy(labels)},
                         seeds=legacy_seeds(step_rng, CFG["depth"]))
    t_grads = _flat(export_jax_params(model, grads=True))
    t_params = _flat(export_jax_params(model))
    served = port.DuoFormerLegacy(**CFG)
    load_jax_params(served, raw)
    pred = port.Predictor(served, device="cpu", dtype=torch.float32)
    t_logits, t_cls = pred.embed(tiles)
    return dict(raw=_flat(raw), labels_j=labels_j, j_logits=j_logits,
                j_cls=j_cls, t_logits=t_logits, t_cls=t_cls, j_loss=j_loss,
                t_loss=float(tm["loss"]), j_grads=j_grads, t_grads=t_grads,
                j_params=j_params, t_params=t_params, pred=pred)


def test_legacy_predictor_matches_jax(legacy):
    """embed(): the post-norm CLS the head reads and the logits, in units
    of their RMS (the pyramids differ by float32 summation order)."""
    _close_in_rms_units(legacy["t_cls"].numpy(), legacy["j_cls"])
    _close_in_rms_units(legacy["t_logits"].numpy(), legacy["j_logits"])
    logits = legacy["pred"](np.zeros((1, 224, 224, 3), np.uint8))
    assert tuple(logits.shape) == (3,)            # Q13: squeezed at B=1


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0))


def test_legacy_train_step_loss_and_gradients_match_jax(legacy):
    np.testing.assert_allclose(legacy["t_loss"], legacy["j_loss"], **TOL)
    train = {k for k, lab in legacy["labels_j"].items() if lab == "train"}
    assert set(legacy["t_grads"]) == train
    for k, g in legacy["t_grads"].items():
        ref = legacy["j_grads"][k]
        if "['fuse']" in k and k.endswith("['b']"):
            unit = _rms(legacy["j_grads"][k[:-len("['b']")] + "['w']"])
            assert np.abs(g).max() < 1e-4 * unit, k
            assert np.abs(ref).max() < 1e-4 * unit, k
            continue
        assert _rel_l2(g, ref) <= 1e-4, (k, _rel_l2(g, ref))


def test_legacy_train_step_params_match_jax(legacy):
    """Every leaf after the step (the frozen backbone and the BN running
    statistics unchanged), and each trainable leaf's update in units of
    its RMS."""
    t, j, p0 = legacy["t_params"], legacy["j_params"], legacy["raw"]
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)
        if legacy["labels_j"][k] == "frozen":
            np.testing.assert_array_equal(t[k], p0[k], err_msg=k)
        else:
            err = _rel_l2(t[k] - p0[k], j[k] - p0[k])
            assert err <= 1e-2, (k, err)


def test_train_step_draws_seeds_from_its_generator():
    """A model with dropout takes the step's generator's seeds: two steps
    made with one dropout_seed from the same weights agree, another seed
    differs; a model without dropout needs none."""
    def one_step(dropout_seed):
        torch.manual_seed(0)
        model = port.build_model(**CFG, device="cpu", seed=3)
        opt = ttrain.make_optimizer(model, ttrain.onecycle_schedule(1e-3, 10),
                                    1e-4, ttrain.backbone_frozen_labels)
        state = ttrain.init_train_state(model, opt)
        step = ttrain.make_train_step(model, dtype=torch.float32,
                                      dropout_seed=dropout_seed)
        x = torch.randn(2, 224, 224, 3, generator=torch.Generator()
                        .manual_seed(1))
        _, m = step(state, {"image": x, "label": torch.tensor([1, 0])})
        return float(m["loss"])

    assert one_step(0) == one_step(0) != one_step(1)


# ---------------------------------------------------------------------------
# The release family's lifted options, trees, and int8 refusals
# ---------------------------------------------------------------------------

def test_release_channel_token_matches_jax():
    """The release DuoFormer with scale_token="channel" (its refusal
    lifted): embed() against the JAX Predictor, in units of RMS."""
    tiles = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                              dtype=np.uint8)
    raw = jax.tree.map(jnp.asarray, seeded_tree(
        port.DuoFormer, 0, num_layers=2, scale_token="channel"))
    mp = _jax_env()
    try:
        jm = JaxDuoFormer(**CFG, num_layers=2, scale_token="channel")
        j_logits, j_cls = JaxPredictor(jm, raw, dtype=jnp.float32).embed(
            tiles)
    finally:
        mp.undo()
    model = port.DuoFormer(**CFG, num_layers=2, scale_token="channel")
    load_jax_params(model, jax.tree.map(np.asarray, jax_fold(raw)))
    t_logits, t_cls = port.Predictor(model, device="cpu",
                                     dtype=torch.float32).embed(tiles)
    _close_in_rms_units(t_cls.numpy(), j_cls)
    bias = np.asarray(raw["transformer"]["head"]["b"])
    _close_in_rms_units(t_logits.numpy() - bias, np.asarray(j_logits) - bias)


@pytest.mark.parametrize("tree", ["legacy", "release_ls"])
def test_jax_trees_round_trip(tree):
    """load_jax_params -> export_jax_params returns every leaf of the JAX
    tree bit for bit: the legacy tree (blocks with attn1, attn2 and its
    carried Q9 q/k norms, ls1, ls2; channel_proj with fuse[i].conv/bn;
    norm; head) and a release tree with ls1, ls2 and the channel token
    (random values in the structure JAX's init gives)."""
    if tree == "legacy":
        jm = JaxLegacy(**CFG)
        model = port.DuoFormerLegacy(**CFG)
    else:
        jm = JaxDuoFormer(**CFG, init_values=1e-5, scale_token="channel")
        model = port.DuoFormer(**CFG, init_values=1e-5,
                               scale_token="channel")
    rng = np.random.default_rng(2)
    raw = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        s.dtype), jax.eval_shape(jm.init, jax.random.PRNGKey(2)))
    load_jax_params(model, raw)
    ref, got = _flat(raw), _flat(export_jax_params(model))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if tree == "legacy":
        assert "['transformer']['blocks']['attn2']['q_norm']['scale']" in ref
        assert not hasattr(model.transformer.blocks[0].attn1, "q_norm")


def test_int8_refuses_legacy_and_layerscale_models():
    """Neither quantize_model_ nor Predictor(quantize=True) takes the
    legacy family or a release model with LayerScale: the int8 kernels
    have no gamma epilogue (quantize.py:51-69)."""
    for make in (lambda: port.DuoFormerLegacy(**CFG),
                 lambda: port.DuoFormer(**CFG, init_values=1e-5)):
        with pytest.raises(ValueError):
            tq.quantize_model_(make())
        with pytest.raises(ValueError):
            port.Predictor(make(), device="cpu", dtype=torch.float32,
                           quantize=True)


def test_build_model_and_refusals():
    model = port.build_model(**CFG, device="cpu")
    assert isinstance(model, port.DuoFormerLegacy) and not model.training
    assert model.transformer.num_seeds() == 2 * CFG["depth"] + 2
    with pytest.raises(ValueError, match="num_layers=2"):
        port.build_model(**CFG, num_layers=3, device="cpu")
    with pytest.raises(NotImplementedError):
        port.build_model(**CFG, remat=True, device="cpu")
    # attn_drop_rate > 0 builds (Q9: q/k norms, applied by the patch
    # blocks; tests/test_torch_port_reg_scales.py)
    assert port.DuoFormer(**CFG, attn_drop_rate=0.1).transformer.qk_norm
    unfrozen = port.build_model(**CFG, freeze=False, device="cpu").train()
    with pytest.raises(NotImplementedError):
        unfrozen(torch.zeros(1, 224, 224, 3))
