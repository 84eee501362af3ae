"""The PyTorch port's training step against the JAX package's, on the CPU
in float32.

One JAX DuoFormer (depth 2, C=128, 2 heads, 3 classes) is initialised
from PRNGKey(0), unfolded, and loaded into the port with load_jax_params.
Both sides take 3 steps on the same 2 tiles with Adam (L2 decay 1e-4),
OneCycle at 1e-3 over 10 steps and the frozen backbone. The JAX side runs
its Pallas kernels in interpret mode on the save-hidden path with the dz
kernel on (DUOFORMER_PALLAS_BWD, DUOFORMER_MLP_SAVE_HIDDEN,
DUOFORMER_MLP_DZ, DUOFORMER_FUSED_ATTN, DUOFORMER_MEGAFUSE set to 1); the
port runs the plain versions of its kernels. Bars: atol = rtol = 1e-4,
the repo's parity bar (tests/test_parity.py:19-29), in units of a
tensor's RMS where the tensor is small; 1e-6 for the schedules and the
optimizer, which compute the same formulas on the same numbers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from duoformer_tcga_tpu import train as jtrain
from duoformer_tcga_tpu.data import pipeline as jpipeline
from duoformer_tcga_tpu.models.duoformer import DuoFormer as JaxDuoFormer

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch import train as ttrain
from duoformer_tcga_tpu_torch.utils.convert import (export_jax_params,
                                                    load_jax_params)

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(depth=2, embed_dim=128, num_heads=2, proj_dim=128, num_classes=3,
           num_layers=2)
STEPS = 3
PEAK_LR, TOTAL = 1e-3, 10
WD = 1e-4
JAX_ENV = ("DUOFORMER_PALLAS_BWD", "DUOFORMER_MLP_SAVE_HIDDEN",
           "DUOFORMER_MLP_DZ", "DUOFORMER_FUSED_ATTN", "DUOFORMER_MEGAFUSE")


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


@pytest.fixture(scope="module")
def runs():
    """3 JAX steps and 3 port steps from the same params on the same
    batch, and the JAX step's first gradients."""
    tiles = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                              dtype=np.uint8)
    labels = np.array([0, 2], np.int32)
    mp = pytest.MonkeyPatch()
    for k in JAX_ENV:
        mp.setenv(k, "1")
    try:
        jm = JaxDuoFormer(**CFG)
        x = np.asarray(jpipeline.preprocess_tiles(jnp.asarray(tiles),
                                                  dtype=jnp.float32))
        opt = jtrain.make_optimizer(
            jtrain.onecycle_schedule(PEAK_LR, TOTAL), WD,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        state = jtrain.init_train_state(jm, jax.random.PRNGKey(0), opt)
        p0 = jax.tree.map(np.asarray, state["params"])
        rng = jax.random.PRNGKey(1)
        batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}

        def loss_fn(p):          # the step's loss (train.py:436-482)
            frozen = jtrain.backbone_frozen_labels(p)
            p = jax.tree.map(lambda a, lab: jax.lax.stop_gradient(a)
                             if lab == "frozen" else a, p, frozen)
            logits = jm.apply(p, batch["image"], train=True,
                              rng=jax.random.fold_in(rng, 0))
            return jtrain.cross_entropy(logits, batch["label"])

        j_grads = _flat(jax.jit(jax.grad(loss_fn))(state["params"]))
        step = jtrain.make_train_step(
            jm, opt, donate=False,
            frozen_label_fn=jtrain.backbone_frozen_labels)
        j_losses, j_params = [], []
        for _ in range(STEPS):
            state, m = step(state, batch, rng)
            j_losses.append(float(m["loss"]))
            j_params.append(_flat(state["params"]))
    finally:
        mp.undo()
    labels_j = _flat(jtrain.backbone_frozen_labels(p0))

    model = port.DuoFormer(**CFG)
    load_jax_params(model, p0)
    backbone0 = {n: t.clone() for n, t in model.backbone.state_dict().items()}
    t_opt = ttrain.make_optimizer(
        model, ttrain.onecycle_schedule(PEAK_LR, TOTAL), WD,
        ttrain.backbone_frozen_labels)
    t_state = ttrain.init_train_state(model, t_opt)
    t_step = ttrain.make_train_step(model, dtype=torch.float32)
    t_batch = {"image": torch.from_numpy(x.copy()),
               "label": torch.from_numpy(labels)}
    t_losses, t_params = [], []
    for i in range(STEPS):
        t_state, m = t_step(t_state, t_batch)
        t_losses.append(float(m["loss"]))
        if i == 0:
            t_grads = _flat(export_jax_params(model, grads=True))
        t_params.append(_flat(export_jax_params(model)))
    return dict(p0=_flat(p0), labels_j=labels_j, j_grads=j_grads,
                j_losses=j_losses, j_params=j_params, t_grads=t_grads,
                t_losses=t_losses, t_params=t_params, model=model,
                backbone0=backbone0, t_state=t_state)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_loss_matches_jax(runs, i):
    np.testing.assert_allclose(runs["t_losses"][i], runs["j_losses"][i],
                               **TOL)


def test_train_step_gradients_match_jax(runs):
    """Step 1's gradient of every trainable tensor, in units of its RMS
    (most are ~1e-6: the patch chain shrinks what reaches the scale
    stack); the port has a gradient for exactly the JAX "train" leaves."""
    train = {k for k, lab in runs["labels_j"].items() if lab == "train"}
    assert set(runs["t_grads"]) == train
    for k, g in runs["t_grads"].items():
        ref = runs["j_grads"][k]
        unit = _rms(ref) or 1.0      # fc_norm (quirk Q7): exactly zero
        np.testing.assert_allclose(g / unit, ref / unit, err_msg=k, **TOL)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_params_match_jax(runs, i):
    """Every leaf of the param tree after step i + 1, BN statistics and
    the frozen backbone included, through export_jax_params."""
    t, j = runs["t_params"][i], runs["j_params"][i]
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_updates_match_jax(runs, i):
    """What step i + 1 moved each trainable leaf by, since the start, in
    units of its RMS: the updates are ~1e-4, under the absolute bar of
    the params test. Bar 1e-2: Adam's first steps divide each gradient
    by its own size, so an element whose gradient is near eps (1e-8)
    turns float32 summation differences of ~1e-5 of the gradient's RMS
    into ~1e-3 of the update's."""
    p0, t, j = runs["p0"], runs["t_params"][i], runs["j_params"][i]
    for k, lab in runs["labels_j"].items():
        if lab != "train":
            continue
        ref = j[k] - p0[k]
        unit = _rms(ref) or 1.0      # fc_norm's bias: zero, never moves
        np.testing.assert_allclose((t[k] - p0[k]) / unit, ref / unit,
                                   atol=1e-2, rtol=1e-2, err_msg=k)


def test_frozen_backbone_is_untouched(runs):
    """After 3 port steps every backbone tensor is bit-identical, no
    backbone parameter requires or holds a gradient, none is in the
    optimizer, and the backbone's BNs stayed in eval mode."""
    model = runs["model"]
    for n, t in model.backbone.state_dict().items():
        assert torch.equal(t, runs["backbone0"][n]), n
    for n, p in model.backbone.named_parameters():
        assert not p.requires_grad and p.grad is None, n
    in_opt = {id(p) for g in runs["t_state"]["optimizer"].param_groups
              for p in g["params"]}
    assert not any(id(p) in in_opt for p in model.backbone.parameters())
    assert model.training and not any(m.training
                                      for m in model.backbone.modules())


def test_frozen_pyramid_carries_no_gradient(runs):
    model = runs["model"]
    x = torch.zeros(1, 224, 224, 3, requires_grad=True)
    feats = model.features(x)
    assert not any(f.requires_grad for f in feats.values())


def test_optimizer_partition_matches_jax(runs):
    """The port's optimizer holds as many elements as the JAX package's
    "train" leaves (the frozen partition as a parameter list)."""
    n_port = sum(p.numel() for g in runs["t_state"]["optimizer"].param_groups
                 for p in g["params"])
    n_jax = sum(runs["p0"][k].size for k, lab in runs["labels_j"].items()
                if lab == "train")
    assert n_port == n_jax


def test_export_jax_params_round_trips(runs):
    model = port.DuoFormer(**CFG)
    load_jax_params(model, export_jax_params(runs["model"]))
    ref = runs["model"].state_dict()
    for n, t in model.state_dict().items():
        assert torch.equal(t, ref[n]), n


@pytest.mark.parametrize("kind", ["onecycle", "cosine", "constant"])
@pytest.mark.parametrize("total", [1000, 1, 2, 3, 4])
def test_schedule_matches_jax(kind, total):
    """Every step's rate, and a few past the end, at rtol 1e-6 (atol 1e-6
    of the peak: the cosine ends at 0)."""
    peak = 1e-4
    ours = ttrain.make_schedule(kind, peak, total)
    ref = jtrain.make_schedule(kind, peak, total)
    for count in range(max(total, 4) + 3):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-6 * peak,
                                   err_msg=f"step {count}")


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_matches_jax(kind):
    """4 steps on identical gradients under OneCycle, at 1e-6."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(4)]
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = ttrain.make_optimizer(
        [w], ttrain.onecycle_schedule(PEAK_LR, TOTAL), 1e-2, kind=kind)
    tx = jtrain.make_optimizer(jtrain.onecycle_schedule(PEAK_LR, TOTAL),
                               1e-2, kind=kind)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(params["w"]), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]])
def test_cross_entropy_and_accuracy_match_jax(smoothing, weights):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    ours = ttrain.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels).long(), smoothing,
                                weights)
    ref = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               smoothing, weights)
    np.testing.assert_allclose(float(ours), float(ref), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(ttrain.accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels).long())),
        float(jtrain.accuracy(jnp.asarray(logits), jnp.asarray(labels))))


@pytest.fixture(scope="module")
def small_model():
    return port.DuoFormer(**CFG)


@pytest.mark.parametrize("option", [
    dict(accum_steps=2), dict(augment="d4"), dict(jitter=0.1),
    dict(mixup=0.2), dict(ema=0.999), dict(bn_stats=True),
    dict(mesh=object()), dict(pp_microbatches=2), dict(remat=True),
])
def test_unported_train_options_raise(small_model, option):
    with pytest.raises(NotImplementedError):
        ttrain.make_train_step(small_model, **option)


@pytest.mark.parametrize("kwargs", [
    dict(freeze_backbone=False),
    dict(freeze_backbone=False, proj_drop_rate=0.1)])
def test_unported_training_modes_raise(kwargs):
    """Batch-stat BN (an unfrozen backbone) does not train, with dropout
    or without. (Dropout, once refused here, trains through the reg
    kernels: tests/test_torch_port_reg.py holds it to the JAX package.)"""
    model = port.DuoFormer(**{**CFG, **kwargs}).train()
    with pytest.raises(NotImplementedError):
        model(torch.zeros(1, 224, 224, 3))
