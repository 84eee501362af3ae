"""Training of the port (counterpart of duoformer_tcga_tpu/train.py:
make_schedule, onecycle_schedule, make_optimizer, backbone_frozen_labels,
cross_entropy, accuracy, init_train_state, make_train_step).

The release recipe: a frozen ResNet-50, float32 master parameters, bf16
compute, Adam with L2 weight decay 1e-4 and the OneCycle schedule, cross
entropy (config.py:94-103, bench.py:177-227):

    model = build_model_no_extra_params(seed=0)          # on the card
    opt = make_optimizer(model, onecycle_schedule(1e-4, 1000),
                         weight_decay=1e-4,
                         frozen_label_fn=backbone_frozen_labels)
    state = init_train_state(model, opt)
    step = make_train_step(model)                         # bf16 compute
    state, metrics = step(state, {"image": tiles, "label": labels})

The legacy recipe is the same with build_model() (LayerScale, attention
dropout 0.1, dropout 0.1; its channel fusers train, their BNs on batch
statistics). The ViT baseline (build_vit_base16) has no backbone: every
parameter trains and takes the L2 decay (make_optimizer(...,
frozen_label_fn=None), as the JAX CLI leaves `frozen = None` for "vit",
cli.py:104-126), and it has no dropout. Each step is one forward, the loss, one backward through the
fused kernels' autograd functions, one optimizer step and one schedule
step. A model with dropout takes its int32 seeds from a torch.Generator
the step owns (`dropout_seed`), drawn on the CPU and handed to the kernels
as arguments, one per dropout call in the order of
models/transformer.py's docstring; `step(state, batch, seeds=...)` hands
in given ones instead.
The schedules are the optax formulas the JAX package uses (not
torch.optim.lr_scheduler.OneCycleLR, which differs by up to 2%), applied
through a LambdaLR on a base rate of 1. Options of the JAX step this slice
does not cover raise NotImplementedError.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ._device import float32_precision
from .data import pipeline as data_lib
from .models.duoformer import draw_seeds
from .ops.nn import cast_weights_


# ---------------------------------------------------------------------------
# Schedules (optax formulas, train.py:66-93)
# ---------------------------------------------------------------------------

def _piecewise_cosine(init_value, boundaries_and_scales):
    """optax.piecewise_interpolate_schedule("cosine", ...)."""
    bounds = [0] + sorted(boundaries_and_scales)
    values = [init_value]
    for b in bounds[1:]:
        values.append(values[-1] * boundaries_and_scales[b])

    def schedule(count):
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[-1] if count >= bounds[-1] else 0.0
    return schedule


def onecycle_schedule(peak_lr, total_steps, pct_start=0.3, div_factor=25.0,
                      final_div_factor=1e4):
    """optax.cosine_onecycle_schedule with total_steps clamped to >= 4
    (shorter horizons give NaN rates in optax)."""
    total = max(total_steps, 4)
    return _piecewise_cosine(peak_lr / div_factor, {
        int(pct_start * total): div_factor,
        int(total): 1.0 / (div_factor * final_div_factor)})


def _warmup_cosine(peak_lr, warmup, decay_steps):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)."""
    def schedule(count):
        if count < warmup:
            return peak_lr * min(max(count, 0), warmup) / warmup
        c = min(count - warmup, decay_steps - warmup)
        return peak_lr * 0.5 * (1 + math.cos(math.pi * c
                                             / (decay_steps - warmup)))
    return schedule


def make_schedule(kind, peak_lr, total_steps):
    """"onecycle" (the reference's), "cosine" (5% linear warmup, then
    cosine to 0) or "constant": step -> learning rate."""
    if kind == "onecycle":
        return onecycle_schedule(peak_lr, total_steps)
    if kind == "cosine":
        total = max(total_steps, 4)
        return _warmup_cosine(peak_lr, max(total // 20, 1), total)
    if kind == "constant":
        return lambda count: peak_lr
    raise ValueError(f"unknown schedule {kind!r} (onecycle | cosine | "
                     f"constant)")


# ---------------------------------------------------------------------------
# Optimizer and the frozen partition (train.py:96-158)
# ---------------------------------------------------------------------------

def backbone_frozen_labels(model: nn.Module) -> dict:
    """{parameter name: "train" | "frozen"}: the backbone is frozen (every
    preset, both families; train.py:156-158). BN running means and
    variances are buffers in the port, never parameters, so no optimizer
    sees them; the channel fusers' convs and BN scales train."""
    return {name: "frozen" if name.startswith("backbone.") else "train"
            for name, _ in model.named_parameters()}


def make_optimizer(params, schedule, weight_decay=1e-4, frozen_label_fn=None,
                   kind="adam", momentum=0.9):
    """-> (optimizer, LambdaLR scheduler), with the JAX package's
    semantics: "adam" is torch.optim.Adam(weight_decay=) (L2 decay in the
    gradient, before the moments), "adamw" decoupled decay, "sgd" momentum
    with L2 decay. params: a module or an iterable of tensors;
    frozen_label_fn(module) leaves the "frozen" ones out."""
    if isinstance(params, nn.Module):
        labels = frozen_label_fn(params) if frozen_label_fn else {}
        params = [p for n, p in params.named_parameters()
                  if labels.get(n, "train") == "train"]
    elif frozen_label_fn is not None:
        raise ValueError("frozen_label_fn needs the model, not a list of "
                         "tensors")
    params = list(params)
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=1.0, weight_decay=weight_decay)
    elif kind == "adamw":
        opt = torch.optim.AdamW(params, lr=1.0, weight_decay=weight_decay)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=1.0, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {kind!r} (adam | adamw | sgd)")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


# ---------------------------------------------------------------------------
# Loss and metric (train.py:190-236)
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, smoothing=0.0, weights=None):
    """Mean cross entropy in float32; smoothing mixes in the uniform target,
    weights [num_classes] has F.cross_entropy(weight=) semantics (the mean
    is over the summed sample weights)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if weights is None:
        if smoothing:
            nll = (1.0 - smoothing) * nll + smoothing * (-logp).mean(-1)
        return nll.mean()
    w = torch.as_tensor(weights, dtype=torch.float32, device=logits.device)
    loss = nll * w[labels]
    if smoothing:
        loss = (1.0 - smoothing) * loss + smoothing * (-logp * w).mean(-1)
    return loss.sum() / w[labels].sum().clamp_min(1e-8)


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


# ---------------------------------------------------------------------------
# The train step (train.py:239-253, 352-572)
# ---------------------------------------------------------------------------

def init_train_state(model, optimizer) -> dict:
    """optimizer: make_optimizer's (optimizer, scheduler)."""
    opt, scheduler = optimizer
    return {"model": model, "optimizer": opt, "scheduler": scheduler,
            "step": 0}


def set_backward_routes(model, mlp_save_hidden=True, attn_bwd_dw=False):
    """Set the backward routes of every block of `model` (the JAX package's
    DUOFORMER_MLP_SAVE_HIDDEN and DUOFORMER_BWD_DW; models/transformer.py):
    mlp_save_hidden=False saves no MLP hidden and recomputes it from x in
    the backward kernel; attn_bwd_dw=True forms the attention weight
    gradients in the backward kernel. Returns `model`."""
    from .models.transformer import PatchBlock, ScaleBlock
    for m in model.modules():
        if isinstance(m, ScaleBlock):
            m.mlp_save_hidden = mlp_save_hidden
        if isinstance(m, (ScaleBlock, PatchBlock)):
            m.attn_bwd_dw = attn_bwd_dw
    return model


def make_train_step(model, dtype=torch.bfloat16, label_smoothing=0.0,
                    class_weights=None, accum_steps=1, augment="none",
                    jitter=0.0, mixup=0.0, ema=0.0, bn_stats=False,
                    mesh=None, pp_microbatches=None, remat=False,
                    dropout_seed=0, mlp_save_hidden=True, attn_bwd_dw=False):
    """-> step(state, batch, seeds=None) -> (state, {"loss", "accuracy"});
    batch is {"image": [B, 224, 224, 3] uint8 tiles (normalised on the
    device) or an already normalised float batch, "label": [B] int}.
    A model with dropout draws each step's seeds from
    torch.Generator().manual_seed(dropout_seed), owned by the step, unless
    `seeds` are given. mlp_save_hidden=False and attn_bwd_dw=True are the
    memory-lean step's backward routes (set_backward_routes): no saved MLP
    hidden, and no row-space tensor of the attention backward in device
    memory.

    Prepares the model in place: training mode, and with a frozen backbone
    its weights cast once to `dtype` (the JAX step's per-step astype of
    parameters it never updates), its BNs unfolded on running statistics.
    A model with no backbone and no `transformer` core (the ViT baseline)
    casts nothing and draws no seeds.
    The trainable parameters stay the caller's (float32 masters) and are
    cast to `dtype` where they are used. At dtype float32 (on the card the
    float32 kernel forms) a step runs, forward and backward, with TF32 off
    (_device.float32_precision)."""
    unported = dict(accum_steps=accum_steps != 1, augment=augment != "none",
                    jitter=jitter != 0.0, mixup=mixup != 0.0, ema=ema != 0.0,
                    bn_stats=bool(bn_stats), mesh=mesh is not None,
                    pp_microbatches=pp_microbatches is not None,
                    remat=bool(remat))
    for name, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{name} is not ported to the PyTorch package yet")
    model.train()
    set_backward_routes(model, mlp_save_hidden, attn_bwd_dw)
    device = next(model.parameters()).device
    if getattr(model, "freeze_backbone", False):
        cast_weights_(model.backbone, dtype)
    weights = (None if class_weights is None else
               torch.as_tensor(class_weights, dtype=torch.float32,
                               device=device))
    tf = getattr(model, "transformer", None)
    dropout = tf is not None and tf.has_dropout
    gen = torch.Generator().manual_seed(dropout_seed)

    def step(state, batch, seeds=None):
        x = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
        x = (data_lib.preprocess_tiles(x, dtype=dtype)
             if x.dtype == torch.uint8 else x.to(dtype))
        labels = torch.as_tensor(batch["label"]).to(device).long()
        state["optimizer"].zero_grad(set_to_none=True)
        if seeds is None and dropout:
            seeds = draw_seeds(tf.num_seeds(), gen)
        with float32_precision(dtype):
            logits = state["model"](x, seeds=seeds)
            loss = cross_entropy(logits, labels, label_smoothing, weights)
            loss.backward()
        apply_update(state)
        return state, {"loss": loss.detach(),
                       "accuracy": accuracy(logits.detach(), labels)}
    return step


def apply_update(state) -> dict:
    """After a backward: one optimizer step, one schedule step, step += 1.
    A parameter the loss does not reach (fc_norm, quirk Q7) gets a zero
    gradient, so the weight decay still applies to it as in optax."""
    opt = state["optimizer"]
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    state["scheduler"].step()
    state["step"] += 1
    return state
