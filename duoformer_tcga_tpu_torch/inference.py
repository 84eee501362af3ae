"""Serving front end (counterpart of duoformer_tcga_tpu/inference.py:
Predictor, inference.py:21-161, and the serving artifact, :164-248).

The Predictor owns everything the serving path needs: it folds the
backbone BNs, optionally quantizes the transformer's GEMMs to int8, and
casts the weights to the serving dtype once, at construction, then
answers batches of raw uint8 NHWC tiles.

A serving artifact is the JAX package's: one npz of the BN-folded (and
optionally int8) parameters in the JAX tree's layout, flat under
slash-joined keys, with a JSON `__meta__` entry (the model config and
format flags). Either package reads what the other writes.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

from ._device import float32_precision, resolve_device
from .data import pipeline as data_lib
from .models.duoformer import fold_for_inference
from .ops.nn import cast_weights_, standardize_weights_
from .ops.quantize import is_quantized, quantize_model_
from .utils.checkpoint import load_params_npz_flat, save_params_npz
from .utils.convert import export_jax_params, load_jax_params

# the architecture fields a serving artifact must agree with the model on
# (cli._weights_for_serving, cli.py:664-672)
ARTIFACT_MODEL_FIELDS = (
    "num_classes", "embed_dim", "proj_dim", "num_layers", "family", "depth",
    "num_heads", "num_patches", "mlp_ratio", "scale_token", "backbone",
    "patch_attn", "init_values", "apply_fc_norm")


class Predictor:
    def __init__(self, model, device=None, dtype=torch.bfloat16,
                 fold: bool = True, preprocess: bool = True,
                 quantize: bool = False):
        """model: the port's DuoFormer or DuoFormerLegacy (whose logits
        are squeezed, quirk Q13, and whose embedding is the post-norm CLS
        its head reads), or the ViT baseline (ViTBase16, no BN to fold,
        its embedding the post-norm CLS; int8 refused, as the JAX package
        quantizes the release family only), hybrids included; the
        Predictor takes it over (puts it in eval mode, folds its BNs,
        quantizes, standardises the hybrids' trunk kernels in float32,
        moves and casts it in place). device: None -> the card (raises
        without one); "cpu" on request. preprocess: accept raw uint8 NHWC
        tiles and normalise on device. quantize: int8 (a8w8) serving, every
        transformer GEMM (qkv, proj, fc1, fc2) through the int8 kernels,
        its codes taken from the float32 weights; the model then refuses
        training mode."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.preprocess = preprocess
        model.eval()
        if fold:
            fold_for_inference(model)
        if quantize:
            quantize_model_(model)
        self.quantized = is_quantized(model)
        # the JAX package standardises its float32 masters at every
        # forward and casts the result: standardise once, before the cast
        standardize_weights_(model)
        self.model = cast_weights_(model.to(self.device), dtype)

    def prepare(self, tiles):
        """tiles -> the model's input: on the Predictor's device, normalised
        (preprocess=True) or cast, in the serving dtype."""
        x = torch.as_tensor(tiles).to(self.device, non_blocking=True)
        if self.preprocess:
            return data_lib.preprocess_tiles(x, dtype=self.dtype)
        return x.to(self.dtype)

    @torch.inference_mode()
    def __call__(self, tiles):
        """tiles: [B, 224, 224, 3] uint8 (numpy or torch) -> logits
        [B, num_classes] on the Predictor's device. At dtype float32 with
        TF32 off (_device.float32_precision)."""
        with float32_precision(self.dtype):
            return self.model(self.prepare(tiles))

    @torch.inference_mode()
    def predict_proba(self, tiles, tta: bool = False,
                      temperature: float = 1.0):
        """Class probabilities [B, num_classes] in float32 (softmax of
        logits / temperature). Test-time augmentation is a later slice."""
        if tta:
            raise NotImplementedError(
                "test-time augmentation is not ported to the PyTorch "
                "package yet")
        with float32_precision(self.dtype):
            logits = self.model(self.prepare(tiles)).float()
        return torch.softmax(logits / temperature, dim=-1)

    @torch.inference_mode()
    def embed(self, tiles):
        """tiles -> (logits [B, num_classes], pre-head CLS [B, embed_dim])
        in one forward (float32: with TF32 off, as __call__)."""
        with float32_precision(self.dtype):
            return self.model(self.prepare(tiles), with_embedding=True)


def _list_paths(tree):
    """The slash-joined paths of the tree's list levels: the flat npz
    writes list indices and dict keys alike, so loading needs them."""
    paths = []

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            paths.append(prefix[:-1])
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")

    walk(tree)
    return sorted(paths)


def export_serving_artifact(path: str, model, meta: dict,
                            quantize: bool = False) -> dict:
    """Write a serving artifact of `model` (left unchanged): its
    parameters BN-folded, and int8-quantized when `quantize` (from the
    float32 weights) or when the model already is, as a flat npz in the
    JAX tree's layout plus a JSON `__meta__` entry. meta["model"] defaults
    to the model's architecture fields. Returns the meta written."""
    m = fold_for_inference(copy.deepcopy(model).cpu())
    if quantize:
        quantize_model_(m)
    tree = export_jax_params(m)
    meta = dict(meta, folded=True, quantized=is_quantized(m),
                lists=_list_paths(tree), format_version=1)
    meta.setdefault("model", dict(model.config))
    save_params_npz(path, {**tree, "__meta__": np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)})
    return meta


def load_serving_artifact(path: str):
    """-> (params, meta) from an artifact written by either package's
    export_serving_artifact: the JAX-layout tree with numpy leaves."""
    with np.load(path) as raw:
        meta = (json.loads(bytes(raw["__meta__"].tobytes()).decode())
                if "__meta__" in raw.files else {})
    params = load_params_npz_flat(path)
    params.pop("__meta__", None)
    # restore the levels that were lists at export (deepest first, so
    # nested lists convert bottom-up)
    for path_ in sorted(meta.get("lists", []), key=len, reverse=True):
        parts = path_.split("/")
        node = params
        for p in parts[:-1]:
            node = node[p]
        d = node[parts[-1]]
        node[parts[-1]] = [d[str(i)] for i in range(len(d))]
    return params, meta


def from_serving_artifact(model, path: str, device=None,
                          dtype=torch.bfloat16) -> Predictor:
    """A Predictor serving an exported artifact with `model`'s
    architecture: every field of the artifact's meta["model"] among
    ARTIFACT_MODEL_FIELDS must equal the model's (else ValueError); the
    weights load as they are (already folded, int8 when the artifact is
    quantized, which quantizes the model's structure)."""
    params, meta = load_serving_artifact(path)
    recorded = meta.get("model", {})
    for k in ARTIFACT_MODEL_FIELDS:
        if k in recorded and model.config.get(k) != recorded[k]:
            raise ValueError(
                f"artifact was exported with model.{k}={recorded[k]} but "
                f"the model has {model.config.get(k)}")
    load_jax_params(model, params)
    if is_quantized(model) != bool(meta.get("quantized", False)):
        raise ValueError(f"artifact meta says quantized="
                         f"{meta.get('quantized')} but its weights do not")
    return Predictor(model, device=device, dtype=dtype, fold=False)
