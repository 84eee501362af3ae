"""Serving front end (counterpart of duoformer_tcga_tpu/inference.py:
Predictor, inference.py:21-161).

The Predictor owns everything the serving path needs: it folds the
backbone BNs and casts the weights to the serving dtype once, at
construction, then answers batches of raw uint8 NHWC tiles.
"""

from __future__ import annotations

import torch

from ._device import resolve_device
from .data import pipeline as data_lib
from .models.duoformer import fold_for_inference
from .ops.nn import Conv2d


def _prepare_model(model, device, dtype):
    """In place: weights (every tensor of 2 or more dims) to `dtype`,
    vectors (biases, norms, folded BN) kept float32, as the JAX serving
    path reads them; conv weights channels_last on the card."""
    model.to(device)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(dtype)
        if device.type == "cuda":
            for m in model.modules():
                if isinstance(m, Conv2d):
                    m.w.data = m.w.data.contiguous(
                        memory_format=torch.channels_last)
    return model


class Predictor:
    def __init__(self, model, device=None, dtype=torch.bfloat16,
                 fold: bool = True, preprocess: bool = True):
        """model: the port's DuoFormer; the Predictor takes it over (puts
        it in eval mode, folds its BNs, moves and casts it in place).
        device: None -> the card (raises without one); "cpu" on request.
        preprocess: accept raw uint8 NHWC tiles and normalise on device."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.preprocess = preprocess
        model.eval()
        if fold:
            fold_for_inference(model)
        self.model = _prepare_model(model, self.device, dtype)

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
        [B, num_classes] on the Predictor's device."""
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
        logits = self.model(self.prepare(tiles)).float()
        return torch.softmax(logits / temperature, dim=-1)

    @torch.inference_mode()
    def embed(self, tiles):
        """tiles -> (logits [B, num_classes], pre-head CLS [B, embed_dim])
        in one forward."""
        return self.model(self.prepare(tiles), with_embedding=True)
