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
from .ops.nn import cast_weights_


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
