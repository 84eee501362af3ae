"""Device resolution and float32 precision for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
CUDA device and no explicit request they raise: serving silently on the
CPU would hide a broken installation behind a slow one.

A float32 entry point (Predictor or the training step at dtype float32)
computes in full float32 whatever the caller's process set: on the card a
float32 convolution goes through cuDNN in TF32 by default
(torch.backends.cudnn.allow_tf32 is True) and a float32 matmul does when
torch.backends.cuda.matmul.allow_tf32 is set, and TF32 keeps ~3 decimal
digits where the JAX package's float32 keeps ~7.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda:0 (raises when there is no CUDA device); anything else
    is taken as given ("cpu", "cuda", "cuda:1", a torch.device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@contextlib.contextmanager
def float32_precision(dtype):
    """Within, for dtype float32: TF32 off for the card's float32 matmuls
    and convolutions (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 False), both flags put back as they
    were found afterwards. Any other dtype leaves them alone. Only these
    two flags are touched: torch refuses to read its float32 matmul
    precision once a process has set it through both these flags and
    set_float32_matmul_precision."""
    if dtype != torch.float32:
        yield
        return
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved
