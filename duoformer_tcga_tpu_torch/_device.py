"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
CUDA device and no explicit request they raise: serving silently on the
CPU would hide a broken installation behind a slow one.
"""

from __future__ import annotations

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
