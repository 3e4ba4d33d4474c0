"""The device an entry point runs on: cuda unless the caller asks for the
CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """A CUDA request without a card raises; it never falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available")
    return device
