"""Device selection and device -> host readback.

Every entry point of the port takes a ``device`` argument whose default is
``"cuda"``. ``resolve_device`` is the one place that turns it into a
``torch.device``: asking for the card where there is none raises — an entry
point never carries on on the CPU unless the caller asked for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return device


def fetch(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host (waits for the device)."""
    return x.detach().cpu().numpy()
