"""Device selection, host -> device copies and device -> host readback.

Every entry point of the port takes a ``device`` argument whose default is
``"cuda"``. ``resolve_device`` is the one place that turns it into a
``torch.device``: asking for the card where there is none raises — an entry
point never carries on on the CPU unless the caller asked for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .metrics import span


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return device


def upload(x, device) -> torch.Tensor:
    """``x`` (a tensor, an array or a list) on ``device``. A copy from the
    host to a card is the span ``upload``: from pageable memory it waits
    for the stream."""
    x = torch.as_tensor(x)
    if x.device.type == "cpu" and torch.device(device).type != "cpu":
        with span("upload"):
            return x.to(device)
    return x.to(device)


def fetch(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host (waits for the device): the span
    ``fetch``."""
    with span("fetch"):
        return x.detach().cpu().numpy()
