"""Numerical-debug toggles.

Counterpart of ``gpuraytracer_tpu/utils/debug.py``. The reference has no
sanitizers (its kernels are embarrassingly parallel with disjoint writes).
What is worth a toggle here is NaN debugging: stop at the first operation
that makes a NaN (or an Inf), the analog of a device-side assert.

  * ``debug_checks(nans=True, infs=False)``, a context manager: a
    ``TorchDispatchMode`` checks the floating-point outputs of every ATen
    operation and raises ``FloatingPointError`` naming the operation, and
    ``torch.autograd.set_detect_anomaly(True)`` does the same for the
    backward pass and points at the forward operation that made the bad
    gradient. Both are restored on exit.
  * ``enable(nans, infs)`` turns both on for the whole process (the CLI's
    ``--debug-nans``); ``disable()`` turns them off.

Every check reads the output back to the host, so the run waits on the
device at every operation: use small shapes. What the mode cannot see: the
inside of a hand-written kernel launched through ``ctypes`` (``ops/csrc``),
whose outputs it checks only when a later PyTorch operation reads them;
views (they make no new values) and the uninitialized memory of ``empty``.
The JAX module's ``disable_jit`` has no counterpart: the port runs eagerly.

    with debug_checks(nans=True):
        hdr = render(scene, config, device="cpu").hdr
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Operations whose output holds no computed value: fresh uninitialized
# memory and in-place resizes.
_UNCHECKED = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
    "aten::set_",
})


class NonFiniteCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first ATen operation whose
    floating-point output holds a NaN (``nans``) or an infinity
    (``infs``)."""

    def __init__(self, nans: bool = True, infs: bool = False) -> None:
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.name in _UNCHECKED or func.is_view:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextlib.contextmanager
def debug_checks(nans: bool = True, infs: bool = False):
    """Stop at the first operation that makes a NaN (``nans``) or an Inf
    (``infs``), forward and backward, inside the block."""
    was_anomaly = torch.is_anomaly_enabled()
    was_check_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        if nans or infs:
            with NonFiniteCheck(nans, infs):
                yield
        else:
            yield
    finally:
        torch.autograd.set_detect_anomaly(was_anomaly, was_check_nan)


_GLOBAL = []


def enable(nans: bool = True, infs: bool = False) -> None:
    """Process-wide variant (the CLI's ``--debug-nans``)."""
    disable()
    ctx = debug_checks(nans, infs)
    ctx.__enter__()
    _GLOBAL.append(ctx)


def disable() -> None:
    """Undo ``enable``."""
    while _GLOBAL:
        _GLOBAL.pop().__exit__(None, None, None)
