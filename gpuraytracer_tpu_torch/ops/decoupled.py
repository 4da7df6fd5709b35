"""Decoupled rendering, forward half: the trace kernel with records on.

Counterpart of ``gpuraytracer_tpu/ops/decoupled.py`` and of
``render_path_decoupled_fused`` (``ops/pallas_shade.py``). The renderer is
split at the discrete/continuous boundary: the trace kernel emits, per
(sample, bounce, pixel), one int32 record (winning primitive + shadow bit)
beside the image, and a backward kernel replays shading from those records.
This slice of the port has the trace; the backward kernel and the eager
``shade_replay`` follow with the training path. Until then a scene that
asks for gradients raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..types import RenderConfig, Scene
from .cuda_path import TraceAux, render_path_cuda_impl


def trace_records(scene: Scene, config: RenderConfig, draws=None,
                  occluders=None, records_only: bool = False,
                  device="cuda") -> Tuple[torch.Tensor, TraceAux]:
    """Run the trace kernel emitting records: (hdr [H, W, 3], TraceAux).

    ``draws``: optional ``pregen_draws(config)`` planes, hoisted out of a
    loop by the caller (else they are generated here). ``occluders``:
    optional ``intersect.potential_occluders(scene, config)`` tuple that
    culls the shadow loops (decisions unchanged). ``records_only``: the
    kernel regenerates the draws itself and the TraceAux carries none."""
    return render_path_cuda_impl(scene, config, emit_records=True,
                                 records_only=records_only, draws=draws,
                                 occluders=occluders, device=device)


def _auto_records_only(config: RenderConfig, n_pixels=None) -> bool:
    """records_only when the six f32 draw planes would exceed 2 GiB:
    regenerating the draws in the kernel costs a few Halton evaluations per
    (sample, bounce) instead. ``n_pixels`` is the pixel count this device
    renders (the shard-local count of a sharded run)."""
    if n_pixels is None:
        n_pixels = config.num_pixels
    nsb = n_pixels * config.spp * config.bounces
    return nsb * 4 * 4 + n_pixels * config.spp * 2 * 4 > 2 << 30


def render_path_decoupled(scene: Scene, config: RenderConfig, draws=None,
                          occluders=None, device="cuda") -> torch.Tensor:
    """Variant-B render through the record-emitting trace: the image the
    differentiable path returns, hdr [H, W, 3]. The records (and, below the
    ``_auto_records_only`` size, the draws) are produced beside it as the
    backward pass will need them. Forward only so far — a scene whose
    tensors require gradients raises ``NotImplementedError``."""
    hdr, _ = trace_records(scene, config, draws=draws, occluders=occluders,
                           records_only=_auto_records_only(config),
                           device=device)
    return hdr
