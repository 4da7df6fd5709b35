"""Decoupled rendering: the differentiable variant-B render, split at the
discrete/continuous boundary.

Counterpart of ``gpuraytracer_tpu/ops/decoupled.py``:

  1. **Trace** (``trace_records``): the trace kernel renders the image and
     writes, per (sample, bounce, pixel), one int32 record — the winning
     primitive and the shadow bit — beside the random draws it used. These
     are exactly the decisions autograd treats as constants.
  2. **Shade**: radiance is recomputed from the records as a differentiable
     function of the scene. ``shade_replay`` does it in eager PyTorch (the
     slow parity oracle of the record format, and the plain version of the
     backward kernel); ``render_path_decoupled`` does it at kernel speed:
     the trace's own image forward, the hand-written backward kernel
     (``ops/cuda_shade.py``) in the backward pass.

Gradients of both equal autograd through the eager oracle (``render.py``):
that gradient also holds visibility piecewise constant, and the replay
mirrors the oracle's shading arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..render import pixel_rng_offsets
from ..types import RenderConfig, Scene
from .cuda_path import (TraceAux, pregen_draws_plain,
                        render_path_cuda_impl)
from .cuda_shade import _auto_records_only  # noqa: F401  (callers' name)
from .cuda_shade import (_pack_diff_inputs, render_path_decoupled_fused,
                         replay_packed, sample_chunk)


def trace_records(scene: Scene, config: RenderConfig, draws=None,
                  occluders=None, records_only: bool = False,
                  device="cuda") -> Tuple[torch.Tensor, TraceAux]:
    """Run the trace kernel emitting records: (hdr [H, W, 3], TraceAux).
    Not differentiable: a scene that asks for gradients raises (pass
    ``scene.detach()``).

    ``draws``: optional ``pregen_draws(config)`` planes, hoisted out of a
    loop by the caller (else they are generated here). ``occluders``:
    optional ``intersect.potential_occluders(scene, config)`` tuple that
    culls the shadow loops (decisions unchanged). ``records_only``: the
    kernel regenerates the draws itself and the TraceAux carries none."""
    return render_path_cuda_impl(scene, config, emit_records=True,
                                 records_only=records_only, draws=draws,
                                 occluders=occluders, device=device)


def shade_replay(scene: Scene, aux: TraceAux,
                 config: RenderConfig) -> torch.Tensor:
    """Differentiable radiance [H, W, 3] from trace records, in eager
    PyTorch on the device the records lie on. Mirrors the oracle with closest
    hit and shadow probe replaced by the record's decision and the random
    numbers read from the draw planes (regenerated from the pixel offsets
    when ``aux`` comes from a ``records_only`` trace). The sample axis goes
    through in chunks of ``config.replay_sample_chunk``."""
    device = aux.records.device
    table, cam_vec, light_vec = _pack_diff_inputs(scene.to(device), config)
    draws = tuple(aux[1:])
    if draws[0] is None:
        draws = pregen_draws_plain(pixel_rng_offsets(config, device), config)
    chunk = sample_chunk(config)
    lum = sum(
        replay_packed(table, cam_vec, light_vec, aux.records[s:s + chunk],
                      [d[s:s + chunk] for d in draws], config)
        for s in range(0, config.spp, chunk))
    hdr = lum * (1.0 / config.spp)
    return hdr.T.reshape(config.height, config.width, 3)


def render_path_decoupled(scene: Scene, config: RenderConfig, draws=None,
                          occluders=None, device="cuda") -> torch.Tensor:
    """Fast differentiable variant-B render, hdr [H, W, 3]: the value is the
    trace kernel's, the gradients equal autograd through the eager oracle.
    Triangle and sphere scenes take the fused path (``cuda_shade``).
    ``draws``: optional ``pregen_draws(config)`` planes, made once outside a
    training loop. ``occluders``: optional shadow-loop cull, tied to the
    geometry it was computed from."""
    return render_path_decoupled_fused(scene, config, draws=draws,
                                       occluders=occluders, device=device)
