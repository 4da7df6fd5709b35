"""Persistent-state renderer — the variant-B ``Renderer`` class analog.

Counterpart of ``gpuraytracer_tpu/renderer.py``, after the reference's
RTrace/renderer.swift:29-146: its ``init()`` does the one-time work
(pipeline compile, scene build, buffer marshalling, acceleration build) and
``draw()`` dispatches one frame and saves the PNG. Here ``__init__`` moves
the scene to the device and, for the ``decoupled`` route, makes the
shadow-loop cull (``intersect.potential_occluders``) and, where the config
reads them, the random draws (``ops.pregen_draws``) once, as the command
line does; a draw is then one call of the chosen route and the PNG. This
stands in for the JAX package's cached jit. ``route`` is the one place that
chooses how a frame is rendered; the command line and
``utils.checkpoint.accumulate`` take their frames from it too.

Also ``draw_accumulate``: progressive rendering across calls through the
sample accumulator of ``utils/checkpoint.py`` (the reference's commented
"temporal accumulation" aim, RTrace/sampling.metal:127-128).

Two choices of the JAX ``Renderer`` are not kept: ``decoupled`` with the MIS
integrator renders the MIS integrator (``ops.render_mis_decoupled``), where
the JAX class renders the path tracer and tonemaps it as MIS; and the
legacy integrator takes the ``eager`` route only (any other raises), where
the JAX class renders the path tracer through its kernel.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import image as img
from . import ops
from .intersect import potential_occluders
from .render import render, tonemap_mis
from .scene import cornell_box
from .types import RenderConfig, Scene
from .utils.checkpoint import accumulate, init_accumulator, resolve
from .utils.host import fetch, resolve_device
from .utils.metrics import span

KERNELS = ("eager", "cuda", "decoupled")


class Route(NamedTuple):
    """A route's one-time work and its frame function: ``frame()`` renders
    one frame [H, W, 3] through it. ``occluders`` and ``draws`` are what the
    ``decoupled`` route made once (None elsewhere)."""

    frame: Callable[[], torch.Tensor]
    occluders: Optional[tuple] = None
    draws: Optional[torch.Tensor] = None


def route(scene: Scene, config: RenderConfig, kernel: str = "eager",
          device="cuda", occluders=None) -> Route:
    """The one place that chooses how a frame of ``config`` is rendered.

    ``kernel``: ``"eager"`` the oracle (any integrator); ``"cuda"`` the trace
    kernels in hdr mode; ``"decoupled"`` the record-emitting trace with the
    shadow-loop cull (path / direct: draws kernel + trace kernel; MIS: the
    MIS kernel with records). The legacy integrator has no kernel: any route
    but ``eager`` raises ``ValueError`` for it. ``direct`` is the path tracer
    at one bounce: the oracle maps it so itself, the kernel entries take
    ``bounces`` as given, so it is clamped here. The ``decoupled`` route
    makes the cull (unless ``occluders`` is given) and, where the config
    reads them, the draws here, once: they do not change from frame to
    frame."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel: {kernel!r}")
    if config.integrator == "legacy" and kernel != "eager":
        raise ValueError("--integrator legacy supports --kernel eager only")
    if kernel == "eager":
        return Route(lambda: render(scene, config, device=device).hdr)
    mis = config.integrator == "mis"
    cfg = (config.replace(bounces=1) if config.integrator == "direct"
           else config)
    if kernel == "cuda":
        if mis:
            return Route(lambda: ops.render_mis_cuda(scene, cfg,
                                                     device=device))
        return Route(lambda: ops.render_path_cuda(scene, cfg, device=device))
    if occluders is None:
        occluders = potential_occluders(scene, cfg)
    if mis:
        return Route(lambda: ops.render_mis_decoupled(
            scene, cfg, occluders=occluders, device=device), occluders)
    draws = (None if ops.cuda_shade._auto_records_only(cfg)
             else ops.pregen_draws(cfg, device=device))
    return Route(lambda: ops.render_path_decoupled(
        scene, cfg, draws=draws, occluders=occluders, device=device),
        occluders, draws)


def write_frame(path: str, hdr: torch.Tensor, config: RenderConfig,
                scene: Scene, exposure: float = 2.0) -> np.ndarray:
    """Tonemap and save a frame as its integrator does: MIS frames with the
    camera's exposure (``render.tonemap_mis``), the rest with the variant-B
    CPU post (``image.tonemap``). Returns the frame on the host."""
    hdr_np = fetch(hdr)
    if config.integrator == "mis":
        ldr = tonemap_mis(hdr, config.camera_rays, scene.camera.ev100)
        img.write_png(path, img.to_uint8(fetch(ldr)))
    else:
        img.write_png(path, img.tonemap(hdr_np, exposure=exposure))
    return hdr_np


class Renderer:
    """A scene, a config and a chosen route (``route``'s ``kernel``), with
    the one-time work done (renderer.swift:29-113)."""

    def __init__(self, scene: Optional[Scene] = None,
                 config: Optional[RenderConfig] = None,
                 kernel: str = "eager", device="cuda") -> None:
        self.device = resolve_device(device)
        self.config = config or RenderConfig(
            width=800, height=600, integrator="path", spp=400, bounces=3)
        scene = scene if scene is not None else cornell_box(
            resolution=(self.config.width, self.config.height))
        self.scene = scene.to(self.device)
        self.kernel = kernel
        self._route = route(self.scene, self.config, kernel, self.device)
        self.occluders, self.draws = self._route.occluders, self._route.draws
        self.last_hdr = None

    def render_hdr(self) -> torch.Tensor:
        """One frame of linear radiance [H, W, 3], waited for (the
        reference's waitUntilCompleted, renderer.swift:144): the wait is
        the span ``sync``."""
        hdr = self._route.frame()
        if self.device.type == "cuda":
            with span("sync"):
                torch.cuda.synchronize(self.device)
        self.last_hdr = hdr
        return hdr

    def draw(self, path: str = "output.png", exposure: float = 2.0,
             verbose: bool = True) -> float:
        """Render, tonemap and save the PNG (Renderer.draw,
        renderer.swift:117-146). Returns the render's wall-clock seconds."""
        start = time.perf_counter()
        hdr = self.render_hdr()
        elapsed = time.perf_counter() - start
        write_frame(path, hdr, self.config, self.scene, exposure)
        if verbose:
            print(f"Render completed in {elapsed:.2f} seconds")
            print(f"Image saved to {path}")
        return elapsed

    def draw_accumulate(self, acc=None, spp_step: Optional[int] = None):
        """Progressive rendering: one more batch of ``spp_step`` samples
        (default ``config.spp``) folded into the running accumulator through
        this renderer's route and its cull. Returns (acc, resolved hdr)."""
        if acc is None:
            acc = init_accumulator(self.config, self.device)
        acc = accumulate(self.scene, self.config, acc,
                         spp_step or self.config.spp, kernel=self.kernel,
                         device=self.device, occluders=self.occluders)
        return acc, resolve(acc)
