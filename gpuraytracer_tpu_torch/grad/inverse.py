"""Differentiable and inverse rendering: recover scene parameters from a
target image by gradient descent on a pixel loss.

Counterpart of ``gpuraytracer_tpu/grad/inverse.py``. Every scene tensor is
differentiable through the renderers: hit distances and normals are smooth
functions of the winning primitive's parameters (interior gradients),
material and emission gradients flow through the attribute fetch and the
shading math, and visibility masks are step functions treated as piecewise
constant. That is the right estimator for albedo and emission and a biased
but useful one for geometry; sphere geometry needs the edge-aware loss
``soft_pixel_loss``, whose gradients include the sphere-silhouette term.

``pixel_loss`` goes through the eager oracle (``render.py``);
``fast_pixel_loss`` through the kernel pair (``ops.render_path_decoupled``:
trace kernel forward, hand-written backward kernel), with the same gradients.
``soft_pixel_loss`` goes through the edge-aware oracle
(``grad/diff_render.py``) or, with ``fast=True``, through the silhouette
kernels (``ops.render_direct_soft_fused``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..intersect import potential_occluders
from ..ops.cuda_path import pregen_draws
from ..ops.cuda_soft import render_direct_soft_fused
from ..ops.decoupled import _auto_records_only, render_path_decoupled
from ..render import render
from ..types import RenderConfig, Scene
from ..utils.host import resolve_device
from .diff_render import render_direct_soft


class SceneParams(NamedTuple):
    """The optimizable subset of a scene."""

    sphere_centers: torch.Tensor   # [S, 3]
    sphere_diffuse: torch.Tensor   # [S, 3]
    light_emission: torch.Tensor   # [3] (the light's color)


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(
        sphere_centers=scene.spheres.center,
        sphere_diffuse=scene.spheres.diffuse,
        light_emission=scene.light.color,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """A copy of ``scene`` with the optimizable parameters put in (diffuse
    clamped to [0, 1]), on the device the parameters lie on."""
    scene = scene.to(params.sphere_centers.device)
    spheres = dataclasses.replace(
        scene.spheres,
        center=params.sphere_centers,
        diffuse=torch.clamp(params.sphere_diffuse, 0.0, 1.0),
    )
    light = dataclasses.replace(scene.light, color=params.light_emission)
    return dataclasses.replace(scene, spheres=spheres, light=light)


def render_hdr(scene: Scene, config: RenderConfig,
               device="cuda") -> torch.Tensor:
    return render(scene, config, device).hdr


def pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
               target: torch.Tensor, device="cuda") -> torch.Tensor:
    """Mean squared pixel loss of the re-rendered image against ``target``,
    through the eager oracle."""
    img = render_hdr(apply_params(scene, params), config, device)
    return torch.mean((img - target.to(img.device)) ** 2)


def fast_pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
                    target: torch.Tensor, draws=None, occluders=None,
                    device="cuda") -> torch.Tensor:
    """``pixel_loss`` through the kernel pair: trace kernel forward,
    hand-written backward kernel, identical (interior) gradients. The records
    are traced anew at every call, so the piecewise-constant visibility is
    always that of the live scene — the same estimator as ``pixel_loss``.

    ``draws`` / ``occluders``: step-invariant inputs a training loop makes
    once (``inverse_render`` does): the draw planes are a pure function of
    the config, and the occluder mask is built with enough ``sphere_slack``
    to stay sound while the centers move."""
    img = render_path_decoupled(apply_params(scene, params), config,
                                draws=draws, occluders=occluders,
                                device=device)
    return torch.mean((img - target.to(img.device)) ** 2)


def soft_pixel_loss(params: SceneParams, scene: Scene, config: RenderConfig,
                    target: torch.Tensor, kappa: float = 0.05,
                    fast: bool = False, occluders=None,
                    device="cuda") -> torch.Tensor:
    """Pixel loss through the edge-aware renderer: the value of the hard
    direct render, plus sphere-silhouette gradient terms, which sphere-center
    recovery needs. ``fast=True`` takes the silhouette kernels (trace,
    silhouette records, hand-written backward) with the same estimator;
    ``fast=False`` the eager oracle. ``occluders`` culls the shadow probes of
    the kernels (``fast=True`` only)."""
    s = apply_params(scene, params)
    if fast:
        img = render_direct_soft_fused(s, config, kappa, occluders=occluders,
                                       device=device)
    else:
        img = render_direct_soft(s, config, kappa, device=device)
    return torch.mean((img - target.to(img.device)) ** 2)


class InverseResult(NamedTuple):
    params: SceneParams
    losses: torch.Tensor  # [steps]


def inverse_render(
    scene: Scene,
    target: torch.Tensor,
    init_params: SceneParams,
    config: RenderConfig,
    steps: int = 100,
    learning_rate: float = 5e-2,
    optimizer: Optional[Callable] = None,
    soft: bool = False,
    kappa: float = 0.05,
    fast: bool = False,
    sphere_slack: float = 0.5,
    hoist: bool = True,
    device="cuda",
) -> InverseResult:
    """Gradient-descent recovery of scene parameters from a target image:
    ``steps`` optimizer steps from ``init_params``; returns the final
    parameters and the loss before each step.

    ``optimizer``: a callable ``params -> torch.optim.Optimizer`` over the
    list of parameter tensors; default ``torch.optim.Adam`` at
    ``learning_rate``, or with ``soft`` SGD with momentum 0.9 (it follows
    the small silhouette gradients more reliably than Adam, whose
    per-parameter normalization amplifies plateau noise).

    ``fast=True`` takes the kernel path (``fast_pixel_loss``) and hoists the
    two step-invariant inputs out of the loop: the Halton draw planes
    (``pregen_draws``) and the static occluder mask
    (``intersect.potential_occluders`` built with ``sphere_slack`` of
    headroom for center motion, so the mask stays conservative for every
    iterate the optimizer can reach; raise it when recovering larger
    shifts). ``hoist=False`` turns both off, to measure what they save.

    ``soft=True`` takes the edge-aware loss (``soft_pixel_loss``, edge width
    ``kappa``), needed where sphere geometry is among the unknowns; with
    ``fast`` it runs on the silhouette kernels. It takes no occluder mask:
    a geometry-recovery trajectory can overshoot any fixed ``sphere_slack``
    (momentum and plateau noise), and a stale mask would then corrupt the
    silhouette gradients for good; a sphere scene's shadow probes cost
    little without one."""
    device = resolve_device(device)
    scene = scene.to(device)
    target = target.to(device)
    if soft:
        loss_fn = partial(soft_pixel_loss, kappa=kappa, fast=fast)
    elif fast:
        if hoist:
            occluders = potential_occluders(scene, config,
                                            sphere_slack=sphere_slack)
            draws = (None if _auto_records_only(config)
                     else pregen_draws(config, device=device))
        else:
            draws = occluders = None
        loss_fn = partial(fast_pixel_loss, draws=draws, occluders=occluders)
    else:
        loss_fn = pixel_loss

    params = [p.detach().to(device).clone().requires_grad_(True)
              for p in init_params]
    if optimizer is not None:
        opt = optimizer(params)
    elif soft:
        opt = torch.optim.SGD(params, lr=learning_rate, momentum=0.9)
    else:
        opt = torch.optim.Adam(params, lr=learning_rate)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(SceneParams(*params), scene, config, target,
                       device=device)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return InverseResult(
        params=SceneParams(*(p.detach() for p in params)),
        losses=(torch.stack(losses) if losses
                else torch.zeros(0, device=device)))


def finite_difference_grad(f: Callable[[torch.Tensor], torch.Tensor],
                           x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Central finite differences of a scalar function, element by element:
    the gradient oracle of the tests."""
    flat = x.detach().reshape(-1)
    grads = []
    with torch.no_grad():
        for i in range(flat.shape[0]):
            e = torch.zeros_like(flat)
            e[i] = eps
            e = e.reshape(x.shape)
            grads.append((f(x.detach() + e) - f(x.detach() - e)) / (2 * eps))
    return torch.stack(grads).reshape(x.shape)
